"""ops.delta_decode's least bytes at 3.35 TB/s over the device time of the work
it launched (correlated in the device trace), %."""
from vssbench import readers


def read(run):
    return readers.roofline_pct(run, "delta_decode")
