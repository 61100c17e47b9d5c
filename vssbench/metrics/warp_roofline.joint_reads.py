"""ops.warp's least bytes (its calls' tensors) at 3.35 TB/s over the device
time of the work it launched (correlated in the device trace), %: the
warp of side b's rebuild on the read path."""
from vssbench import joint_probes


def read(run):
    return joint_probes.roofline_pct(run, "warp")
