"""95th percentile of every read's client-side latency in the window, ms
(host clock)."""
from vssbench import readers


def read(run):
    return readers.latency_percentile_ms(run, "read", 95)
