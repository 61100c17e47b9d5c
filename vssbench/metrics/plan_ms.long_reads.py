"""Mean planning time of a read in the window, ms: the store's
vss_read_plan_seconds histogram, its sum over its count."""
from vssbench import readers


def read(run):
    return readers.counter_ratio(run, "vss_read_plan_seconds_sum",
                                 "vss_read_plan_seconds_count", 1e3)
