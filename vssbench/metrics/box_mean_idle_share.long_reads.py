"""Share of the window in which the card idled while the host ran the
integer box mean of a smaller view (resample), %, by the program's spans
on the device trace."""
from vssbench import span_idle


def read(run):
    return span_idle.idle_pct(run, span_idle.BOX_MEAN)
