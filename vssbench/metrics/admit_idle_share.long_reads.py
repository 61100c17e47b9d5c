"""Share of the window in which the card idled while the cache admitted a
view (step error, puts, catalog rows), evicted or compacted, %, by the
program's spans on the device trace."""
from vssbench import span_idle


def read(run):
    return span_idle.idle_pct(run, span_idle.ADMIT)
