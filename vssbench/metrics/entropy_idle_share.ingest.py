"""Share of the window in which the card idled while the host ran an
entropy coder (the codec's or deferred compression's deflate or inflate),
%, by the program's spans on the device trace."""
from vssbench import span_idle


def read(run):
    return span_idle.idle_pct(run, span_idle.ENTROPY)
