"""Share of the window in which the card idled while a writer waited on the
full ingest queue, %, by the program's spans on the device trace."""
from vssbench import span_idle


def read(run):
    return span_idle.idle_pct(run, span_idle.BACKPRESSURE)
