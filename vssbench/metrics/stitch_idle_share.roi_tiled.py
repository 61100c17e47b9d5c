"""Share of the window in which the card idled while the host stitched a
region read's decoded tiles together (vss.store.stitch), %, by the
program's spans on the device trace; nothing where the program has no
such span."""
from vssbench import span_idle

STITCH = ("vss.store.stitch",)


def read(run):
    if not run.values.get("stitch_spans"):
        return None
    return span_idle.idle_pct(run, STITCH)
