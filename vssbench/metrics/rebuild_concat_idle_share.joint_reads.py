"""Share of the window in which the card idled while a read joined the
slices of a joint GOP on the host (vss.joint.rebuild_concat: the
composite, side b's join, the segments'), %, by the program's spans on
the device trace; nothing where the program has no such span (no
vss_joint_rebuild_frames_total, which came with it)."""
from vssbench import span_idle

REBUILD_CONCAT = ("vss.joint.rebuild_concat",)


def read(run):
    if "vss_joint_rebuild_frames_total" not in run.counters:
        return None
    return span_idle.idle_pct(run, REBUILD_CONCAT)
