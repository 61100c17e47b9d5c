"""Share of the window in which the card idled while a read rebuilt side b
of a joint GOP through the warp (vss.joint.rebuild_warp: the upload, the
warp kernel, the float32 download and the host's round, clip and cast),
%, by the program's spans on the device trace; nothing where the program
has no such span (no vss_joint_rebuild_frames_total, which came with
it)."""
from vssbench import span_idle

REBUILD_WARP = ("vss.joint.rebuild_warp",)


def read(run):
    if "vss_joint_rebuild_frames_total" not in run.counters:
        return None
    return span_idle.idle_pct(run, REBUILD_WARP)
