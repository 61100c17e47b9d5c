"""Share of the window in which the card idled while Algorithm 1 verified a
pair frame by frame (warps, PSNR, slicing), %, by the program's spans on
the device trace."""
from vssbench import joint_probes


def read(run):
    return joint_probes.idle_pct(run, joint_probes.VERIFY)
