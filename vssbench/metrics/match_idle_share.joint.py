"""Share of the window in which the card idled while the host matched
features: the candidate search's correspondence counts and Algorithm 1's
homography search, %, by the program's spans on the device trace."""
from vssbench import joint_probes


def read(run):
    return joint_probes.idle_pct(run, joint_probes.MATCH)
