"""GOPs the joint pass stored jointly (vss_joint_gops_total) over the GOPs
the window wrote, %."""
from vssbench import joint_probes


def read(run):
    return joint_probes.gop_share_pct(run)
