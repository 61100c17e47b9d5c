"""Share of the frames read in the window whose plan segment came from a
view other than the stored original, %, from each ReadResult.plan."""
from vssbench import readers


def read(run):
    return readers.cached_share_pct(run)
