"""Share of the window in which the card ran nothing, % (torch.profiler)."""
from vssbench import readers


def read(run):
    return readers.idle_pct(run)
