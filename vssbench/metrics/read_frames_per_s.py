"""Frames delivered by the view reads completed in the window, over the
window (host clock)."""
from vssbench import readers


def read(run):
    return readers.frames_per_s(run, "read")
