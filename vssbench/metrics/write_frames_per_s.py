"""Frames appended and durable (every writer closed) over the window (host
clock)."""
from vssbench import readers


def read(run):
    return readers.frames_per_s(run, "append")
