"""Bytes the read path fetched from the backend
(vss_read_fetch_bytes_total) per frame delivered."""
from vssbench import readers


def read(run):
    return readers.fetch_bytes_per_frame(run)
