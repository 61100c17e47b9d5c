"""Bytes the backend holds for the cell's videos after the window, over
the raw RGB bytes the writers appended (the benchmark walks the store's
directory itself)."""


def read(run):
    raw = run.values.get("raw_bytes")
    if not raw:
        return None
    return run.values["stored_bytes"] / raw
