"""Process start to the first measured request, seconds (host clock)."""


def read(run):
    return run.values.get("setup_s")
