"""Tile objects the window's region reads fetched
(vss_tile_fetches_total) over every tile object of the GOPs they
covered, %: 100 when tiles save no fetch."""


def read(run):
    fetched = run.counters.get("vss_tile_fetches_total")
    covered = run.values.get("roi_gops_covered")
    if fetched is None or not covered:
        return None
    rows, cols = run.config["tiles"]
    return 100.0 * fetched / (rows * cols * covered)
