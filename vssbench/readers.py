"""Shared arithmetic of the metric files in ``metrics/``.

Each metric is a file ``metrics/<name>.py`` whose ``read(run)`` returns
the number, or None when the run holds nothing to read it from; the
harness then leaves the metric out of the result line.  A device
number is never read from a run on the CPU.
"""
from __future__ import annotations

from typing import Optional

from vssbench import rooflines


def _ok(run, kind):
    return [r for r in run.requests if r.ok and r.kind == kind]


def frames_per_s(run, kind: str) -> Optional[float]:
    """Frames of the completed ``kind`` requests over the window."""
    if run.window_s <= 0:
        return None
    done = _ok(run, kind)
    if not done:
        return None
    return sum(r.frames for r in done) / run.window_s


def latency_percentile_ms(run, kind: str, q: float) -> Optional[float]:
    """The ``q``-th percentile (nearest rank) of every ``kind`` request's
    client-side latency; a failed request waited the whole window."""
    lat = sorted(r.seconds if r.ok else run.window_s
                 for r in run.requests if r.kind == kind)
    if not lat:
        return None
    rank = max(1, -(-len(lat) * q // 100))
    return 1e3 * lat[int(rank) - 1]


def counter_ratio(run, num: str, den: str, scale: float = 1.0
                  ) -> Optional[float]:
    n, d = run.counters.get(num), run.counters.get(den)
    if n is None or not d:
        return None
    return scale * n / d


def gop_ms(run, entry: str) -> Optional[float]:
    """Mean host milliseconds of one call of the GOP entry ``entry``."""
    if run.probes is None:
        return None
    secs = run.probes.gop_seconds[entry]
    if not secs:
        return None
    return 1e3 * sum(secs) / len(secs)


def roofline_pct(run, entry: str) -> Optional[float]:
    """The least time the calls of ``entry`` could take at the card's
    memory bandwidth, over the device time of the entry's kernels
    (``devtrace``), in %."""
    if run.probes is None or run.devtrace is None or run.device == "cpu":
        return None
    if not run.probes.kernel_calls[entry]:
        return None
    secs = run.devtrace.entry_s.get(entry, 0.0)
    if secs <= 0:
        return None
    bound = rooflines.bound_seconds(sum(run.probes.kernel_calls[entry]))
    return 100.0 * bound / secs


def idle_pct(run) -> Optional[float]:
    t = run.devtrace
    if t is None or run.device == "cpu" or t.window_s <= 0:
        return None
    return 100.0 * t.idle_share


def cached_share_pct(run) -> Optional[float]:
    done = _ok(run, "read")
    planned = sum(r.params["plan"]["planned_frames"] for r in done)
    if not planned:
        return None
    cached = sum(r.params["plan"]["cached_frames"] for r in done)
    return 100.0 * cached / planned


def fetch_bytes_per_frame(run) -> Optional[float]:
    frames = sum(r.frames for r in _ok(run, "read"))
    fetched = run.counters.get("vss_read_fetch_bytes_total")
    if not frames or fetched is None:
        return None
    return fetched / frames
