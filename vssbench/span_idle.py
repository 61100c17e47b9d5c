"""Idle seconds of the card that the program's own spans hold.

``devtrace`` names each idle gap of a traced window by the innermost
``vss.*`` host range open at the gap's midpoint.  The program mirrors
its spans (``repro_torch.obs.trace``) as ranges named
``vss.<layer>.<stage>``, so a gap the host spent deflating a GOP is
named ``vss.codec.deflate.<coder>``.  A metric here owns a few such
names (``fnmatch`` patterns) and reads the share of the window in which
the card idled under them, in %.

The benchmark's own ranges (``vss.read``, ``vss.append``, ``vss.close``,
the probes' ``vss.encode_gop``, ``vss.decode_gop`` and
``vss.kernel.<entry>``) match no pattern here.  A program without the
spans (no ``repro_torch.obs.span``: an older port traced with these
benchmark files) gives no reading at all, not a 0.0: its gaps carry
only the benchmark's names, so a share there would claim an absence it
cannot see.
"""
from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Optional, Tuple

ENTROPY = ("vss.codec.deflate.*", "vss.codec.inflate.*",
           "vss.deferred.deflate.*", "vss.deferred.inflate.*")
BOX_MEAN = ("vss.store.resample_box",)
ADMIT = ("vss.store.admit_*", "vss.store.evict", "vss.store.compact")
FETCH = ("vss.store.fetch",)
BACKPRESSURE = ("vss.ingest.backpressure",)


def owned(name: str, patterns: Tuple[str, ...]) -> bool:
    return any(fnmatchcase(name, p) for p in patterns)


def program_has_spans() -> bool:
    from repro_torch import obs

    return hasattr(obs, "span")


def idle_pct(run, patterns: Tuple[str, ...]) -> Optional[float]:
    """Seconds of the window's idle gaps named by ``patterns``, over the
    window, in %: 0.0 when none of them held a gap."""
    t = run.devtrace
    if t is None or run.device == "cpu" or t.window_s <= 0:
        return None
    if not program_has_spans():
        return None
    secs = sum(s for name, s in t.idle_gaps if owned(name, patterns))
    return 100.0 * secs / t.window_s
