"""Deferred compression of uncompressed GOP pages — §5.2.

Raw (RGB) cache entries dwarf their compressed counterparts; once a
video's cache exceeds a threshold fraction of its budget (25% in the
prototype), each uncompressed read triggers lossless Zstandard
compression of the raw entry *least likely to be evicted* (i.e. the
highest LRU_VSS sequence number — it will stay around longest, so
shrinking it pays off most). Two further prototype behaviours are kept:

  * the zstd level scales linearly with remaining budget (level 1 when
    the budget is free, level 19 when exhausted) — trading throughput
    for ratio exactly when space is tight,
  * a background worker opportunistically compresses entries when no
    foreground requests are running.
"""
from __future__ import annotations

import threading
import zlib
from typing import List, Optional

try:  # optional: prefer zstd, fall back to stdlib zlib
    import zstandard
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None

from repro_torch.core.cache import CachePolicy
from repro_torch.core.catalog import Catalog
from repro_torch.core.types import GopMeta

ACTIVATION_FRACTION = 0.25
ZMAGIC = b"ZGOP"  # zstd-wrapped
LMAGIC = b"LGOP"  # zlib-wrapped (no zstandard wheel available)
MIN_LEVEL, MAX_LEVEL = 1, 19


def wrap_bytes(data: bytes, level: int) -> bytes:
    if zstandard is not None:
        return ZMAGIC + zstandard.ZstdCompressor(level=level).compress(data)
    return LMAGIC + zlib.compress(data, min(max(level, 1), 9))


def unwrap_bytes(data: bytes) -> bytes:
    if data[:4] == ZMAGIC:
        if zstandard is None:
            raise RuntimeError(
                "GOP was zstd-wrapped but the zstandard wheel is not"
                " installed"
            )
        return zstandard.ZstdDecompressor().decompress(data[4:])
    if data[:4] == LMAGIC:
        return zlib.decompress(data[4:])
    raise ValueError("not a deferred-compressed GOP")


def is_wrapped(data: bytes) -> bool:
    return data[:4] in (ZMAGIC, LMAGIC)


class DeferredCompressor:
    def __init__(
        self,
        catalog: Catalog,
        policy: Optional[CachePolicy] = None,
        activation_fraction: float = ACTIVATION_FRACTION,
        *,
        backend=None,  # StorageBackend; required for compress_one
    ):
        self.catalog = catalog
        self.policy = policy or CachePolicy()
        self.backend = backend
        self.activation_fraction = activation_fraction
        self._lock = threading.Lock()
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()
        self._busy = threading.Event()  # foreground activity marker

    # -- level scaling -----------------------------------------------------
    def current_level(self, logical: str) -> int:
        used = self.catalog.total_bytes(logical)
        budget = max(self.catalog.get_budget(logical), 1)
        frac = min(max(used / budget, 0.0), 1.0)
        return int(round(MIN_LEVEL + frac * (MAX_LEVEL - MIN_LEVEL)))

    def active(self, logical: str) -> bool:
        used = self.catalog.total_bytes(logical)
        budget = max(self.catalog.get_budget(logical), 1)
        return used > self.activation_fraction * budget

    # -- the §5.2 step -----------------------------------------------------
    def _raw_gops(self, logical: str) -> List[GopMeta]:
        out = []
        for p in self.catalog.physicals_for(logical):
            if p.codec != "rgb" or p.tiles != (1, 1):
                # tiled GOPs are many objects under one catalog path;
                # the single-object zstd wrap does not apply to them
                continue
            out.extend(
                g for g in self.catalog.gops_for(p.physical_id)
                if not g.zwrapped
            )
        return out

    def compress_one(self, logical: str) -> Optional[int]:
        """Compress the raw entry least likely to be evicted. Returns the
        GOP id, or None when nothing raw remains."""
        with self._lock:
            raw = self._raw_gops(logical)
            if not raw:
                return None
            seqs = self.policy.sequence_numbers(self.catalog, logical)
            target = max(raw, key=lambda g: seqs.get(g.gop_id, 0.0))
            level = self.current_level(logical)
            data = self.backend.get(target.path)
            if is_wrapped(data):
                return None
            wrapped = wrap_bytes(data, level)
            if len(wrapped) >= len(data):
                return None  # incompressible; leave it
            # backend puts are atomic (publish-then-index protocol): a
            # crash here at worst leaves a wrapped object with a stale
            # catalog size, which the startup scavenger repairs
            self.backend.put(target.path, wrapped)
            self.catalog.update_gop(
                target.gop_id, nbytes=len(wrapped), zwrapped=True
            )
            return target.gop_id

    def on_uncompressed_read(self, logical: str) -> Optional[int]:
        """Hook called by the store on every raw-format read."""
        if not self.active(logical):
            return None
        return self.compress_one(logical)

    # -- background worker (§5.2 "compresses cache entries in a
    # background thread when no other requests are being executed") -------
    def mark_busy(self):
        self._busy.set()

    def mark_idle(self):
        self._busy.clear()

    def start_background(self, logical: str, interval_s: float = 0.05):
        def loop():
            while not self._bg_stop.wait(interval_s):
                if self._busy.is_set():
                    continue
                if self.active(logical):
                    self.compress_one(logical)

        self._bg_stop.clear()
        self._bg_thread = threading.Thread(target=loop, daemon=True)
        self._bg_thread.start()

    def stop_background(self):
        if self._bg_thread is not None:
            self._bg_stop.set()
            self._bg_thread.join(timeout=5)
            self._bg_thread = None
