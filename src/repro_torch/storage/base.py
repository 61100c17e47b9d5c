"""The `StorageBackend` contract — every GOP payload byte goes through it.

VSS's premise (§2) is that the storage manager "transparently and
automatically arranges the data on disk"; the contract here is the seam
that makes the physical layout an independently evolvable layer.  The
store, cache, deferred compressor, compactor and joint-compression
driver never touch the filesystem directly — they speak in
*backend-relative keys* (the catalog's ``gop.path`` column), and a
backend maps keys to bytes however it likes: a dict, one directory,
N sharded volumes, or a memory tier over any of those.

Contract notes
  * ``put`` is atomic and durable-on-return (to the backend's level of
    durability): a reader never observes a half-written object, and a
    key either maps to the complete new value or the complete old one.
  * ``delete`` is idempotent — deleting a missing key is a no-op (the
    eviction and joint-compression paths race deletes benignly).
  * ``batch_get`` preserves key order and is the backend's chance to
    overlap I/O (the §3 read plans touch many fragments per read).
  * ``batch_put`` publishes many objects with per-object atomicity (no
    cross-object transaction — callers index rows only after it
    returns, so a crash mid-batch leaves orphans for the scavenger,
    never dangling catalog rows).
  * ``kind_for`` names the I/O performance class serving a key
    ("memory", "localfs", "sharded", ...) so the §3 cost model can
    price fragment fetches per tier (`CostModel.io_cost`).
  * ``list`` yields keys under a prefix; order is unspecified.
  * ``recover`` reconciles backend state against the SQLite catalog at
    startup (crash recovery); see `repro_torch.storage.recovery`.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class ObjectNotFound(KeyError):
    """Raised by ``get``/``stat``/``batch_get`` for an unknown key."""


class RangeNotSatisfiable(ValueError):
    """``get_range`` start at/past the object's end — the storage-level
    twin of HTTP 416 (`Content-Range: bytes */<size>`).  Subclasses
    ValueError so pre-existing ``except ValueError`` callers keep
    working; new callers that need to distinguish a wrong byte index
    (a planner bug, a stale offset table) from malformed arguments
    catch this type."""

    def __init__(self, key: str, start: int, size: Optional[int] = None):
        detail = f" ({size} bytes)" if size is not None else ""
        super().__init__(f"range start {start} outside {key!r}{detail}")
        self.key = key
        self.start = start
        self.size = size


def validate_key(key: str) -> str:
    """Reject keys that could escape a backend's namespace (absolute
    paths, ``..`` traversal).  The ONE copy of this security filter —
    filesystem-backed backends and the remote client both route
    through it, so a future tightening cannot drift between them."""
    if key.startswith(("/", "\\")) or ".." in key.split("/"):
        raise ValueError(f"bad storage key {key!r}")
    return key


@dataclasses.dataclass(frozen=True)
class ObjectStat:
    key: str
    nbytes: int


class StorageBackend(abc.ABC):
    """Abstract GOP object store: opaque bytes addressed by string keys."""

    #: I/O performance class for `kind_for` / `CostModel.io_cost`
    KIND = "default"

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        """Atomically store ``data`` under ``key`` (overwrite allowed)."""

    @abc.abstractmethod
    def get(self, key: str) -> bytes:
        """Return the full object; raises ObjectNotFound."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Remove ``key``; missing keys are ignored (idempotent)."""

    @abc.abstractmethod
    def stat(self, key: str) -> ObjectStat:
        """Size metadata without reading payload; raises ObjectNotFound."""

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]:
        """All keys starting with ``prefix`` (order unspecified)."""

    # -- conveniences with sane defaults -----------------------------------
    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        """Fetch many objects, preserving order. Backends that can
        overlap I/O (sharded volumes, remote stores) override this."""
        return [self.get(k) for k in keys]

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Store many objects; each put keeps its atomicity, the batch
        as a whole has none.  Backends that can overlap I/O (sharded
        volumes, remote stores) override this to fan writes out the way
        ``batch_get`` fans reads out."""
        for key, data in items:
            self.put(key, data)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Bytes ``[start, start+length)`` of the object — the ranged
        read behind sub-GOP fetches.  Contract (every backend must
        agree, whatever its transport):

          * ``start < 0`` or ``length < 1`` raises ValueError;
          * ``start`` at or past the object's end raises
            `RangeNotSatisfiable` (a ValueError subclass — the HTTP-416
            twin; the caller's byte index is wrong, never silently
            empty);
          * a range running past the end returns the tail (fewer than
            ``length`` bytes), mirroring HTTP 206 semantics;
          * unknown keys raise ObjectNotFound.

        Default: full get + slice — correct everywhere, and already a
        win for backends whose ``get`` is memory-speed.  Backends with
        a cheaper partial read (seek on a file, ``Range:`` over HTTP,
        hot-tier slices) override it."""
        if start < 0 or length < 1:
            raise ValueError(f"bad range start={start} length={length}")
        data = self.get(key)
        if start >= len(data):
            raise RangeNotSatisfiable(key, start, len(data))
        return data[start : start + length]

    def batch_get_ranges(
        self, reqs: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        """Fetch many ``(key, start, length)`` ranges, preserving
        order.  Backends that can overlap I/O override this the way
        they override ``batch_get``."""
        return [self.get_range(k, s, n) for k, s, n in reqs]

    def kind_for(self, key: str) -> str:
        """The I/O performance class that would serve ``key`` right now
        ("memory", "localfs", ...).  Tiered backends answer per key —
        a hot-tier hit is priced as memory, a cold miss as the cold
        backend — which is how `CostModel.io_cost` makes §3 plans
        prefer fragments on faster tiers."""
        return self.KIND

    def exists(self, key: str) -> bool:
        try:
            self.stat(key)
            return True
        except ObjectNotFound:
            return False

    def sweep_temps(self) -> int:
        """Remove in-flight temp artifacts left by a crash; returns the
        number removed.  No-op for backends without a temp protocol."""
        return 0

    def configure_concurrency(self, n: int) -> None:
        """Hint: at least ``n`` threads will drive this backend at
        once (`VSS` passes ``ingest_workers``).  Backends holding
        scarce per-connection resources (`RemoteBackend`'s socket
        pool) GROW themselves to cover it — never shrink, so the hint
        cannot clobber a larger explicitly-configured pool or the
        read-side fan-out default; wrappers forward it to their
        children."""

    def ensure_durable(self, keys: Optional[Sequence[str]] = None) -> None:
        """Barrier: every previously acknowledged write — scoped to
        ``keys`` when given — is durable on return.  A no-op for
        write-through backends (their ``put`` IS the barrier); a
        write-back `TieredBackend` lands the scoped dirty objects.
        The ingest path calls this with each window's keys between the
        window's ``batch_put`` and its catalog commit, so
        publish-then-index stays exact even over a deferring cache —
        indexed rows never reference bytes that exist only in a
        volatile tier."""

    def calibration_targets(self) -> Dict[str, "StorageBackend"]:
        """The ``{kind: backend}`` pairs ``calibrate_io`` should time
        to price THIS backend's fetches.  Wrappers answer with the
        tier that serves a cache miss (`TieredBackend` -> its cold
        child), so a ``tiered:remote`` store calibrates the remote
        profile instead of filing measurements under a wrapper kind."""
        return {self.KIND: self}

    def layout_fingerprint(self) -> str:
        """Identifies the *key→object placement scheme*, not the
        instance: two backends with equal fingerprints resolve the same
        keys to the same objects under the same store root.  The store
        stamps this into the catalog at creation and refuses to open
        (rather than scavenge-wipe) under a mismatched layout."""
        return type(self).__name__.lower()

    def recover(self, catalog) -> "RecoveryReport":
        """Reconcile backend contents against the catalog (startup
        scavenger).  Default: the generic key-level scavenge.

        Recovery contract for deferring (write-back) backends: any
        write the backend **acknowledged** before the crash must be
        readable before the scavenge runs — a journaled
        `TieredBackend` replays its unflushed dirty set at
        construction and lands it on the cold tier here, so the
        scavenge never mistakes an acknowledged-but-unflushed object
        for a lost one.  Only backends with no durability mechanism
        for deferred writes may drop them (and then the scavenge drops
        the rows, keeping indexed-implies-readable)."""
        from repro_torch.storage.recovery import scavenge

        return scavenge(self, catalog)

    def scrub(self, catalog, *, collect_orphans: bool = False):
        """Deep integrity pass (`VSS.scrub`).  Replicated backends
        override this to validate every replica and re-replicate
        under-replicated objects; for single-copy backends the best
        available check IS the key-level scavenge, so that is the
        default.  ``collect_orphans`` additionally deletes objects no
        catalog row references — only safe with writes quiesced (a
        publisher mid put-then-index looks exactly like an orphan);
        startup `recover` always collects."""
        from repro_torch.storage.recovery import scavenge

        return scavenge(self, catalog, collect_orphans=collect_orphans)

    def close(self) -> None:  # pragma: no cover - trivial
        pass


def unwrap(backend, cls=None):
    """Walk a delegating-wrapper chain (``InstrumentedBackend``,
    ``FaultInjectingBackend`` — anything exposing ``inner``), also
    descending through a tiered backend's ``cold`` child.

    With ``cls``, return the first backend in the chain that is an
    instance of ``cls`` (or ``None``); without, return the innermost
    backend on the wrapper (not ``cold``) chain.  Type dispatch on a
    backend (``isinstance`` checks in the store, in ``make_backend``)
    must go through this, since ``make_backend`` auto-wraps every
    level with telemetry."""
    b = backend
    while isinstance(b, StorageBackend):
        if cls is not None and isinstance(b, cls):
            return b
        nxt = getattr(b, "inner", None)
        if not isinstance(nxt, StorageBackend):
            if cls is not None:
                # composition, not delegation: a tiered store's cold
                # tier still "is" part of the stack for dispatch
                # purposes (e.g. finding the RemoteBackend behind a
                # write-back cache)
                cold = getattr(b, "cold", None)
                if isinstance(cold, StorageBackend):
                    return unwrap(cold, cls)
                return None
            return b
        b = nxt
    return None if cls is not None else backend


@dataclasses.dataclass
class RecoveryReport:
    """What the startup scavenger found and fixed."""

    temps_removed: int = 0
    orphans_removed: int = 0
    gops_dropped: int = 0        # catalog rows whose object was lost/corrupt
    gops_repaired: int = 0       # rows whose recorded size was stale but
    # whose object parsed cleanly (e.g. crash between deferred-compress
    # put and the catalog nbytes update)

    @property
    def clean(self) -> bool:
        return not (
            self.temps_removed or self.orphans_removed
            or self.gops_dropped or self.gops_repaired
        )


@dataclasses.dataclass
class ScrubReport(RecoveryReport):
    """RecoveryReport plus the replica-level counts a scrub adds."""

    replicas_repaired: int = 0   # missing/torn/divergent copies rewritten
    replicas_pruned: int = 0     # replicas on children outside the key's set
    replicas_skipped: int = 0    # replica slots unverifiable (child down)

    @property
    def clean(self) -> bool:
        return (
            RecoveryReport.clean.fget(self)  # type: ignore[union-attr]
            and not (self.replicas_repaired or self.replicas_pruned
                     or self.replicas_skipped)
        )
