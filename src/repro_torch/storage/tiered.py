"""Hot/cold tiering: a bounded memory tier over any cold backend.

Two write disciplines share the read path:

**Write-through** (default): every ``put`` lands in the cold backend
first (that is the durable copy; atomicity/recovery are the cold
tier's), then in the hot dict.  Reads hit the hot tier when they can
and promote on miss.

**Write-back** (``write_back=True`` — what ``tiered:remote`` builds):
``put`` lands in the hot tier and returns; a background flusher
uploads dirty objects to the cold tier.  This is the §3 "fast vs.
cheap" composition for a high-latency cold store (a remote object
server): ingest runs at memory speed while uploads trail behind.
Dirty-write tracking keeps the cache honest — a dirty object is
**never dropped before its cold copy exists** (spill flushes it
synchronously first, and an object whose flush keeps failing is pinned
hot rather than lost), ``flush()`` is the durability barrier
(``close()`` implies it, re-raising the first terminal flush failure),
and ``list``/``stat``/``get`` see dirty objects immediately.  The
durability contract callers get from ``put`` therefore moves to
``flush``/``close``/``ensure_durable`` — the ingest path calls
``ensure_durable`` between each publish window's ``batch_put`` and its
catalog commit, so source-of-truth video is never indexed while its
bytes sit only in the volatile tier.  With a **write-back journal**
(``journal_dir=...`` — what ``tiered:remote`` builds by default) the
volatile tier stops being a durability hole at all: every dirty
admission is appended to a local append-only journal and fsync'd
before ``put`` returns, startup replay rebuilds the dirty set from
whatever a crash left (cross-checking the cold tier so an
already-flushed record is never re-uploaded), and ``recover()`` lands
the replayed set on the cold tier before the scavenge runs — no
acknowledged write is ever dropped.  See `repro_torch.storage.journal`.

Spill (demotion from hot) never deletes durable data — the cold copy
is authoritative — and its *ordering* is not decided here: the store
wires ``set_priority_fn`` to the catalog's LRU_VSS sequence numbers,
so the same §4 policy that drives cache eviction (`repro_torch.core.cache`)
also decides which hot pages are least worth keeping in memory.
Without a priority function the tier degrades to plain insertion-order
LRU.

``kind_for`` answers per key — a hot hit is priced as memory, a miss
as the cold backend's kind ("remote" for a ``tiered:remote`` store) —
which is how `CostModel.io_cost` makes §3 plans prefer cached
fragments over equal-cost fragments that would pay the round trip.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.obs.registry import default_registry
from repro_torch.storage.base import (
    ObjectStat,
    RangeNotSatisfiable,
    StorageBackend,
)
from repro_torch.storage.journal import DEFAULT_SEGMENT_BYTES, WriteBackJournal

_log = logging.getLogger(__name__)

DEFAULT_HOT_BYTES = 256 * 1024 * 1024
FLUSH_MAX_ATTEMPTS = 3     # terminal failure after this many tries
_FLUSH_RETRY_DELAY = 0.05  # between background flush attempts

# priority fn: keys -> {key: score}; LOWER score spills first (matches
# LRU_VSS sequence-number semantics: lower = evict first)
PriorityFn = Callable[[Sequence[str]], Dict[str, float]]


class TieredBackend(StorageBackend):
    def __init__(
        self,
        cold: StorageBackend,
        *,
        hot_bytes: int = DEFAULT_HOT_BYTES,
        write_back: bool = False,
        journal_dir: Optional[str] = None,
        journal_segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        registry=None,
    ):
        self.cold = cold
        self.hot_bytes = hot_bytes
        self.write_back = write_back
        self._hot: Dict[str, bytes] = {}
        self._hot_total = 0
        self._tick = 0
        self._insert_seq: Dict[str, int] = {}
        self._priority_fn: Optional[PriorityFn] = None
        self._lock = threading.RLock()
        # -- write-back state (all guarded by _cv's lock) ------------------
        self._cv = threading.Condition(self._lock)
        self._dirty: Dict[str, int] = {}    # key -> generation
        self._gen = 0
        self._inflight: Dict[str, int] = {}  # key -> concurrent flushes
        self._attempts: Dict[str, int] = {}  # consecutive flush failures
        self._failed: Dict[str, BaseException] = {}  # terminal failures
        self._stop = False
        self._flusher: Optional[threading.Thread] = None
        self._demote_skipped: Set[str] = set()  # pinned keys demote skipped
        self._demote_warned = False
        # -- telemetry (repro_torch.obs): hit/miss/spill counters + hot-tier
        # gauges.  Handles are per-instance (exact), series process-wide
        # (summed on /metrics); gauges sample through weak refs so a
        # dropped tier stops reporting instead of leaking.
        reg = registry or default_registry()
        self._c_hits = reg.counter(
            "vss_cache_hits_total", "hot-tier read hits")
        self._c_misses = reg.counter(
            "vss_cache_misses_total", "hot-tier read misses (cold fetch)")
        self._c_spills = reg.counter(
            "vss_cache_spills_total", "hot objects demoted by the spiller")
        self._c_flushes = reg.counter(
            "vss_cache_writeback_flushes_total",
            "dirty objects landed on the cold tier")
        self._c_flush_failures = reg.counter(
            "vss_cache_writeback_flush_failures_total",
            "failed flush attempts (terminal after FLUSH_MAX_ATTEMPTS)")
        self._c_demote_pinned = reg.counter(
            "vss_cache_demote_pinned_total",
            "demote targets skipped because a terminal flush failure"
            " pins them hot")
        reg.gauge_fn("vss_cache_hot_bytes", self._hot_bytes_now,
                     "bytes resident in the hot tier")
        reg.gauge_fn("vss_cache_hot_objects", self._hot_count_now,
                     "objects resident in the hot tier")
        reg.gauge_fn("vss_cache_writeback_dirty_objects",
                     self._dirty_count_now,
                     "dirty objects queued for write-back flush")
        reg.gauge_fn("vss_cache_writeback_pinned_objects",
                     self._pinned_count_now,
                     "objects pinned hot by terminal flush failures")
        # -- crash-durable write-back: journal + startup replay -------------
        self._journal: Optional[WriteBackJournal] = None
        if write_back and journal_dir is not None:
            self._journal = WriteBackJournal(
                journal_dir, segment_bytes=journal_segment_bytes,
                registry=registry,
            )
            self._replay_journal()
        if write_back:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name="vss-tiered-flush",
            )
            self._flusher.start()

    def _replay_journal(self) -> None:
        """Rebuild the dirty set from journal records a crash left.
        Each surviving record is cross-checked against the cold tier
        first: a key whose flush landed but whose (unfsync'd) COMMIT
        record was lost is recognized by its cold copy already holding
        exactly the journaled bytes — it is committed now instead of
        re-uploaded, which is what makes replay idempotent.  A cold
        tier that is down (or missing the key) keeps the record dirty:
        possibly a redundant upload later, never a lost write."""
        replayed = self._journal.replay()
        settled = []
        for key, data in replayed.items():
            try:
                if self.cold.get(key) == data:
                    settled.append(key)
                    continue
            except Exception:
                pass  # unreachable/missing cold copy: stay dirty
            self._admit(key, data, dirty=True)
        if settled:
            self._journal.append_commit(settled)
        if replayed:
            _log.info(
                "write-back journal replay: %d unflushed object(s)"
                " re-queued, %d already on the cold tier",
                len(replayed) - len(settled), len(settled),
            )

    def set_priority_fn(self, fn: Optional[PriorityFn]) -> None:
        self._priority_fn = fn

    # -- gauge samplers (registered as weak callback gauges) ---------------
    def _hot_bytes_now(self) -> float:
        return self._hot_total

    def _hot_count_now(self) -> float:
        return len(self._hot)

    def _dirty_count_now(self) -> float:
        return len(self._dirty)

    def _pinned_count_now(self) -> float:
        return len(self._failed)

    # -- hot-tier bookkeeping ----------------------------------------------
    def _admit(self, key: str, data: bytes, *, dirty: bool = False) -> None:
        with self._cv:
            old = self._hot.get(key)
            if old is not None:
                self._hot_total -= len(old)
            self._hot[key] = data
            self._hot_total += len(data)
            self._tick += 1
            self._insert_seq[key] = self._tick
            if dirty:
                self._gen += 1
                self._dirty[key] = self._gen
                # a fresh write supersedes any terminal failure state
                self._failed.pop(key, None)
                self._attempts.pop(key, None)
                self._demote_skipped.discard(key)
                self._cv.notify_all()
        self._spill()

    def _spill_order(self) -> List[str]:
        """Hot keys least-worth-keeping first (call with the lock
        held).  catalog lru_seq and the internal insert tick are
        different counters — never compare them directly.  Rank each
        class by its own scale, normalize to [0, 1), and merge:
        least-wanted of each class spills first, interleaved fairly
        (keys the policy doesn't know about — e.g. _joint segments —
        degrade to LRU instead of always losing to catalog-scored
        keys)."""
        prio: Dict[str, float] = {}
        if self._priority_fn is not None:
            try:
                prio = dict(self._priority_fn(list(self._hot)) or {})
            except Exception:
                pass  # policy failure must not break the data path
        scored = sorted((k for k in self._hot if k in prio), key=prio.get)
        unscored = sorted(
            (k for k in self._hot if k not in prio),
            key=lambda k: self._insert_seq.get(k, 0),
        )
        rank = {k: i / len(scored) for i, k in enumerate(scored)}
        rank.update((k, i / len(unscored)) for i, k in enumerate(unscored))
        return sorted(self._hot, key=rank.get)

    def _spill(self) -> None:
        """Shrink the hot tier back under budget.  Clean keys drop in
        rank order; a DIRTY victim is flushed to the cold tier first —
        synchronously, on the spilling thread — so eviction can never
        lose the only copy of an unuploaded object.  A failed flush
        counts against the same `FLUSH_MAX_ATTEMPTS` policy the
        background flusher applies (one transient cold-tier hiccup
        must not terminally pin the key); terminally-failed keys are
        pinned hot (skipped)."""
        with self._cv:
            if self._hot_total <= self.hot_bytes:
                return
            # rank ONCE per pass — the priority fn is a catalog query
            # over every hot key, and paying it (plus the sorts) per
            # evicted victim would turn a K-key eviction into K full
            # recomputes.  Per-victim eligibility (dirty/inflight/
            # failed/still-hot) is re-checked under the lock as the
            # walk reaches each key.
            order = self._spill_order()
        for victim in order:
            with self._cv:
                if self._hot_total <= self.hot_bytes:
                    return
                if (victim not in self._hot or victim in self._failed
                        or victim in self._inflight):
                    continue  # raced away, pinned, or mid-flight
                gen = self._dirty.get(victim)
                if gen is None:
                    self._drop_one_locked(victim)
                    self._c_spills.inc()
                    continue
                data = self._hot[victim]
                self._inflight[victim] = self._inflight.get(victim, 0) + 1
            try:
                err: Optional[BaseException] = None
                try:
                    self.cold.put(victim, data)
                except BaseException as exc:
                    err = exc
                with self._cv:
                    if err is not None:
                        # can't flush, so can't drop; count the attempt
                        # like the background flusher would, and move
                        # on to the next victim in this pass
                        self._c_flush_failures.inc()
                        n_fail = self._attempts.get(victim, 0) + 1
                        self._attempts[victim] = n_fail
                        if n_fail >= FLUSH_MAX_ATTEMPTS:
                            self._failed[victim] = err
                        continue
                    self._c_flushes.inc()
                    if self._dirty.get(victim) == gen:
                        del self._dirty[victim]
                        self._attempts.pop(victim, None)
                        self._drop_one_locked(victim)
                        self._c_spills.inc()
                        if self._journal is not None:
                            self._journal.append_commit([victim])
                    # a newer write raced in: leave it for the flusher
            finally:
                with self._cv:
                    n = self._inflight.get(victim, 0) - 1
                    if n <= 0:
                        self._inflight.pop(victim, None)
                    else:
                        self._inflight[victim] = n
                    self._cv.notify_all()

    def _drop_one_locked(self, key: str) -> None:
        self._hot_total -= len(self._hot.pop(key))
        self._insert_seq.pop(key, None)

    def hot_keys(self) -> List[str]:
        with self._lock:
            return list(self._hot)

    def dirty_keys(self) -> List[str]:
        """Objects admitted but not yet durable on the cold tier."""
        with self._lock:
            return list(self._dirty)

    @property
    def hot_total_bytes(self) -> int:
        with self._lock:
            return self._hot_total

    # -- background flusher (write-back) -----------------------------------
    def _flushable_locked(self) -> Optional[str]:
        return next(
            (k for k in self._dirty
             if k not in self._failed and k not in self._inflight),
            None,
        )

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and self._flushable_locked() is None:
                    self._cv.wait()
                if self._stop:
                    return
                key = self._flushable_locked()
                gen = self._dirty[key]
                data = self._hot.get(key)
                if data is None:  # defensive: dirty implies hot
                    del self._dirty[key]
                    self._cv.notify_all()
                    continue
                self._inflight[key] = self._inflight.get(key, 0) + 1
            err: Optional[BaseException] = None
            try:
                self.cold.put(key, data)
            except BaseException as exc:
                err = exc
            with self._cv:
                n = self._inflight.get(key, 0) - 1
                if n <= 0:
                    self._inflight.pop(key, None)
                else:
                    self._inflight[key] = n
                if err is None:
                    self._c_flushes.inc()
                    self._attempts.pop(key, None)
                    if self._dirty.get(key) == gen:
                        del self._dirty[key]
                        # journal the commit only when THIS flush is
                        # what settled the key — a newer journaled PUT
                        # must not be masked by our COMMIT record
                        if self._journal is not None:
                            self._journal.append_commit([key])
                else:
                    self._c_flush_failures.inc()
                    n_fail = self._attempts.get(key, 0) + 1
                    self._attempts[key] = n_fail
                    if n_fail >= FLUSH_MAX_ATTEMPTS:
                        self._failed[key] = err
                self._cv.notify_all()
            if err is not None:
                time.sleep(_FLUSH_RETRY_DELAY)

    def flush(self, keys: Optional[Sequence[str]] = None) -> None:
        """Write-back durability barrier: returns once every dirty
        object — or, with ``keys``, every dirty object among them — is
        durable on the cold tier, or raises the first terminal flush
        failure in scope (the object stays pinned hot; `retry_failed`
        re-queues pinned objects after the cold tier recovers, and a
        fresh ``put`` of a key clears its failure).

        Drains through ``cold.batch_put`` — the pooled fan-out path —
        so a barrier over W objects costs ~W/pool round trips, not the
        background flusher's one-at-a-time trickle.  The ``keys``
        scope is what lets `publish_window` pay only for its OWN
        window instead of stalling a catalog commit behind other
        writers' queued uploads."""
        scope = None if keys is None else set(keys)

        def dirty_in_scope():
            if scope is None:
                return set(self._dirty)
            return set(self._dirty) & scope

        def inflight_in_scope():
            if scope is None:
                return bool(self._inflight)
            return any(k in self._inflight for k in scope)

        while True:
            with self._cv:
                batch = {
                    k: (self._dirty[k], self._hot[k])
                    for k in dirty_in_scope()
                    if k not in self._failed and k not in self._inflight
                    and k in self._hot
                }
                if not batch:
                    # nothing we can push: wait out in-scope in-flight
                    # uploads (and any dirty keys they cover), settle
                    self._cv.wait_for(
                        lambda: not inflight_in_scope()
                        and not (dirty_in_scope() - set(self._failed))
                    )
                    if dirty_in_scope() - set(self._failed):
                        continue  # new writes raced in while waiting
                    failed = {
                        k: e for k, e in self._failed.items()
                        if scope is None or k in scope
                    }
                    if failed:
                        key, exc = next(iter(failed.items()))
                        raise RuntimeError(
                            f"write-back flush failed for {key!r}"
                            f" (object pinned in the hot tier)"
                        ) from exc
                    return
                for k in batch:
                    self._inflight[k] = self._inflight.get(k, 0) + 1
            err: Optional[BaseException] = None
            try:
                try:
                    self.cold.batch_put(
                        [(k, d) for k, (_g, d) in batch.items()]
                    )
                except BaseException as exc:
                    err = exc
                with self._cv:
                    if err is None:
                        self._c_flushes.inc(len(batch))
                    else:
                        self._c_flush_failures.inc(len(batch))
                    settled = []
                    for k, (gen, _d) in batch.items():
                        if err is None:
                            self._attempts.pop(k, None)
                            if self._dirty.get(k) == gen:
                                del self._dirty[k]
                                settled.append(k)
                        else:
                            # re-flushing keys the failed batch DID
                            # land is benign (idempotent last-wins);
                            # count the attempt against each key
                            n = self._attempts.get(k, 0) + 1
                            self._attempts[k] = n
                            if n >= FLUSH_MAX_ATTEMPTS:
                                self._failed[k] = err
                    if settled and self._journal is not None:
                        self._journal.append_commit(settled)
            finally:
                with self._cv:
                    for k in batch:
                        n = self._inflight.get(k, 0) - 1
                        if n <= 0:
                            self._inflight.pop(k, None)
                        else:
                            self._inflight[k] = n
                    self._cv.notify_all()
            if err is not None:
                time.sleep(_FLUSH_RETRY_DELAY)

    def demote(self, keys: Sequence[str]) -> int:
        """Explicitly evict the given objects from the hot tier — the
        adaptive policy's cold-epoch seam.  Never destroys data: a
        dirty object is flushed to the cold tier first, and objects
        pinned by terminal flush failures (or mid-flight) are skipped.
        Returns how many hot copies were dropped.

        A flush failure here is never silent: the pinned keys are
        counted on ``vss_cache_demote_pinned_total``, logged once per
        tier instance, and reported by `stats()` under
        ``demote_skipped_pinned`` until they un-pin (a later
        successful flush, `retry_failed`, or a fresh write)."""
        with self._lock:
            targets = [k for k in keys if k in self._hot]
        if not targets:
            return 0
        if self.write_back:
            with self._lock:
                dirty = [k for k in targets if k in self._dirty]
            if dirty:
                try:
                    self.flush(dirty)
                except RuntimeError as exc:
                    # pinned keys stay hot; drop what settled — but
                    # surface the skip instead of swallowing it
                    with self._cv:
                        pinned = sorted(
                            k for k in dirty if k in self._failed)
                        self._demote_skipped.update(pinned)
                    self._c_demote_pinned.inc(len(pinned))
                    if not self._demote_warned:
                        self._demote_warned = True
                        _log.warning(
                            "demote: %d object(s) pinned hot by flush"
                            " failures (first: %r); cold tier down?"
                            " — see stats()['demote_skipped_pinned']"
                            " and retry_failed(): %s",
                            len(pinned), pinned[0] if pinned else None,
                            exc,
                        )
        dropped = 0
        with self._cv:
            for k in targets:
                if (k in self._hot and k not in self._dirty
                        and k not in self._inflight
                        and k not in self._failed):
                    self._drop_one_locked(k)
                    self._c_spills.inc()
                    dropped += 1
        return dropped

    def stats(self) -> Dict[str, object]:
        """Point-in-time tier health: hot-tier occupancy, the dirty
        backlog, terminally-pinned keys, and which demote targets were
        skipped because a flush failure pins them hot."""
        with self._cv:
            out: Dict[str, object] = {
                "hot_bytes": self._hot_total,
                "hot_objects": len(self._hot),
                "dirty_objects": len(self._dirty),
                "pinned_objects": len(self._failed),
                "pinned_keys": sorted(self._failed),
                "demote_skipped_pinned": sorted(self._demote_skipped),
            }
        if self._journal is not None:
            out["journal_pending_objects"] = len(
                self._journal.pending_keys())
        return out

    def retry_failed(self) -> int:
        """Un-pin terminally-failed write-back objects (after the cold
        tier recovers): their failure state clears, they stay dirty,
        and the next `flush` — or the background flusher — retries
        them.  Returns how many were re-queued."""
        with self._cv:
            n = len(self._failed)
            self._failed.clear()
            self._attempts.clear()
            self._demote_skipped.clear()
            self._cv.notify_all()
        return n

    def _retire_key_locked(self, key: str) -> None:
        """Wait out any in-flight flush of ``key`` (a trailing upload
        completing later would resurrect stale bytes on the cold tier)
        and clear its write-back state — all under one lock hold, so
        the flusher cannot start a new upload in between."""
        self._cv.wait_for(lambda: key not in self._inflight)
        self._dirty.pop(key, None)
        self._failed.pop(key, None)
        self._attempts.pop(key, None)

    # -- contract ----------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        data = bytes(data)
        if self.write_back:
            if len(data) > self.hot_bytes:
                # would evict the whole tier and still not fit: this
                # one object degrades to write-through.  Order matters:
                # the key may hold a previously ACKNOWLEDGED dirty
                # value whose only copy is the hot one — un-queue it
                # (so the flusher can't race us) but destroy nothing
                # until the cold put has succeeded; on failure the old
                # value is re-queued and stays durable-trackable.
                with self._cv:
                    self._cv.wait_for(lambda: key not in self._inflight)
                    was_dirty = self._dirty.pop(key, None) is not None
                try:
                    self.cold.put(key, data)
                except BaseException:
                    with self._cv:
                        if was_dirty and key in self._hot:
                            self._gen += 1
                            self._dirty[key] = self._gen
                        self._cv.notify_all()
                    raise
                with self._cv:
                    self._failed.pop(key, None)
                    self._attempts.pop(key, None)
                    if key in self._hot:
                        self._drop_one_locked(key)
                    self._cv.notify_all()
                if was_dirty and self._journal is not None:
                    # the journaled old value is superseded by a value
                    # that is already durable: settle its record
                    self._journal.append_commit([key])
                return
            self._admit(key, data, dirty=True)
            if self._journal is not None:
                # fsync'd before the put acknowledges — the bytes that
                # back the acknowledgement now live on local disk, not
                # just in the volatile hot tier
                self._journal.append_put(key, data)
            # backpressure during a cold-tier outage: once pinned
            # (terminally unflushable) objects hold the tier over
            # budget, accepting more dirty bytes at memory speed would
            # grow the heap without bound — fail the put instead (the
            # honest write-through behaviour; the admitted bytes stay
            # hot and flush eventually, which is orphan-equivalent for
            # a caller that treats this put as failed)
            with self._cv:
                if self._failed and self._hot_total > self.hot_bytes:
                    key0, exc = next(iter(self._failed.items()))
                    raise RuntimeError(
                        f"write-back cache over budget with"
                        f" {len(self._failed)} object(s) pinned by flush"
                        f" failures (first: {key0!r}); cold tier down?"
                        f" — see retry_failed()"
                    ) from exc
            return
        self.cold.put(key, data)  # durable copy first (write-through)
        if len(data) <= self.hot_bytes:
            self._admit(key, data)
        else:
            self._uncache(key)  # a stale smaller hot copy must not mask
            # the oversized overwrite that only the cold tier holds

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        if self.write_back:
            if self._journal is None:
                for key, data in items:
                    self.put(key, data)
                return
            # journal the whole admission group under ONE fsync (the
            # <15% fig26 budget lives or dies here), oversized objects
            # excepted — they take the write-through degrade in put()
            group: List[Tuple[str, bytes]] = []
            for key, data in items:
                data = bytes(data)
                if len(data) > self.hot_bytes:
                    self.put(key, data)
                    continue
                self._admit(key, data, dirty=True)
                group.append((key, data))
            self._journal.append_puts(group)
            with self._cv:
                if self._failed and self._hot_total > self.hot_bytes:
                    key0, exc = next(iter(self._failed.items()))
                    raise RuntimeError(
                        f"write-back cache over budget with"
                        f" {len(self._failed)} object(s) pinned by flush"
                        f" failures (first: {key0!r}); cold tier down?"
                        f" — see retry_failed()"
                    ) from exc
            return
        self.cold.batch_put(items)  # durable copies first (write-through)
        for key, data in items:
            if len(data) <= self.hot_bytes:
                self._admit(key, bytes(data))
            else:
                self._uncache(key)

    def _uncache(self, key: str) -> None:
        """Drop a (clean) hot copy so the cold tier's value shows."""
        with self._lock:
            if key in self._hot:
                self._drop_one_locked(key)

    def get(self, key: str) -> bytes:
        with self._lock:
            data = self._hot.get(key)
        if data is not None:
            self._c_hits.inc()
            return data
        self._c_misses.inc()
        data = self.cold.get(key)
        if len(data) <= self.hot_bytes:
            self._admit(key, data)
        return data

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """A hot hit slices in memory; a miss delegates the ranged read
        to the cold tier WITHOUT admitting — partial bytes must never
        land in the hot tier under the full object's key (a later get
        would serve the fragment as the whole object)."""
        if start < 0 or length < 1:
            raise ValueError(f"bad range start={start} length={length}")
        with self._lock:
            data = self._hot.get(key)
        if data is not None:
            self._c_hits.inc()
            if start >= len(data):
                raise RangeNotSatisfiable(key, start, len(data))
            return data[start : start + length]
        self._c_misses.inc()
        return self.cold.get_range(key, start, length)

    def batch_get_ranges(
        self, reqs: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        with self._lock:
            hot = {k: self._hot[k] for k, _s, _n in reqs if k in self._hot}
        results: List[Optional[bytes]] = [None] * len(reqs)
        missing: List[int] = []
        for i, (k, s, n) in enumerate(reqs):
            data = hot.get(k)
            if data is None:
                missing.append(i)
                continue
            if s < 0 or n < 1:
                raise ValueError(f"bad range start={s} length={n}")
            if s >= len(data):
                raise RangeNotSatisfiable(k, s, len(data))
            results[i] = data[s : s + n]
        self._c_hits.inc(len(reqs) - len(missing))
        self._c_misses.inc(len(missing))
        if missing:
            fetched = self.cold.batch_get_ranges(
                [reqs[i] for i in missing]
            )
            for i, data in zip(missing, fetched):
                results[i] = data
        return results  # type: ignore[return-value]

    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        with self._lock:
            hot = {k: self._hot[k] for k in keys if k in self._hot}
        missing = [k for k in keys if k not in hot]
        self._c_hits.inc(len(keys) - len(missing))
        self._c_misses.inc(len(missing))
        if missing:
            fetched = dict(zip(missing, self.cold.batch_get(missing)))
            for k, v in fetched.items():
                if len(v) <= self.hot_bytes:
                    self._admit(k, v)
            hot.update(fetched)
        return [hot[k] for k in keys]

    def delete(self, key: str) -> None:
        with self._cv:
            self._retire_key_locked(key)
            old = self._hot.pop(key, None)
            if old is not None:
                self._hot_total -= len(old)
            self._insert_seq.pop(key, None)
        if self._journal is not None:
            # fsync'd before the cold delete: a lost DELETE record
            # would make replay resurrect (re-upload) the object
            self._journal.append_delete(key)
        self.cold.delete(key)

    def stat(self, key: str) -> ObjectStat:
        with self._lock:
            data = self._hot.get(key)
        if data is not None:
            return ObjectStat(key, len(data))
        return self.cold.stat(key)

    def list(self, prefix: str = "") -> List[str]:
        # cold is authoritative, plus dirty objects it hasn't seen yet
        with self._lock:
            dirty = [k for k in self._dirty if k.startswith(prefix)]
        if not dirty:
            return self.cold.list(prefix)
        return list(set(self.cold.list(prefix)) | set(dirty))

    def kind_for(self, key: str) -> str:
        """Per-key tier answer: a hot hit is priced as memory I/O, a
        miss as whatever the cold backend would charge ("remote" when
        the cold tier is an object server) — this is what lets the §3
        cost model prefer fragments already in the cache over
        equal-cost fragments that would pay the cold fetch."""
        with self._lock:
            if key in self._hot:
                return "memory"
        return self.cold.kind_for(key)

    def sweep_temps(self) -> int:
        return self.cold.sweep_temps()

    def layout_fingerprint(self) -> str:
        # the hot tier is ephemeral; placement is entirely the cold
        # tier's, so tiered-over-X and plain X are interchangeable
        return self.cold.layout_fingerprint()

    def configure_concurrency(self, n: int) -> None:
        self.cold.configure_concurrency(n)

    def ensure_durable(self, keys: Optional[Sequence[str]] = None) -> None:
        # the ingest path's durability hook: a write-back tier lands
        # the window's dirty objects before any catalog row references
        # them (scoped — other writers' queued uploads aren't billed
        # to this window's barrier)
        if self.write_back:
            self.flush(keys)
        else:
            self.cold.ensure_durable(keys)

    def calibration_targets(self) -> Dict[str, StorageBackend]:
        # a hot hit is already priced by the io_table's "memory" row;
        # what needs measuring is the tier a miss would pay for
        return self.cold.calibration_targets()

    def _drop_hot(self) -> None:
        with self._lock:
            self._hot.clear()
            self._insert_seq.clear()
            self._hot_total = 0

    def recover(self, catalog):
        # the hot tier does not survive a restart anyway; recovery is
        # the COLD tier's (tiered-over-replicated must run the replica
        # scrub, not a generic scavenge whose probes the read-fallback
        # would satisfy even with a replica lost).  Land any dirty
        # write-back objects first so the scavenge sees them.
        if self.write_back:
            self.flush()
        self._drop_hot()
        return self.cold.recover(catalog)

    def scrub(self, catalog, *, collect_orphans: bool = False):
        # drop hot copies first: a scrub may rewrite divergent cold
        # objects, and a stale hot hit would mask the repaired bytes
        if self.write_back:
            self.flush()
        self._drop_hot()
        return self.cold.scrub(catalog, collect_orphans=collect_orphans)

    def close(self) -> None:
        try:
            if self.write_back:
                # one recovery chance for objects pinned by an outage
                # that may since have cleared: un-pin and let the final
                # flush retry them; a still-down cold tier raises
                self.retry_failed()
                self.flush()  # close() implies the durability barrier
        finally:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            if self._flusher is not None:
                self._flusher.join(timeout=5.0)
            if self._journal is not None:
                self._journal.close()
            self.cold.close()
