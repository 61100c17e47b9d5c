"""Quorum-replicated composition of N child backends.

The production north star (serve millions of users) makes single-copy
placement the weakest link: one lost volume loses GOPs and takes reads
down with it.  `ReplicatedBackend` closes that hole at the same seam
every other layout lives behind — it IS a `StorageBackend`, composing
N children (typically `LocalFSBackend`s on distinct disks, but any
backend: a memory child in front of two disk children gives replicated
tiering for free).

Placement reuses the consistent-hash ring (`repro_torch.storage.sharded
.HashRing`): a key's replica set is the first ``replicas`` distinct
children walking the ring from the key's hash, so adding a child moves
~1/N of the replica slots and two backends with equal (child count,
replica count) place every key identically — which is exactly what the
layout fingerprint promises.

Write quorum
  ``put`` fans a write out to all ``replicas`` preferred children and
  returns once ``write_quorum`` of them hold the object durably (each
  child's put keeps its own atomicity — a reader never sees a partial
  replica).  Stragglers finish in the background; ``quiesce()`` waits
  them out and ``close()`` implies it.  A write that cannot reach
  quorum raises `ReplicationError`, and whatever partial replicas
  landed are the scrubber's to collect — the caller never indexed the
  key, so they are ordinary orphans.  ``batch_put`` fans one task per
  child (mirroring `ShardedBackend`) and checks the quorum per object
  after all children settle; a dead child fails fast, so quorum writes
  keep flowing through the ingest pipeline without stalling encode.

Read fallback
  ``get``/``batch_get``/``stat`` try replicas in preference order —
  fastest first, ranked by each child's ``kind_for`` answer — and fall
  back to the next replica on ANY child failure (`ObjectNotFound`, a
  dead disk's OSError, a wrapper's injected fault).  A down child
  degrades latency, never availability; `ObjectNotFound` surfaces only
  when no replica holds the key.  An optional ``validate`` hook makes
  corruption (bytes that land but fail GOP validation) another
  fall-back trigger, at the price of validating every read — the
  scrubber is the cheap place to catch torn replicas, so the hook is
  off by default.

``kind_for`` answers per replica: the kind of the child that would
serve the key *right now* (first live replica actually holding it), so
`CostModel.io_cost` prices a degraded read by the tier it will really
hit.  ``mark_child_down``/``mark_child_up`` are the ops seam (take a
volume offline for maintenance; fault injection in tests and fig25) —
a down child raises `ChildDownError` on every access, which the
fallback paths treat like any other dead child.

Concurrent overwrites of one key are unordered across replicas (same
as every other backend: last write wins per child) — VSS never
overwrites a live GOP key concurrently.  A delete racing a straggler
put can resurrect a replica on one child; the scrubber prunes it.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.storage.base import ObjectNotFound, ObjectStat, StorageBackend
from repro_torch.storage.localfs import LocalFSBackend
from repro_torch.storage.sharded import HashRing

DEFAULT_REPLICAS = 3

# kind -> relative speed rank for replica preference (lower = try first);
# mirrors the ordering of DEFAULT_IO_TABLE without importing the cost
# model into the storage layer
_KIND_RANK = {
    "memory": 0,
    "tiered": 1,
    "replicated": 2,
    "sharded": 3,
    "localfs": 3,
    "default": 4,
    "remote": 5,
}


class ReplicationError(IOError):
    """A write could not reach its quorum (per-child causes attached)."""

    def __init__(self, message: str, causes: Sequence[BaseException] = ()):
        super().__init__(message)
        self.causes = list(causes)


class ChildDownError(IOError):
    """Raised on any access to a child marked down (ops seam)."""


class ReplicaStats:
    """Monotonic health counters (observability for fig25 and ops).

    The attribute shape (``stats.fallback_reads`` ints, ``+=``-able
    under the backend lock) is the legacy surface; the values live in
    per-instance `repro_torch.obs` registry handles so the same counts feed
    ``/metrics`` without double bookkeeping."""

    __slots__ = ("_fallback", "_degraded", "_straggler")

    def __init__(self, registry=None):
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._fallback = reg.counter(
            "vss_replica_fallback_reads_total",
            "reads served by a non-preferred replica")
        self._degraded = reg.counter(
            "vss_replica_degraded_writes_total",
            "puts that met quorum but not full replication")
        self._straggler = reg.counter(
            "vss_replica_straggler_failures_total",
            "background replica writes that failed")

    @staticmethod
    def _bump(handle, new: int) -> None:
        delta = float(new) - handle.value
        if delta > 0:
            handle.inc(delta)

    @property
    def fallback_reads(self) -> int:
        return int(self._fallback.value)

    @fallback_reads.setter
    def fallback_reads(self, new: int) -> None:
        self._bump(self._fallback, new)

    @property
    def degraded_writes(self) -> int:
        return int(self._degraded.value)

    @degraded_writes.setter
    def degraded_writes(self, new: int) -> None:
        self._bump(self._degraded, new)

    @property
    def straggler_failures(self) -> int:
        return int(self._straggler.value)

    @straggler_failures.setter
    def straggler_failures(self, new: int) -> None:
        self._bump(self._straggler, new)


class ReplicatedBackend(StorageBackend):
    KIND = "replicated"

    def __init__(
        self,
        children: Sequence[StorageBackend],
        *,
        replicas: Optional[int] = None,
        write_quorum: Optional[int] = None,
        validate=None,  # Optional[Callable[[bytes], bool]] corruption hook
        registry=None,
    ):
        if not children:
            raise ValueError("ReplicatedBackend needs at least one child")
        self.children = list(children)
        n = len(self.children)
        if replicas is None:
            replicas = min(DEFAULT_REPLICAS, n)
        self.replicas = min(replicas, n)
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if write_quorum is None:
            write_quorum = self.replicas // 2 + 1
        self.write_quorum = write_quorum
        if not 1 <= self.write_quorum <= self.replicas:
            raise ValueError(
                f"write_quorum must be in [1, {self.replicas}],"
                f" got {self.write_quorum}"
            )
        self.ring = HashRing(n)
        self.validate = validate
        self.stats = ReplicaStats(registry)
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._c_scrub_runs = reg.counter(
            "vss_scrub_runs_total", "integrity scrubs executed")
        self._c_scrub_repaired = reg.counter(
            "vss_scrub_replicas_repaired_total",
            "missing/torn/divergent replicas rewritten by scrubs")
        self._c_scrub_pruned = reg.counter(
            "vss_scrub_replicas_pruned_total",
            "misplaced replicas removed by scrubs")
        self._down: Set[int] = set()
        self._stragglers: Set[Future] = set()
        # key -> its in-flight straggler futures: a later put/delete of
        # the SAME key waits these out first, so overwrites can't
        # interleave with a previous write's tail and diverge replicas
        self._inflight_keys: Dict[str, Set[Future]] = {}
        # key -> kind_for answer.  The uncached answer costs up to R
        # existence probes (real syscalls on LocalFS children) and the
        # §3 planner asks per GOP per candidate — memoize, invalidated
        # whenever who-serves-a-key can change (writes/deletes of the
        # key, a child going down or coming back, a scrub repair)
        self._kind_memo: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=min(2 * n, (os.cpu_count() or 4) * 2, 16),
            thread_name_prefix="vss-replica",
        )

    @classmethod
    def local(
        cls, root: str, n_children: int, *,
        replicas: Optional[int] = None,
        write_quorum: Optional[int] = None,
        fsync: bool = False,
        registry=None,
    ) -> "ReplicatedBackend":
        return cls(
            [
                LocalFSBackend(os.path.join(root, f"replica{i}"), fsync=fsync)
                for i in range(n_children)
            ],
            replicas=replicas, write_quorum=write_quorum, registry=registry,
        )

    # -- ops seam ----------------------------------------------------------
    def mark_child_down(self, idx: int) -> None:
        """Take child ``idx`` offline: every access raises
        `ChildDownError` until `mark_child_up`.  Reads fall back, writes
        proceed on the surviving replicas (quorum permitting), and the
        scrubber re-replicates once the child returns."""
        self.children[idx]  # bounds check
        with self._lock:
            self._down.add(idx)
            self._kind_memo.clear()

    def mark_child_up(self, idx: int) -> None:
        with self._lock:
            self._down.discard(idx)
            self._kind_memo.clear()

    def child_is_down(self, idx: int) -> bool:
        with self._lock:
            return idx in self._down

    def live_children(self) -> List[int]:
        with self._lock:
            return [i for i in range(len(self.children))
                    if i not in self._down]

    def _child(self, idx: int) -> StorageBackend:
        if self.child_is_down(idx):
            raise ChildDownError(f"child {idx} is marked down")
        return self.children[idx]

    # -- placement ---------------------------------------------------------
    def replicas_for(self, key: str) -> List[int]:
        """The child indices holding this key's copies, in ring
        (placement) order."""
        return self.ring.preference(key, self.replicas)

    def _read_order(self, key: str) -> List[int]:
        """Replica indices in read-preference order: fastest kind first
        (per-key, so a tiered/memory child outranks disks only while it
        would actually serve from its fast tier), ring position breaks
        ties.  Deliberately blind to the down set — a down child fails
        instantly in the fallback loop, which keeps the accounting
        honest (every read past it counts as a fallback)."""
        prefs = self.replicas_for(key)

        def rank(ci: int) -> int:
            try:
                return _KIND_RANK.get(
                    self.children[ci].kind_for(key), _KIND_RANK["default"]
                )
            except Exception:
                return _KIND_RANK["default"]
        return sorted(prefs, key=lambda ci: (rank(ci), prefs.index(ci)))

    # -- write path --------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        """Quorum write: durable on ``write_quorum`` replicas before
        return; remaining replica writes finish in the background."""
        self._wait_key(key)  # serialize against a previous write's tail
        with self._lock:
            self._kind_memo.pop(key, None)
        futures = {
            self._pool.submit(self._put_one, ci, key, data)
            for ci in self.replicas_for(key)
        }
        pending = set(futures)
        successes = 0
        errors: List[BaseException] = []
        while pending and successes < self.write_quorum:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                exc = f.exception()
                if exc is None:
                    successes += 1
                else:
                    errors.append(exc)
        if pending:  # stragglers: track so quiesce/close/overwrites wait
            with self._lock:
                self._stragglers.update(pending)
                self._inflight_keys.setdefault(key, set()).update(pending)
            for f in pending:
                f.add_done_callback(
                    lambda fut, key=key: self._straggler_done(key, fut)
                )
        if successes < self.write_quorum:
            raise ReplicationError(
                f"quorum write failed for {key!r}:"
                f" {successes}/{self.write_quorum} replicas durable"
                f" ({len(errors)} failed)", errors,
            )
        if errors:
            with self._lock:
                self.stats.degraded_writes += 1

    def _put_one(self, ci: int, key: str, data: bytes) -> None:
        self._child(ci).put(key, data)

    def _straggler_done(self, key: str, f: Future) -> None:
        with self._lock:
            self._stragglers.discard(f)
            remaining = self._inflight_keys.get(key)
            if remaining is not None:
                remaining.discard(f)
                if not remaining:
                    del self._inflight_keys[key]
            if f.exception() is not None:
                self.stats.straggler_failures += 1

    def _wait_key(self, key: str) -> None:
        while True:
            with self._lock:
                pending = list(self._inflight_keys.get(key, ()))
            if not pending:
                return
            wait(pending)

    def quiesce(self) -> None:
        """Wait for background replica writes (stragglers past the
        quorum) to settle.  Failures were already counted; the scrubber
        repairs whatever they left under-replicated."""
        while True:
            with self._lock:
                pending = list(self._stragglers)
            if not pending:
                return
            wait(pending)

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Fan a window of writes out over the children (one task per
        child, writes within a child stay ordered), then enforce the
        quorum per object: the batch returns only when every item is
        durable on >= ``write_quorum`` replicas.  Per-object atomicity
        is each child's; the batch as a whole has none (callers index
        rows only after it returns — a crash mid-batch leaves orphan
        replicas for the scrubber)."""
        for key, _data in items:
            self._wait_key(key)
        with self._lock:
            for key, _data in items:
                self._kind_memo.pop(key, None)
        by_child: Dict[int, List[Tuple[str, bytes]]] = {}
        for key, data in items:
            for ci in self.replicas_for(key):
                by_child.setdefault(ci, []).append((key, data))
        # count DISTINCT durable replicas per key (a duplicate key in
        # one batch lands twice on the same child — one copy)
        ok: Dict[str, Set[int]] = {key: set() for key, _ in items}
        errors: List[BaseException] = []
        err_lock = threading.Lock()

        def store(ci: int, batch: List[Tuple[str, bytes]]):
            for key, data in batch:
                try:
                    self._put_one(ci, key, data)
                except BaseException as exc:
                    with err_lock:
                        errors.append(exc)
                else:
                    with err_lock:
                        ok[key].add(ci)

        futures = [
            self._pool.submit(store, ci, batch)
            for ci, batch in by_child.items()
        ]
        for f in futures:
            f.result()
        under = [k for k, cis in ok.items() if len(cis) < self.write_quorum]
        if under:
            raise ReplicationError(
                f"quorum batch_put failed for {len(under)} object(s)"
                f" (first: {under[0]!r})", errors,
            )
        if errors:
            with self._lock:
                self.stats.degraded_writes += 1

    # -- read path ---------------------------------------------------------
    def _get_from(self, ci: int, key: str) -> bytes:
        data = self._child(ci).get(key)
        if self.validate is not None and not self.validate(data):
            raise ObjectNotFound(f"{key} (corrupt replica on child {ci})")
        return data

    @staticmethod
    def _soft_miss(exc: BaseException) -> bool:
        """Errors that mean "this replica has nothing to offer", not
        "something is broken": a plain miss, or a child deliberately
        taken down."""
        return isinstance(exc, (ObjectNotFound, ChildDownError))

    def _confidently_missing(self, errors: Sequence[BaseException],
                             n_slots: int) -> bool:
        """True iff the probes PROVE absence: every failure was soft,
        and enough slots answered a verified not-found that a quorum
        write could not be hiding entirely on the unreachable rest
        (>= n_slots - W + 1 verified misses).  Anything less is
        unavailability, not absence — durable data whose live copies
        sit behind down children must never be reported as missing."""
        if not all(self._soft_miss(e) for e in errors):
            return False
        verified = sum(isinstance(e, ObjectNotFound) for e in errors)
        return verified >= n_slots - self.write_quorum + 1

    def get(self, key: str) -> bytes:
        # read-your-writes: a get racing the tail of a quorum write to
        # the SAME key could hit the one replica the straggler hasn't
        # reached yet and return the prior value — wait the tail out
        # (a no-op unless this key was overwritten milliseconds ago)
        self._wait_key(key)
        errors: List[BaseException] = []
        order = self._read_order(key)
        for i, ci in enumerate(order):
            try:
                data = self._get_from(ci, key)
            except Exception as exc:
                errors.append(exc)
                continue
            if i > 0:
                with self._lock:
                    self.stats.fallback_reads += 1
            return data
        if self._confidently_missing(errors, len(order)):
            raise ObjectNotFound(key)
        raise ReplicationError(
            f"no replica could serve {key!r}", errors
        )

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged read with the same replica fallback as ``get``.  The
        ``validate`` hook is skipped — it checks whole objects, and a
        partial body can never satisfy it — so a torn replica is caught
        by the caller's header/offset parse instead."""
        if start < 0 or length < 1:
            raise ValueError(f"bad range start={start} length={length}")
        self._wait_key(key)  # read-your-writes, as in get()
        errors: List[BaseException] = []
        order = self._read_order(key)
        for i, ci in enumerate(order):
            try:
                data = self._child(ci).get_range(key, start, length)
            except ValueError:
                raise  # the range is wrong, not the replica
            except Exception as exc:
                errors.append(exc)
                continue
            if i > 0:
                with self._lock:
                    self.stats.fallback_reads += 1
            return data
        if self._confidently_missing(errors, len(order)):
            raise ObjectNotFound(key)
        raise ReplicationError(
            f"no replica could serve range of {key!r}", errors
        )

    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        """Round-based fan-out: round r fetches every still-missing key
        from its r-th preferred replica, one task per child so I/O
        overlaps across children (and a child dying MID-round fails
        only the keys it hadn't served — the next round retries just
        those on the surviving replicas)."""
        results: List[Optional[bytes]] = [None] * len(keys)
        for k in keys:  # read-your-writes, as in get()
            self._wait_key(k)
        orders = [self._read_order(k) for k in keys]
        pending = list(range(len(keys)))
        # errors PER KEY: a transient fault on a key that later
        # succeeds from another replica must not turn a different key's
        # genuine miss into a ReplicationError, and the final
        # missing-vs-unavailable call (`_confidently_missing`) needs
        # each failed key's own probe results
        key_errors: Dict[int, List[BaseException]] = {}
        for rnd in range(self.replicas):
            if not pending:
                break
            by_child: Dict[int, List[int]] = {}
            exhausted: List[int] = []
            for i in pending:
                if rnd >= len(orders[i]):
                    exhausted.append(i)
                    continue
                by_child.setdefault(orders[i][rnd], []).append(i)
            failed: List[int] = list(exhausted)
            fail_lock = threading.Lock()

            def fetch(ci: int, idxs: List[int]):
                for i in idxs:
                    try:
                        results[i] = self._get_from(ci, keys[i])
                    except Exception as exc:
                        with fail_lock:
                            failed.append(i)
                            key_errors.setdefault(i, []).append(exc)

            futures = [
                self._pool.submit(fetch, ci, idxs)
                for ci, idxs in by_child.items()
            ]
            for f in futures:
                f.result()
            if rnd > 0:
                attempted = sum(len(v) for v in by_child.values())
                served = attempted - (len(failed) - len(exhausted))
                if served > 0:
                    with self._lock:
                        self.stats.fallback_reads += served
            pending = sorted(failed)
        if pending:
            if all(
                self._confidently_missing(
                    key_errors.get(i, []), len(orders[i])
                )
                for i in pending
            ):
                raise ObjectNotFound(keys[pending[0]])
            causes = [e for i in pending for e in key_errors.get(i, ())
                      if not self._soft_miss(e)]
            raise ReplicationError(
                f"no replica could serve {keys[pending[0]]!r}"
                f" (+{len(pending) - 1} more)", causes,
            )
        return results  # type: ignore[return-value]

    def stat(self, key: str) -> ObjectStat:
        self._wait_key(key)  # read-your-writes, as in get()
        errors: List[BaseException] = []
        order = self._read_order(key)
        for ci in order:
            try:
                st = self._child(ci).stat(key)
                return ObjectStat(key, st.nbytes)
            except Exception as exc:
                errors.append(exc)
        if self._confidently_missing(errors, len(order)):
            raise ObjectNotFound(key)
        raise ReplicationError(f"no replica could stat {key!r}", errors)

    # -- namespace ---------------------------------------------------------
    def delete(self, key: str) -> None:
        """Best-effort delete on every replica (idempotent).  A down
        child keeps its copy — it becomes a misplaced/orphan replica
        the scrubber prunes once the child returns."""
        self._wait_key(key)  # a straggler put must not resurrect the key
        with self._lock:
            self._kind_memo.pop(key, None)
        for ci in self.replicas_for(key):
            try:
                self._child(ci).delete(key)
            except Exception:
                pass

    def list(self, prefix: str = "") -> List[str]:
        """Union over live children (each key appears once, however
        many replicas hold it).  With children down this can
        under-report — which is why the replicated scavenge path is the
        scrubber, not the generic key-level sweep."""
        out: Set[str] = set()
        for ci in self.live_children():
            out.update(self.children[ci].list(prefix))
        return list(out)

    _KIND_MEMO_MAX = 1 << 16

    def kind_for(self, key: str) -> str:
        """The I/O class of the replica that would serve ``key`` right
        now: first child in read-preference order that is up and holds
        the object.  Degraded reads (preferred replica dead) therefore
        price as whatever tier the surviving copy lives on.  Memoized —
        the planner asks per GOP per candidate, and the uncached probe
        does real I/O."""
        with self._lock:
            memo = self._kind_memo.get(key)
        if memo is not None:
            return memo
        kind = self.KIND
        for ci in self._read_order(key):
            try:
                if self._child(ci).exists(key):
                    kind = self._child(ci).kind_for(key)
                    break
            except Exception:
                continue
        with self._lock:
            if len(self._kind_memo) >= self._KIND_MEMO_MAX:
                self._kind_memo.clear()
            self._kind_memo[key] = kind
        return kind

    # -- per-replica access (scrubber/repair API) --------------------------
    def replica_get(self, ci: int, key: str) -> bytes:
        return self._child(ci).get(key)

    def replica_put(self, ci: int, key: str, data: bytes) -> None:
        self._child(ci).put(key, data)

    def replica_delete(self, ci: int, key: str) -> None:
        self._child(ci).delete(key)

    def replica_list(self, ci: int, prefix: str = "") -> List[str]:
        return self._child(ci).list(prefix)

    def replica_count(self, key: str) -> int:
        """How many of the key's placement slots hold a copy right now
        (down children count as not holding one)."""
        n = 0
        for ci in self.replicas_for(key):
            try:
                if self._child(ci).exists(key):
                    n += 1
            except Exception:
                pass
        return n

    # -- maintenance -------------------------------------------------------
    def configure_concurrency(self, n: int) -> None:
        for c in self.children:
            c.configure_concurrency(n)

    def sweep_temps(self) -> int:
        removed = 0
        for ci in self.live_children():
            removed += self.children[ci].sweep_temps()
        return removed

    def layout_fingerprint(self) -> str:
        # placement is a pure function of (child count, replica count);
        # the write quorum is a durability knob, not a layout property
        return f"replicated:{len(self.children)}:{self.replicas}"

    def recover(self, catalog):
        """Startup recovery for a replicated store IS a scrub: the
        generic key-level scavenge can't see a single lost replica
        (reads fall back), so recovery validates per replica and
        re-replicates from healthy copies.  Startup is single-threaded,
        so the orphan sweep is safe and runs."""
        return self.scrub(catalog, collect_orphans=True)

    def scrub(self, catalog, *, collect_orphans: bool = False):
        from repro_torch.storage.recovery import scrub

        self.quiesce()
        with self._lock:
            self._kind_memo.clear()  # repairs change who serves a key
        report = scrub(self, catalog, collect_orphans=collect_orphans)
        self._c_scrub_runs.inc()
        self._c_scrub_repaired.inc(report.replicas_repaired)
        self._c_scrub_pruned.inc(report.replicas_pruned)
        return report

    def close(self) -> None:
        self.quiesce()
        self._pool.shutdown(wait=False)
        for c in self.children:
            c.close()
