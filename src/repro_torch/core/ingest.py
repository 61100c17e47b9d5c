"""Pipelined ingest — a bounded publish queue drained by a worker pool.

VSS's write path must keep up with live camera streams (§4, §6.5): the
paper's argument is that ingest stays near raw-copy speed only when
encoding overlaps physical I/O and expensive work is deferred.  The
seed writer serialized the two — `VSSWriter._flush_gop` encoded a GOP
and then blocked on the backend put before touching the next chunk —
so a single stream alternated CPU and disk, and N concurrent cameras
contended on one synchronous path.

`IngestPipeline` decouples them.  Writers keep encoding on their own
thread and hand finished *publish windows* (a batch of encoded GOPs
plus the catalog rows that will index them) to a bounded queue; a
small worker pool drains the queue, issuing one ``backend.batch_put``
per window followed by one windowed ``Catalog.add_gops`` transaction.
Because every window follows the publish-then-index protocol (objects
durable before any row references them — see `repro_torch.storage.recovery`)
the pipeline adds no new crash states: a crash with windows still
queued loses only unindexed objects, which the startup scavenger
already removes as orphans.

Semantics
  * **Per-writer FIFO**: each writer owns an `IngestChannel`; at most
    one of its windows is in flight at a time and windows publish in
    submission order, so a writer's indexed GOPs always form a prefix
    of what it appended (never a gap followed by later frames).
    Different channels publish concurrently — that is where the
    multi-stream overlap comes from.
  * **Backpressure**: `submit` blocks while the pipeline already holds
    ``queue_gops`` GOPs, bounding ingest memory.  A window larger than
    the whole bound is admitted alone rather than deadlocking.
  * **Durability barrier**: `flush(channel)` returns only when every
    window the channel submitted is durable AND indexed (or one of
    them failed — then the error re-raises here).  `VSSWriter.close()`
    calls it, preserving the store's close-is-a-barrier guarantee.
  * **Exact error propagation**: a failed put poisons the owning
    channel — the error re-raises on that writer's next ``append`` or
    ``close`` and its remaining queued windows are discarded (indexing
    past a failed window would fake a durable prefix).  Other writers
    sharing the pipeline are unaffected; no GOP is ever silently
    dropped.
  * **Read-your-writes**: `barrier(names)` waits for all in-flight
    work on the given logical videos; the store calls it from
    ``read_batch``/``stats``/``drop`` so mid-stream prefix reads
    observe everything already appended, exactly as they did on the
    synchronous path.

``workers=0`` degrades to synchronous inline publishing (no threads),
which is also what `publish_window` offers standalone — the blocking
path (`VSSWriter(..., pipelined=False)`) uses it directly, so both
modes run the identical publish protocol.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Iterable, List, Optional, Set, Tuple

from repro_torch.obs.trace import span

DEFAULT_QUEUE_GOPS = 32
DEFAULT_WORKERS = 2


@dataclasses.dataclass
class PublishWindow:
    """One batch of encoded GOPs plus the rows that will index them.

    ``items`` are (object key, serialized payload) pairs for
    ``backend.batch_put``; ``rows`` are (physical_id, idx, start_frame,
    num_frames, nbytes, key) tuples — the LRU tick is stamped at index
    time — with an optional trailing JSON tile-size list for GOPs of a
    tiled physical video (whose window carries one item per tile but
    still indexes one row per GOP).  ``t_end`` is where this window
    pushes the physical video's prefix-visibility horizon once
    indexed."""

    pid: int
    items: List[Tuple[str, bytes]]
    rows: List[tuple]
    t_end: float

    @property
    def num_gops(self) -> int:
        return len(self.items)

    @property
    def nbytes(self) -> int:
        return sum(len(d) for _, d in self.items)


def publish_window(backend, catalog, window: PublishWindow) -> None:
    """Publish-then-index one window: every object in the window is
    durable (atomic per-object puts, fanned out by sharded backends)
    before any catalog row references it, then the whole window indexes
    in ONE transaction and the prefix horizon advances.  Used verbatim
    by the pipeline workers and by the blocking writer path."""
    with span("vss.ingest.publish", parent=None):
        backend.batch_put(window.items)
        # a write-back tier acknowledges batch_put at hot-admit speed;
        # source-of-truth ingest must not index rows whose bytes exist
        # only in a volatile cache — land THIS window's objects first
        # (scoped: no-op for write-through, and other writers' queued
        # uploads are not billed to this window's barrier)
        backend.ensure_durable([key for key, _data in window.items])
        tick = catalog.lru_clock()
        catalog.add_gops(
            [tuple(row[:6]) + (tick,) + tuple(row[6:])
             for row in window.rows],
            return_ids=False,
        )
        catalog.extend_physical_time(window.pid, window.t_end)


@dataclasses.dataclass
class IngestStats:
    """Pipeline counters (monotonic except ``queued_gops``)."""

    windows_submitted: int = 0
    windows_published: int = 0
    gops_submitted: int = 0
    gops_published: int = 0
    bytes_published: int = 0
    backpressure_waits: int = 0     # submits that blocked on the bound
    max_queued_gops: int = 0        # high-water mark of the queue
    queued_gops: int = 0            # snapshot: queued + in flight now
    errors: int = 0                 # failed windows
    gops_dropped_after_error: int = 0  # queued GOPs discarded behind one


class IngestChannel:
    """A writer's FIFO lane through the shared pipeline.  Not created
    directly — ask `IngestPipeline.channel`."""

    __slots__ = ("name", "pending", "in_flight", "queued", "error",
                 "submitted", "settled")

    def __init__(self, name: str):
        self.name = name
        self.pending: Deque[PublishWindow] = collections.deque()
        self.in_flight = False   # a worker is publishing one window
        self.queued = False      # sitting in the pipeline's ready list
        self.error: Optional[BaseException] = None
        # window counters for snapshot barriers: a window is *settled*
        # once it published, failed, or was discarded behind a failure
        self.submitted = 0
        self.settled = 0


class IngestPipeline:
    """Bounded publish queue + worker pool shared by a store's writers."""

    def __init__(
        self,
        backend,
        catalog,
        *,
        workers: int = DEFAULT_WORKERS,
        queue_gops: int = DEFAULT_QUEUE_GOPS,
        registry=None,
    ):
        if queue_gops < 1:
            raise ValueError(f"queue_gops must be >= 1, got {queue_gops}")
        self.backend = backend
        self.catalog = catalog
        self.queue_gops = queue_gops
        self._cv = threading.Condition()
        self._ready: Deque[IngestChannel] = collections.deque()
        self._active: Set[IngestChannel] = set()  # pending or in flight
        # queue depth / high-water mark stay plain ints: the
        # backpressure predicate reads them under _cv, and they are
        # state, not monotone counters.  Everything monotone lives in
        # per-instance repro_torch.obs registry handles — `stats()` is a
        # snapshot view over them, and /metrics sees the same counts.
        self._queued_gops = 0
        self._max_queued_gops = 0
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._c_win_sub = reg.counter(
            "vss_ingest_windows_submitted_total", "publish windows queued")
        self._c_win_pub = reg.counter(
            "vss_ingest_windows_published_total",
            "publish windows durable and indexed")
        self._c_gop_sub = reg.counter(
            "vss_ingest_gops_submitted_total", "GOPs queued")
        self._c_gop_pub = reg.counter(
            "vss_ingest_gops_published_total", "GOPs durable and indexed")
        self._c_bytes_pub = reg.counter(
            "vss_ingest_bytes_published_total", "payload bytes published")
        self._c_backpressure = reg.counter(
            "vss_ingest_backpressure_waits_total",
            "submits that blocked on the queue bound")
        self._c_errors = reg.counter(
            "vss_ingest_errors_total", "failed publish windows")
        self._c_dropped = reg.counter(
            "vss_ingest_gops_dropped_after_error_total",
            "queued GOPs discarded behind a failed window")
        reg.gauge_fn("vss_ingest_queued_gops", self._queued_now,
                     "GOPs queued or in flight right now")
        self._stop = False
        self._paused = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"vss-ingest-{i}")
            for i in range(max(0, int(workers)))
        ]
        for t in self._threads:
            t.start()

    def _queued_now(self) -> float:
        return self._queued_gops

    def workers_alive(self) -> int:
        """Live worker threads (0 for a synchronous ``workers=0``
        pipeline) — `VSS.health` checks this against the queue depth."""
        return sum(1 for t in self._threads if t.is_alive())

    @property
    def configured_workers(self) -> int:
        return len(self._threads)

    # -- producer side -----------------------------------------------------
    def channel(self, name: str) -> IngestChannel:
        """A new FIFO lane for one writer on logical video ``name``."""
        return IngestChannel(name)

    def submit(self, ch: IngestChannel, window: PublishWindow) -> None:
        """Queue one window; blocks while the pipeline is at capacity
        (backpressure).  Raises the channel's stored error instead of
        queueing behind a failed window."""
        if not self._threads:  # workers=0: synchronous inline publish
            if ch.error is not None:
                raise ch.error
            try:
                publish_window(self.backend, self.catalog, window)
            except BaseException as exc:
                ch.error = exc
                with self._cv:
                    self._c_errors.inc()
                    ch.submitted += 1
                    ch.settled += 1
                raise
            with self._cv:
                self._count_submit(window)
                ch.submitted += 1
                ch.settled += 1
                self._count_published(window)
            return
        def full() -> bool:
            return (
                not self._stop
                and self._queued_gops > 0
                and self._queued_gops + window.num_gops > self.queue_gops
            )

        with self._cv:
            if ch.error is not None:
                raise ch.error
            if full():
                self._c_backpressure.inc()
                with span("vss.ingest.backpressure", parent=None):
                    while full():
                        self._cv.wait()
            if self._stop:
                raise RuntimeError("ingest pipeline is closed")
            if ch.error is not None:
                raise ch.error
            self._count_submit(window)
            ch.submitted += 1
            ch.pending.append(window)
            self._active.add(ch)
            if not ch.in_flight and not ch.queued:
                ch.queued = True
                self._ready.append(ch)
            self._cv.notify_all()

    def _count_submit(self, window: PublishWindow) -> None:
        self._c_win_sub.inc()
        self._c_gop_sub.inc(window.num_gops)
        self._queued_gops += window.num_gops
        self._max_queued_gops = max(
            self._max_queued_gops, self._queued_gops
        )

    def _count_published(self, window: PublishWindow) -> None:
        self._c_win_pub.inc()
        self._c_gop_pub.inc(window.num_gops)
        self._c_bytes_pub.inc(window.nbytes)
        self._queued_gops -= window.num_gops

    # -- barriers ----------------------------------------------------------
    def flush(self, ch: IngestChannel) -> None:
        """Durability barrier for one writer: returns when every window
        the channel submitted is durable and indexed; re-raises the
        channel's error if any window failed."""
        with self._cv:
            while ch.pending or ch.in_flight:
                self._cv.wait()
            if ch.error is not None:
                raise ch.error

    def barrier(self, names: Iterable[str]) -> None:
        """Wait until every window *already submitted* for the given
        logical videos has settled (read-your-writes for prefix reads).
        The wait is against a snapshot — windows a still-appending
        writer submits after the barrier began don't extend it, so a
        continuously-ingesting camera can never starve a concurrent
        read.  Never raises — a writer's failure is the writer's to
        report."""
        names = set(names)
        with self._cv:
            targets = [
                (ch, ch.submitted) for ch in self._active
                if ch.name in names
            ]
            while any(ch.settled < goal for ch, goal in targets):
                self._cv.wait()

    def drain(self) -> None:
        """Wait for ALL queued work across every channel."""
        with self._cv:
            while self._active:
                self._cv.wait()

    # -- test/ops seams ----------------------------------------------------
    def pause(self) -> None:
        """Stop workers from picking up new windows (in-flight ones
        finish).  While paused, `flush`/`barrier`/`drain` on non-empty
        channels block — resume before reading.  Crash-recovery tests
        use this to freeze queued-but-unpublished windows."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def resize(
        self,
        *,
        workers: Optional[int] = None,
        queue_gops: Optional[int] = None,
    ) -> None:
        """Grow the pipeline at runtime — the adaptive policy's
        auto-sizing seam.  The worker pool only grows (a shrink request
        is ignored: retiring a thread mid-publish buys nothing and
        complicates the error protocol); the queue bound may move in
        either direction, waking blocked submitters when it grows.  A
        ``workers=0`` pipeline is synchronous by construction and stays
        that way."""
        with self._cv:
            if self._stop:
                return
            if queue_gops is not None:
                if queue_gops < 1:
                    raise ValueError(
                        f"queue_gops must be >= 1, got {queue_gops}")
                self.queue_gops = queue_gops
            if workers is not None and self._threads:
                grow = int(workers) - len(self._threads)
                for _ in range(max(0, grow)):
                    t = threading.Thread(
                        target=self._worker, daemon=True,
                        name=f"vss-ingest-{len(self._threads)}",
                    )
                    self._threads.append(t)
                    t.start()
            self._cv.notify_all()

    def stats(self) -> IngestStats:
        with self._cv:
            return IngestStats(
                windows_submitted=int(self._c_win_sub.value),
                windows_published=int(self._c_win_pub.value),
                gops_submitted=int(self._c_gop_sub.value),
                gops_published=int(self._c_gop_pub.value),
                bytes_published=int(self._c_bytes_pub.value),
                backpressure_waits=int(self._c_backpressure.value),
                max_queued_gops=self._max_queued_gops,
                queued_gops=self._queued_gops,
                errors=int(self._c_errors.value),
                gops_dropped_after_error=int(self._c_dropped.value),
            )

    # -- worker side -------------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (self._paused or not self._ready):
                    self._cv.wait()
                if self._stop:
                    return
                ch = self._ready.popleft()
                ch.queued = False
                window = ch.pending.popleft()
                ch.in_flight = True
            err: Optional[BaseException] = None
            try:
                publish_window(self.backend, self.catalog, window)
            except BaseException as exc:  # propagate to the owning writer
                err = exc
            with self._cv:
                ch.in_flight = False
                ch.settled += 1
                if err is not None:
                    ch.error = err
                    self._c_errors.inc()
                    self._queued_gops -= window.num_gops
                    # discard the channel's queue: indexing windows past
                    # a failed one would advance the prefix horizon over
                    # a hole.  The writer re-raises on its next call.
                    dropped = sum(w.num_gops for w in ch.pending)
                    self._c_dropped.inc(dropped)
                    self._queued_gops -= dropped
                    ch.settled += len(ch.pending)
                    ch.pending.clear()
                    if ch.queued:
                        self._ready.remove(ch)
                        ch.queued = False
                else:
                    self._count_published(window)
                if ch.pending:
                    if not ch.queued:
                        ch.queued = True
                        self._ready.append(ch)
                else:
                    if not ch.in_flight:
                        self._active.discard(ch)
                self._cv.notify_all()

    def close(self) -> None:
        """Stop the workers.  Does NOT drain — call `drain` first if
        queued windows must land (VSS.close does)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
