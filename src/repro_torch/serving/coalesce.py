"""Request coalescing: many concurrent HTTP reads, one joint plan.

This is where the §3 multi-request planner finally pays off *across
clients*: handler threads enqueue ``(ReadSpec, Future)`` pairs, and a
single dispatcher thread drains the queue in batches — every request
that arrived within one intake window (or piled up while the previous
batch executed, the natural batching regime under load) is planned and
executed through ONE ``VSS.read_batch`` call.  Overlapping requests
share joint plans, deduped GOP fetches, and single decodes exactly as
in-process batch callers do.

Deadline shedding happens here, at dispatch: a request whose
``deadline_ms`` budget (measured from arrival) is already spent gets
`DeadlineExceeded` instead of burning planner and I/O work on an
answer its client has abandoned.  Requests that survive dispatch run
to completion — a deadline is an admission contract, not an execution
abort.

A failing spec must not poison its batchmates: ``read_batch`` raises
on the first failing spec, so on batch failure the dispatcher falls
back to per-request execution, isolating the error to the request that
caused it (everyone else just loses the coalescing win for that round).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

from repro_torch.core.spec import ReadSpec

DEFAULT_INTAKE_WINDOW_S = 0.004
DEFAULT_MAX_BATCH = 64

COALESCE_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0,
                    32.0, 48.0, 64.0, 96.0, 128.0)


class DeadlineExceeded(Exception):
    """The request's deadline budget was spent before dispatch."""

    def __init__(self, waited_s: float, deadline_ms: float):
        super().__init__(
            f"deadline {deadline_ms:.0f}ms exceeded after"
            f" {waited_s * 1000:.0f}ms in queue"
        )
        self.waited_s = waited_s
        self.deadline_ms = deadline_ms


class _Pending:
    __slots__ = ("spec", "future", "arrival")

    def __init__(self, spec: ReadSpec, future: Future, arrival: float):
        self.spec = spec
        self.future = future
        self.arrival = arrival


class BatchCoalescer:
    """Single-dispatcher batching executor over one ``VSS`` handle.

    ``submit`` never blocks beyond a queue append; the returned Future
    resolves to the request's ``ReadResult`` (or raises).  ``window_s``
    bounds how long the dispatcher waits for company after the first
    request of a batch; ``max_batch`` bounds batch width.  With
    ``window_s=0`` and ``max_batch=1`` this degrades to per-request
    sequential serving — the benchmark control.
    """

    def __init__(
        self,
        vss,
        *,
        window_s: float = DEFAULT_INTAKE_WINDOW_S,
        max_batch: int = DEFAULT_MAX_BATCH,
        registry=None,
    ):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        from repro_torch.obs.registry import default_registry

        self.vss = vss
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._closed = threading.Event()
        reg = registry or default_registry()
        self._h_width = reg.histogram(
            "vss_serve_coalesce_width",
            "requests per dispatched read_batch", buckets=COALESCE_BUCKETS)
        self._c_batches = reg.counter(
            "vss_serve_batches_total", "dispatched coalesced batches")
        self._c_fallback = reg.counter(
            "vss_serve_batch_fallbacks_total",
            "batches re-run per-request because one spec failed")
        self._c_deadline_shed = reg.counter(
            "vss_serve_shed_total", "requests shed", {"reason": "deadline"})
        self._h_queue_wait = reg.histogram(
            "vss_serve_queue_wait_seconds",
            "arrival-to-dispatch wait of executed requests")
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="vss-serve-batch"
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def submit(self, spec: ReadSpec,
               arrival: Optional[float] = None) -> Future:
        if self._closed.is_set():
            raise RuntimeError("coalescer is closed")
        fut: Future = Future()
        self._queue.put(
            _Pending(spec, fut, time.monotonic() if arrival is None
                     else arrival)
        )
        return fut

    # -- dispatcher --------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        """Block for the first request, then keep collecting until the
        intake window closes or the batch is full.  ``None`` is the
        shutdown sentinel."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        horizon = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            timeout = horizon - time.monotonic()
            if timeout <= 0:
                # window over — but never leave already-arrived requests
                # behind: they would wait a full extra batch for nothing
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
            if nxt is None:
                self._queue.put(None)  # re-post for the outer loop
                break
            batch.append(nxt)
        return batch

    def _shed_expired(self, batch: List[_Pending]) -> List[_Pending]:
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            waited = now - p.arrival
            d = p.spec.deadline_ms
            if d is not None and waited * 1000.0 > d:
                self._c_deadline_shed.inc()
                p.future.set_exception(DeadlineExceeded(waited, d))
            else:
                live.append(p)
        return live

    def _execute(self, batch: Sequence[_Pending]) -> None:
        specs = [p.spec for p in batch]
        try:
            results = self.vss.read_batch(specs)
        except Exception:
            # one bad spec poisons a joint batch — isolate it by
            # degrading this round to per-request execution
            self._c_fallback.inc()
            for p in batch:
                try:
                    p.future.set_result(self.vss.read_batch([p.spec])[0])
                except Exception as exc:  # noqa: BLE001 - per-request fault
                    p.future.set_exception(exc)
            return
        for p, r in zip(batch, results):
            p.future.set_result(r)

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            batch = self._collect()
            if not batch:
                if self._closed.is_set():
                    return
                continue
            batch = self._shed_expired(batch)
            if not batch:
                continue
            self._c_batches.inc()
            self._h_width.observe(len(batch))
            now = time.monotonic()
            for p in batch:
                self._h_queue_wait.observe(now - p.arrival)
            self._execute(batch)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        """Stop the dispatcher; queued requests fail fast."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._queue.put(None)
        self._thread.join(timeout=5.0)
        # fail anything still queued (handler threads must not hang)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None and not p.future.done():
                p.future.set_exception(RuntimeError("service shutting down"))
