"""Admission control and deadline QoS for the serving tier.

The serving front end must stay honest under overload: rather than
queueing without bound (latency collapse for everyone), it sheds load
*early* with a 503 + ``Retry-After`` so well-behaved clients back off.
Three independent limits compose, checked in order at intake:

  * **per-tenant token bucket** — each tenant (the ``X-VSS-Tenant``
    header) owns a bucket refilled at ``tenant_rate`` requests/second
    with ``tenant_burst`` capacity, so one chatty tenant exhausts its
    own budget instead of starving the others;
  * **queue depth** — a global cap on requests admitted but not yet
    answered (queued + executing); beyond it the dispatcher is already
    saturated and more queueing only adds latency;
  * **in-flight bytes** — a cap on result payload bytes the service is
    currently holding for delivery (materialized segments awaiting
    their signed-URL GETs); the memory honesty bound.

A denial never raises through the HTTP layer — `AdmissionController`
returns a `Denial` carrying the machine-readable reason and the
``Retry-After`` hint (time until the failing limit plausibly clears).

Deadlines ride separately: a request may declare ``deadline_ms`` (time
budget from arrival).  The coalescer sheds requests whose budget is
already spent at dispatch time — executing them would waste planner
and I/O work on an answer the client has abandoned — and `read_batch`
orders execution within a plan group by (priority, earliest deadline).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

DEFAULT_TENANT = "default"

# intake denial reasons (the X-VSS-Shed-Reason header + shed metric label)
REASON_TENANT_RATE = "tenant-rate"
REASON_QUEUE_DEPTH = "queue-depth"
REASON_INFLIGHT_BYTES = "inflight-bytes"
REASON_DEADLINE = "deadline"


@dataclasses.dataclass(frozen=True)
class Denial:
    """One shed decision: why, and when retrying could succeed."""

    reason: str
    retry_after_s: float


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second, ``burst`` capacity,
    starts full.  ``try_acquire`` is non-blocking; on failure it reports
    how long until one token accrues (the Retry-After hint)."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be positive, got"
                             f" {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate
        )
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> Optional[float]:
        """Take ``n`` tokens; returns None on success, else seconds
        until the bucket would hold ``n`` tokens again."""
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return None
            return (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens


class AdmissionController:
    """Composes the three intake limits; tracks in-flight state.

    ``admit(tenant)`` is the intake gate; every admitted request MUST
    eventually call ``release()`` exactly once (the serving tier does so
    when the response is written or the request is shed post-admission).
    ``hold_bytes``/``drop_bytes`` track result payloads parked for
    signed-URL delivery.  All gauges live in the ``repro_torch.obs`` registry
    so ``/metrics`` exposes per-tenant quota state directly.
    """

    def __init__(
        self,
        *,
        queue_limit: int = 64,
        inflight_bytes_limit: int = 256 * 1024 * 1024,
        tenant_rate: float = 200.0,
        tenant_burst: float = 400.0,
        registry=None,
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if inflight_bytes_limit < 1:
            raise ValueError("inflight_bytes_limit must be >= 1")
        from repro_torch.obs.registry import default_registry

        self.queue_limit = int(queue_limit)
        self.inflight_bytes_limit = int(inflight_bytes_limit)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._in_flight = 0
        self._held_bytes = 0
        reg = registry or default_registry()
        self._registry = reg
        self._g_queue = reg.gauge(
            "vss_serve_queue_depth",
            "requests admitted but not yet answered")
        self._g_bytes = reg.gauge(
            "vss_serve_inflight_bytes",
            "result payload bytes held for signed-URL delivery")
        self._c_admitted = reg.counter(
            "vss_serve_admitted_total", "requests past the admission gate")
        self._tenant_gauges: Dict[str, object] = {}

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = TokenBucket(self.tenant_rate, self.tenant_burst)
                self._buckets[tenant] = b
                # live per-tenant quota gauge: reads the bucket at
                # scrape time, no bookkeeping on the request path
                self._tenant_gauges[tenant] = self._registry.gauge_fn(
                    "vss_serve_tenant_tokens",
                    lambda b=b: b.tokens,
                    "admission tokens currently available per tenant",
                    {"tenant": tenant},
                )
            return b

    # -- intake gate -------------------------------------------------------
    def admit(self, tenant: str = DEFAULT_TENANT) -> Optional[Denial]:
        """Returns None (admitted — caller owes one ``release()``) or a
        `Denial`.  Checks cheapest-and-fairest first: the tenant's own
        budget, then the shared queue, then the byte bound."""
        retry = self._bucket(tenant).try_acquire()
        if retry is not None:
            return Denial(REASON_TENANT_RATE, retry)
        with self._lock:
            if self._in_flight >= self.queue_limit:
                return Denial(REASON_QUEUE_DEPTH, 1.0)
            if self._held_bytes >= self.inflight_bytes_limit:
                return Denial(REASON_INFLIGHT_BYTES, 2.0)
            self._in_flight += 1
        self._g_queue.inc()
        self._c_admitted.inc()
        return None

    def release(self) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
        self._g_queue.dec()

    # -- held result bytes -------------------------------------------------
    def hold_bytes(self, n: int) -> None:
        with self._lock:
            self._held_bytes += int(n)
        self._g_bytes.inc(int(n))

    def drop_bytes(self, n: int) -> None:
        with self._lock:
            self._held_bytes = max(0, self._held_bytes - int(n))
        self._g_bytes.dec(int(n))

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    @property
    def held_bytes(self) -> int:
        with self._lock:
            return self._held_bytes
