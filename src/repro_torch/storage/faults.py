"""Fault injection at the `StorageBackend` seam — shared test/chaos
infrastructure.

`FaultInjectingBackend` wraps any backend and perturbs its operations
from a **seeded** RNG, so every chaos run is reproducible from its
seed: injectable latency, transient error rates, torn writes (the
object lands truncated AND the put raises — a non-atomic device dying
mid-write), and hang-then-recover (operations block until ``resume``).
The same wrapper serves every layer that needs weather:

  * behind the bundled `ObjectServer` it turns store failures into the
    5xx responses `RemoteBackend`'s retry/backoff path must absorb;
  * as a `ReplicatedBackend` child it drives the quorum/fallback/scrub
    machinery (a torn replica, a child that hangs mid-batch);
  * around a whole backend it chaos-tests the §2 pipeline end to end.

Determinism: the RNG is consumed under a lock in operation order, so a
single-threaded op sequence replays bit-identically for a given seed.
``fail_next(n)`` forces the next ``n`` faultable operations to fail
regardless of ``error_rate`` — for tests that need "exactly two
transient failures, then clean".

The wrapper is transparent when idle: zero rates and zero latency make
every operation a pure delegate (it runs in the conformance matrix
that way, proving the wrapper itself preserves the contract).
``batch_get``/``batch_put`` deliberately run through the base-class
per-object loop so each object is an independent fault point.
"""
from __future__ import annotations

import random
import threading
import time
from typing import List

from repro_torch.storage.base import ObjectStat, StorageBackend


class InjectedFault(IOError):
    """The error a `FaultInjectingBackend` raises (never organic)."""


class FaultInjectingBackend(StorageBackend):
    def __init__(
        self,
        inner: StorageBackend,
        *,
        seed: int = 0,
        error_rate: float = 0.0,
        torn_write_rate: float = 0.0,
        latency: float = 0.0,
        latency_spike: float = 0.0,
        latency_spike_rate: float = 0.0,
        registry=None,
    ):
        if not 0.0 <= error_rate <= 1.0:
            raise ValueError(f"error_rate must be in [0,1], got {error_rate}")
        if not 0.0 <= torn_write_rate <= 1.0:
            raise ValueError(
                f"torn_write_rate must be in [0,1], got {torn_write_rate}"
            )
        if not 0.0 <= latency_spike_rate <= 1.0:
            raise ValueError(
                f"latency_spike_rate must be in [0,1],"
                f" got {latency_spike_rate}"
            )
        self.inner = inner
        self.error_rate = error_rate
        self.torn_write_rate = torn_write_rate
        self.latency = latency  # mean injected delay, seconds
        # heavy-tail mode: a latency_spike_rate fraction of operations
        # sleep a flat latency_spike seconds ON TOP of the uniform
        # delay — the bimodal profile of a GC pause / slow replica /
        # congested link, i.e. exactly the tail that request hedging
        # (RemoteBackend.hedge_threshold) exists to cut
        self.latency_spike = latency_spike
        self.latency_spike_rate = latency_spike_rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._forced_failures = 0
        self._hung = threading.Event()
        self._hung.set()  # set == running; cleared == hung
        # observability: chaos tests assert against `ops`/
        # `injected_errors`/`injected_torn`, which are views over
        # per-instance repro_torch.obs registry handles (one source of truth
        # with /metrics)
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._c_ops = reg.counter(
            "vss_fault_ops_total", "operations through the fault wrapper")
        self._c_errors = reg.counter(
            "vss_fault_injected_total", "injected faults",
            {"fault": "error"})
        self._c_torn = reg.counter(
            "vss_fault_injected_total", "injected faults",
            {"fault": "torn"})
        self.fault_log: List[str] = []  # "<op> <kind>" per injection

    @property
    def ops(self) -> int:
        return int(self._c_ops.value)

    @property
    def injected_errors(self) -> int:
        return int(self._c_errors.value)

    @property
    def injected_torn(self) -> int:
        return int(self._c_torn.value)

    # -- controls ----------------------------------------------------------
    def fail_next(self, n: int = 1) -> None:
        """Force the next ``n`` faultable operations to raise."""
        with self._lock:
            self._forced_failures += n

    def hang(self) -> None:
        """Stall every subsequent operation until `resume` — a device
        that stops answering without erroring."""
        self._hung.clear()

    def resume(self) -> None:
        self._hung.set()

    # -- fault engine ------------------------------------------------------
    def _pre(self, op: str, key: str = "") -> None:
        """Runs before every delegated operation: hang gate, injected
        latency, then forced/random transient errors."""
        self._hung.wait()
        with self._lock:
            self._c_ops.inc()
            delay = (
                self._rng.uniform(0.0, 2.0 * self.latency)
                if self.latency > 0 else 0.0
            )
            if (self.latency_spike_rate > 0
                    and self._rng.random() < self.latency_spike_rate):
                delay += self.latency_spike
            if self._forced_failures > 0:
                self._forced_failures -= 1
                fail = True
            else:
                fail = (self.error_rate > 0
                        and self._rng.random() < self.error_rate)
            if fail:
                self._c_errors.inc()
                self.fault_log.append(f"{op} error {key}".rstrip())
        if delay:
            time.sleep(delay)
        if fail:
            raise InjectedFault(f"injected {op} failure for {key!r}")

    def _tear(self, op: str, key: str) -> bool:
        with self._lock:
            torn = (self.torn_write_rate > 0
                    and self._rng.random() < self.torn_write_rate)
            if torn:
                self._c_torn.inc()
                self.fault_log.append(f"{op} torn {key}")
        return torn

    # -- contract ----------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        self._pre("put", key)
        if self._tear("put", key):
            # a non-atomic device dying mid-write: truncated bytes land
            # under the live key AND the caller sees a failure (it must
            # not index the object) — the scrubber's repair case
            self.inner.put(key, bytes(data[: max(1, len(data) // 2)]))
            raise InjectedFault(f"torn write for {key!r}")
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        self._pre("get", key)
        return self.inner.get(key)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        self._pre("get_range", key)
        return self.inner.get_range(key, start, length)

    def delete(self, key: str) -> None:
        self._pre("delete", key)
        self.inner.delete(key)

    def stat(self, key: str) -> ObjectStat:
        self._pre("stat", key)
        return self.inner.stat(key)

    def list(self, prefix: str = "") -> List[str]:
        self._pre("list", prefix)
        return self.inner.list(prefix)

    # batch_get/batch_put intentionally NOT delegated to the inner
    # fan-out: the base-class loops make every object its own fault
    # point (a mid-batch failure, not an all-or-nothing one)

    # -- transparent plumbing ----------------------------------------------
    def kind_for(self, key: str) -> str:
        return self.inner.kind_for(key)

    def exists(self, key: str) -> bool:
        # probes stay fault-free: recovery/scrub existence checks must
        # observe the store, not the weather (a flaky probe would turn
        # chaos tests' bookkeeping nondeterministic)
        return self.inner.exists(key)

    def sweep_temps(self) -> int:
        return self.inner.sweep_temps()

    def layout_fingerprint(self) -> str:
        return self.inner.layout_fingerprint()

    def recover(self, catalog):
        return self.inner.recover(catalog)

    def scrub(self, catalog, *, collect_orphans: bool = False):
        return self.inner.scrub(catalog, collect_orphans=collect_orphans)

    def configure_concurrency(self, n: int) -> None:
        self.inner.configure_concurrency(n)

    def ensure_durable(self, keys=None) -> None:
        self.inner.ensure_durable(keys)

    def calibration_targets(self):
        # calibration must measure the wrapped store's real kind — not
        # file weather-polluted numbers under the wrapper's "default"
        return self.inner.calibration_targets()

    def close(self) -> None:
        self.resume()  # never leave a hung thread behind
        self.inner.close()
