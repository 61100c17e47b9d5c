"""`InstrumentedBackend`: per-op latency/bytes/error telemetry for any
`StorageBackend`, reported under the wrapped backend's ``kind``.

``make_backend`` applies this at *every* level of a composed spec —
``tiered:remote`` yields ``Instrumented(Tiered(cold=
Instrumented(Remote)))`` — so the cold tier's real network ops and the
wrapper-level cache ops each show up under their own kind, which is
exactly the layered accounting a tiering decision needs.

When the registry is disabled, `instrument_backend` returns the inner
backend unchanged: the disabled-telemetry hot path has zero wrapper
frames, which is what the overhead-guard test pins down."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.registry import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    MetricsRegistry,
    default_registry,
)
from repro_torch.storage.base import ObjectNotFound, ObjectStat, StorageBackend

_OPS = (
    "put", "get", "get_range", "delete", "stat", "list", "batch_get",
    "batch_get_ranges", "batch_put", "exists", "ensure_durable",
)

M_OPS = "vss_backend_ops_total"
M_ERRORS = "vss_backend_op_errors_total"
M_SECONDS = "vss_backend_op_seconds"
M_BYTES = "vss_backend_op_bytes"


class InstrumentedBackend(StorageBackend):
    """Delegating wrapper; every data-plane op records latency, object
    sizes, and error counts under ``{kind, op}`` labels.

    ``ObjectNotFound`` counts as a completed op, not an error — a miss
    is a protocol answer (the tiered/replicated layers *rely* on it),
    while the error counter flags genuinely failed I/O."""

    def __init__(self, inner: StorageBackend, *, kind: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.inner = inner
        self.kind = kind or getattr(inner, "KIND", None) or (
            type(inner).__name__.lower()
        )
        self.KIND = self.kind
        reg = registry or default_registry()
        self._ops: Dict[str, object] = {}
        self._errs: Dict[str, object] = {}
        self._secs: Dict[str, object] = {}
        self._bytes: Dict[str, object] = {}
        for op in _OPS:
            labels = {"kind": self.kind, "op": op}
            self._ops[op] = reg.counter(
                M_OPS, "storage backend operations", labels)
            self._errs[op] = reg.counter(
                M_ERRORS, "failed storage backend operations", labels)
            self._secs[op] = reg.histogram(
                M_SECONDS, "storage backend operation latency", labels,
                buckets=LATENCY_BUCKETS)
            self._bytes[op] = reg.histogram(
                M_BYTES, "per-object payload sizes", labels,
                buckets=SIZE_BUCKETS)

    # -- timed data plane --------------------------------------------------
    def _run(self, op: str, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except ObjectNotFound:
            self._secs[op].observe(time.perf_counter() - t0)
            self._ops[op].inc()
            raise
        except Exception:
            self._secs[op].observe(time.perf_counter() - t0)
            self._ops[op].inc()
            self._errs[op].inc()
            raise
        self._secs[op].observe(time.perf_counter() - t0)
        self._ops[op].inc()
        return out

    def put(self, key: str, data: bytes) -> None:
        self._bytes["put"].observe(len(data))
        self._run("put", self.inner.put, key, data)

    def get(self, key: str) -> bytes:
        data = self._run("get", self.inner.get, key)
        self._bytes["get"].observe(len(data))
        return data

    def get_range(self, key: str, start: int, length: int) -> bytes:
        data = self._run("get_range", self.inner.get_range,
                         key, start, length)
        self._bytes["get_range"].observe(len(data))
        return data

    def batch_get_ranges(
        self, reqs: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        blobs = self._run(
            "batch_get_ranges", self.inner.batch_get_ranges, reqs)
        h = self._bytes["batch_get_ranges"]
        for b in blobs:
            h.observe(len(b))
        return blobs

    def delete(self, key: str) -> None:
        self._run("delete", self.inner.delete, key)

    def stat(self, key: str) -> ObjectStat:
        return self._run("stat", self.inner.stat, key)

    def list(self, prefix: str = "") -> List[str]:
        return self._run("list", self.inner.list, prefix)

    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        blobs = self._run("batch_get", self.inner.batch_get, keys)
        h = self._bytes["batch_get"]
        for b in blobs:
            h.observe(len(b))
        return blobs

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        h = self._bytes["batch_put"]
        for _k, data in items:
            h.observe(len(data))
        self._run("batch_put", self.inner.batch_put, items)

    def exists(self, key: str) -> bool:
        return self._run("exists", self.inner.exists, key)

    def ensure_durable(self, keys: Optional[Sequence[str]] = None) -> None:
        self._run("ensure_durable", self.inner.ensure_durable, keys)

    # -- untimed control plane (must not fall back to ABC defaults) --------
    def kind_for(self, key: str) -> str:
        return self.inner.kind_for(key)

    def sweep_temps(self) -> int:
        return self.inner.sweep_temps()

    def configure_concurrency(self, n: int) -> None:
        self.inner.configure_concurrency(n)

    def calibration_targets(self) -> Dict[str, StorageBackend]:
        return self.inner.calibration_targets()

    def layout_fingerprint(self) -> str:
        return self.inner.layout_fingerprint()

    def recover(self, catalog):
        return self.inner.recover(catalog)

    def scrub(self, catalog, *, collect_orphans: bool = False):
        return self.inner.scrub(catalog, collect_orphans=collect_orphans)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # backend-specific surface (``.fsync``, ``.volumes``,
        # ``.write_back``, ``.hot_keys``, ``.retries``, ...) passes
        # through so wrapping stays invisible to capability probes
        if name == "inner":  # not yet bound (mid-__init__/unpickle)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return f"InstrumentedBackend({self.inner!r})"


def instrument_backend(
    backend: StorageBackend, *, kind: Optional[str] = None,
    registry: Optional[MetricsRegistry] = None,
) -> StorageBackend:
    """Wrap ``backend`` with per-op telemetry — or return it untouched
    when the registry is disabled (zero overhead, no wrapper frame)."""
    reg = registry or default_registry()
    if not reg.enabled:
        return backend
    return InstrumentedBackend(backend, kind=kind, registry=reg)
