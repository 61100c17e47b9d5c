"""Unified telemetry for VSS: metrics registry, read-path tracing, and
exposition helpers.

- `MetricsRegistry` / `default_registry` — counters, gauges, fixed-
  bucket histograms; exact per-component handles summed into process-
  wide series (``registry.py``).
- `Tracer` / `Span` — per-`ReadSpec` plan→fetch→decode→admit span
  trees with ring-buffer retention (``trace.py``).
- `InstrumentedBackend` / `instrument_backend` — per-backend-kind op
  latency/bytes/error metrics, auto-applied by
  ``repro_torch.storage.make_backend`` (``instrument.py``).
- ``python -m repro_torch.obs.dump`` — offline snapshots of a live
  ``/metrics``+``/healthz`` endpoint or of this process' registry.

Set ``VSS_TELEMETRY=0`` to disable the default registry process-wide
(no-op handles, no instrumentation wrappers)."""

from repro_torch.obs.registry import (
    ENV_TELEMETRY,
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.obs.trace import DEFAULT_TRACE_CAPACITY, Span, Tracer
from repro_torch.obs.instrument import InstrumentedBackend, instrument_backend

__all__ = [
    "ENV_TELEMETRY",
    "LATENCY_BUCKETS",
    "SIZE_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "DEFAULT_TRACE_CAPACITY",
    "Span",
    "Tracer",
    "InstrumentedBackend",
    "instrument_backend",
]
