"""Dependency-free metrics registry (counters, gauges, histograms).

Design constraints, in order:

1. **Exact per-component views.**  Every component (a backend instance,
   an ingest pipeline, one ``VSS``) asks the registry for its own
   *handle*; a handle's ``value`` counts only what that instance did,
   so the legacy per-instance ``stats()`` shapes stay exact even when
   several stores share one process-global registry.
2. **Correct process-wide exposition.**  Handles created under the same
   ``(name, labels)`` attach to one shared *series*; ``/metrics``
   reports the sum over a series' handles, which is what a Prometheus
   scrape of the process should see.
3. **Near-zero overhead when disabled.**  A disabled registry hands out
   shared no-op singletons, and ``make_backend`` skips the
   instrumentation wrapper entirely, so the disabled cost on the
   storage hot path is exactly zero.
4. **Thread safety without one global hot lock.**  Handle increments
   take a per-handle lock drawn from a fixed stripe pool; the single
   registry lock guards only series creation (rare) and collection.

No external dependencies — exposition is hand-rendered Prometheus text
format (version 0.0.4)."""

from __future__ import annotations

import bisect
import json
import os
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

ENV_TELEMETRY = "VSS_TELEMETRY"
_OFF_VALUES = ("0", "false", "off", "no")

_STRIPES = 16

# Latency buckets: 100µs .. 10s, roughly log-spaced — wide enough for
# an in-memory dict get and a cross-network quorum read on one axis.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Size buckets: 256B .. 64MiB in powers of 4 — GOP objects span tiny
# metadata probes to multi-megabyte high-resolution groups.
SIZE_BUCKETS: Tuple[float, ...] = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
    1048576.0, 4194304.0, 16777216.0, 67108864.0,
)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotone per-handle counter."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Set/adjust per-handle gauge."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram (cumulative on render, like Prometheus).

    ``percentile(q)`` gives the usual bucket-interpolated estimate:
    exact to within one bucket's width, with the open-ended overflow
    bucket clamped to the maximum observed sample."""

    __slots__ = ("_lock", "edges", "_counts", "_sum", "_count", "_min", "_max")

    def __init__(self, lock: threading.Lock, edges: Sequence[float]):
        self._lock = lock
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram edges must be sorted/unique: {edges}")
        self._counts = [0] * (len(self.edges) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def counts(self) -> List[int]:
        """Per-bucket (non-cumulative) counts; last entry is +Inf."""
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate, q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total, lo, hi = self._count, self._min, self._max
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lower = self.edges[i - 1] if i > 0 else min(lo, self.edges[0])
                upper = self.edges[i] if i < len(self.edges) else hi
                lower = max(lower, lo)
                upper = min(upper, hi) if hi >= lower else upper
                frac = (target - cum) / c
                return lower + (upper - lower) * max(0.0, min(1.0, frac))
            cum += c
        return hi


class _NullCounter:
    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    sum = 0.0
    counts: List[int] = []
    edges: Tuple[float, ...] = ()

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class _Series:
    """All handles registered under one (name, labels) pair."""

    __slots__ = ("handles", "fns")

    def __init__(self):
        self.handles: List[object] = []
        self.fns: List[Callable[[], float]] = []

    def live_fns(self) -> List[Callable[[], float]]:
        out = []
        for f in self.fns:
            if isinstance(f, weakref.WeakMethod):
                m = f()
                if m is not None:
                    out.append(m)
            else:
                out.append(f)
        return out

    def scalar_value(self) -> float:
        v = sum(h.value for h in self.handles)
        for f in self.live_fns():
            try:
                v += float(f())
            except Exception:
                continue  # a dying component must not poison a scrape
        return v

    def hist_value(self, n_edges: int) -> Tuple[List[int], float, int]:
        counts = [0] * (n_edges + 1)
        total_sum, total_count = 0.0, 0
        for h in self.handles:
            hc = h.counts
            for i, c in enumerate(hc):
                counts[i] += c
            total_sum += h.sum
            total_count += h.count
        return counts, total_sum, total_count


class _Family:
    __slots__ = ("name", "type", "help", "edges", "series")

    def __init__(self, name: str, typ: str, help: str,
                 edges: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.type = typ
        self.help = help
        self.edges = edges
        self.series: Dict[Tuple[Tuple[str, str], ...], _Series] = {}


class MetricsRegistry:
    """Thread-safe counter/gauge/histogram registry; see module doc."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(_STRIPES)]
        self._next_stripe = 0
        self._families: Dict[str, _Family] = {}

    # -- handle creation ------------------------------------------------
    def _stripe(self) -> threading.Lock:
        with self._lock:
            lock = self._stripes[self._next_stripe % _STRIPES]
            self._next_stripe += 1
        return lock

    def _series(self, name: str, typ: str, help: str,
                labels: Optional[Dict[str, str]],
                edges: Optional[Tuple[float, ...]] = None) -> _Series:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, typ, help, edges)
                self._families[name] = fam
            else:
                if fam.type != typ:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.type},"
                        f" cannot re-register as {typ}"
                    )
                if edges is not None and fam.edges != edges:
                    raise ValueError(
                        f"histogram {name!r} already registered with"
                        f" buckets {fam.edges}, got {edges}"
                    )
                if help and not fam.help:
                    fam.help = help
            series = fam.series.get(key)
            if series is None:
                series = _Series()
                fam.series[key] = series
        return series

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        series = self._series(name, "counter", help, labels)
        h = Counter(self._stripe())
        series.handles.append(h)
        return h

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        series = self._series(name, "gauge", help, labels)
        h = Gauge(self._stripe())
        series.handles.append(h)
        return h

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "",
                 labels: Optional[Dict[str, str]] = None) -> None:
        """Callback gauge: ``fn`` is sampled at collection time.  Bound
        methods are held through a weakref so a registered component can
        be garbage-collected — its series simply stops contributing."""
        if not self.enabled:
            return
        series = self._series(name, "gauge", help, labels)
        if hasattr(fn, "__self__"):
            fn = weakref.WeakMethod(fn)
        series.fns.append(fn)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        edges = tuple(float(b) for b in buckets)
        series = self._series(name, "histogram", help, labels, edges)
        h = Histogram(self._stripe(), edges)
        series.handles.append(h)
        return h

    # -- collection -------------------------------------------------------
    def value(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        """Aggregated value of one series (counter/gauge: sum over
        handles; histogram: the merged ``_sum``)."""
        with self._lock:
            fam = self._families.get(name)
            series = fam.series.get(_label_key(labels)) if fam else None
        if series is None:
            return 0.0
        if fam.type == "histogram":
            _, s, _ = series.hist_value(len(fam.edges))
            return s
        return series.scalar_value()

    def histogram_values(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Tuple[List[int], float, int]:
        """Merged (bucket_counts, sum, count) for one histogram series."""
        with self._lock:
            fam = self._families.get(name)
            series = fam.series.get(_label_key(labels)) if fam else None
        if series is None or fam.type != "histogram":
            return [], 0.0, 0
        return series.hist_value(len(fam.edges))

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-serializable dump of every family and series."""
        with self._lock:
            families = [
                (f, list(f.series.items())) for f in self._families.values()
            ]
        out: Dict[str, Dict] = {}
        for fam, series_items in families:
            rows = []
            for key, series in series_items:
                labels = dict(key)
                if fam.type == "histogram":
                    counts, s, c = series.hist_value(len(fam.edges))
                    rows.append({
                        "labels": labels,
                        "buckets": [
                            [e, n] for e, n in zip(
                                list(fam.edges) + [float("inf")], counts
                            )
                        ],
                        "sum": s,
                        "count": c,
                    })
                else:
                    rows.append({
                        "labels": labels, "value": series.scalar_value(),
                    })
            out[fam.name] = {
                "type": fam.type, "help": fam.help, "series": rows,
            }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            families = [
                (f, list(f.series.items()))
                for f in sorted(self._families.values(), key=lambda f: f.name)
            ]
        lines: List[str] = []
        for fam, series_items in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for key, series in series_items:
                if fam.type == "histogram":
                    counts, s, c = series.hist_value(len(fam.edges))
                    cum = 0
                    for edge, n in zip(
                        list(fam.edges) + [float("inf")], counts
                    ):
                        cum += n
                        le = _fmt_labels(key, f'le="{_fmt_float(edge)}"')
                        lines.append(f"{fam.name}_bucket{le} {cum}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(key)} {_fmt_float(s)}"
                    )
                    lines.append(f"{fam.name}_count{_fmt_labels(key)} {c}")
                else:
                    v = series.scalar_value()
                    lines.append(
                        f"{fam.name}{_fmt_labels(key)} {_fmt_float(v)}"
                    )
        return "\n".join(lines) + "\n"

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, default=str)


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-global registry every component falls back to.

    Disabled (no-op handles, no instrumentation wrappers) when the
    ``VSS_TELEMETRY`` environment variable is ``0``/``false``/``off``/
    ``no`` at first use."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                enabled = (
                    os.environ.get(ENV_TELEMETRY, "1").strip().lower()
                    not in _OFF_VALUES
                )
                _default = MetricsRegistry(enabled=enabled)
    return _default
