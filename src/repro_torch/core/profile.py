"""Workload-adaptive format management: profile the reads, derive the
physical design.

VSS (§5) materializes derived views *reactively* — a view is cached
when a read happens to produce it.  VStore's argument (arxiv
1810.01794) is that a video store should instead derive its physical
formats *backward from the observed workload*, and EKO (arxiv
2104.01671) shows the same profile pays for placement decisions.  This
module adds both halves:

:class:`AccessProfiler`
    An online profile of the read stream, fed passively from the
    ``read_batch`` plan path (after spec resolution, before planning —
    it never alters a plan).  Two decayed-counter tables per video:

      * **view frequencies** — per resolved view configuration
        (codec, fps, roi, resolution, quality), how often that view is
        requested;
      * **interval heat** — per fixed-width video-time bucket, how
        recently/frequently that span of the video is read.

    Counters decay exponentially (half-life ``half_life_s``), so "hot"
    always means *recently* hot.  The profile persists next to the
    catalog (``<root>/profile.json``) and reloads on reopen — a
    restarted store keeps its learned workload.

:class:`AdaptivePolicy`
    Consumes the profile and drives four existing seams, all from one
    explicit ``run_once()`` tick (`VSS.adapt()`):

      1. **Materialization** — hot view configs are materialized over
         their uncovered intervals ahead of demand, by issuing an
         internal cached read through the normal admission machinery
         (`VSS._admit`): the first *user* read of freshly-ingested
         video in a popular format becomes a pass-through instead of a
         transcode.
      2. **Tier placement** — hot-interval GOP objects are promoted
         into a `TieredBackend`'s memory tier and cold epochs demoted;
         a heat-boosted priority function keeps hot objects at the
         back of the spill order continuously.
      3. **Deferred compression scheduling** — `DeferredCompressor`
         steps run opportunistically while the ingest pipeline is
         idle; when a video is over budget *during* live ingest the
         pipeline is paused around a short compression burst
         (`IngestPipeline.pause`/``resume``).
      4. **Ingest auto-sizing** — initial ``workers``/``queue_gops``
         are derived from the calibrated io_table
         (:func:`suggest_ingest_sizing`), and observed
         ``backpressure_waits`` growth triggers `IngestPipeline.resize`
         at runtime.

Everything here is advisory: with ``AdaptiveConfig.enabled`` False the
profiler still observes (cheap, and it keeps the profile warm for the
moment the policy is switched on) but reads are bit-identical to a
store without it — guaranteed by test_adaptive.py.
"""
from __future__ import annotations

import json
import math
import os
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.config import AdaptiveConfig
from repro_torch.core.spec import ReadSpec
from repro_torch.obs.registry import default_registry

PROFILE_FILENAME = "profile.json"
_PROFILE_VERSION = 1

# io_table latency (µs per object) above which ingest concurrency must
# grow to hide the per-window round trip
_LATENCY_MEDIUM_US = 1e4   # slower than a local fs: 4 workers
_LATENCY_HIGH_US = 1e5     # remote object store territory: 8 workers
_MAX_AUTO_WORKERS = 16
_MAX_AUTO_QUEUE = 512


def profile_path(root: str) -> str:
    return os.path.join(root, PROFILE_FILENAME)


def suggest_ingest_sizing(cost_model, backend) -> Tuple[int, int]:
    """(workers, queue_gops) sized from the calibrated io_table: the
    slower one publish round trip is, the more of them must be in
    flight to keep ingest at encode speed."""
    try:
        kind = backend.kind_for("")
    except Exception:
        kind = "default"
    table = getattr(cost_model, "io_table", None) or {}
    latency = table.get(kind, table.get("default", (2e3, 0.0)))[0]
    if latency >= _LATENCY_HIGH_US:
        workers = 8
    elif latency >= _LATENCY_MEDIUM_US:
        workers = 4
    else:
        workers = 2
    return workers, max(32, workers * 16)


def _decayed(score: float, last: float, now: float, half_life: float) -> float:
    if now <= last:
        return score
    return score * math.pow(0.5, (now - last) / half_life)


class AccessProfiler:
    """Decayed per-(video, view-config) frequencies + per-interval heat.

    Thread-safe; ``record`` is called from every ``read_batch`` and is
    a few dict operations.  ``suppress()`` hides the policy's own
    internal reads from the profile (a materialization read must not
    make its view look hotter)."""

    def __init__(
        self,
        path: Optional[str],
        *,
        half_life_s: float = 300.0,
        interval_s: float = 4.0,
        persist_every: int = 256,
        registry=None,
        clock=None,
    ):
        import time as _time

        self.path = path
        self.half_life_s = max(float(half_life_s), 1e-3)
        self.interval_s = max(float(interval_s), 1e-6)
        self.persist_every = max(int(persist_every), 1)
        self._clock = clock or _time.time
        self._lock = threading.Lock()
        self._local = threading.local()
        # name -> {view key: [score, last]};  view key =
        # (codec, fps, roi, resolution, quality_eps_db)
        self._views: Dict[str, Dict[tuple, List[float]]] = {}
        # name -> {bucket index: [score, last]}
        self._heat: Dict[str, Dict[int, List[float]]] = {}
        self._since_persist = 0
        reg = registry or default_registry()
        self._c_records = reg.counter(
            "vss_profiler_records_total",
            "reads recorded by the access profiler")
        self._c_persists = reg.counter(
            "vss_profiler_persists_total",
            "profile snapshots written to disk")
        reg.gauge_fn("vss_profiler_view_configs", self._views_now,
                     "distinct (video, view-config) pairs being tracked")
        reg.gauge_fn("vss_profiler_heat_buckets", self._buckets_now,
                     "interval-heat table size across videos")
        if self.path:
            self.load()

    # -- gauge samplers ----------------------------------------------------
    def _views_now(self) -> float:
        with self._lock:
            return float(sum(len(v) for v in self._views.values()))

    def _buckets_now(self) -> float:
        with self._lock:
            return float(sum(len(h) for h in self._heat.values()))

    # -- suppression (the policy's own reads) ------------------------------
    @contextmanager
    def suppress(self):
        n = getattr(self._local, "n", 0)
        self._local.n = n + 1
        try:
            yield
        finally:
            self._local.n = n

    def _suppressed(self) -> bool:
        return getattr(self._local, "n", 0) > 0

    # -- recording ---------------------------------------------------------
    @staticmethod
    def view_key(resolved) -> tuple:
        return (
            resolved.codec, resolved.fps, tuple(resolved.roi),
            tuple(resolved.resolution), resolved.spec.quality_eps_db,
        )

    def record_batch(self, resolved: Sequence[Any]) -> None:
        if self._suppressed() or not resolved:
            return
        now = self._clock()
        with self._lock:
            for r in resolved:
                self._record_locked(r, now)
            self._c_records.inc(len(resolved))
            self._since_persist += len(resolved)
            due = self._since_persist >= self.persist_every
            if due:
                self._since_persist = 0
        if due and self.path:
            self.save()

    def _record_locked(self, r, now: float) -> None:
        views = self._views.setdefault(r.name, {})
        cell = views.get(self.view_key(r))
        if cell is None:
            views[self.view_key(r)] = [1.0, now]
        else:
            cell[0] = _decayed(cell[0], cell[1], now, self.half_life_s) + 1.0
            cell[1] = now
        heat = self._heat.setdefault(r.name, {})
        iv = self.interval_s
        b0 = int(math.floor(r.s / iv))
        b1 = max(b0 + 1, int(math.ceil(r.e / iv)))
        for b in range(b0, b1):
            w = (min(r.e, (b + 1) * iv) - max(r.s, b * iv)) / iv
            w = min(max(w, 0.0), 1.0)
            if w <= 0.0:
                continue
            cell = heat.get(b)
            if cell is None:
                heat[b] = [w, now]
            else:
                cell[0] = _decayed(
                    cell[0], cell[1], now, self.half_life_s) + w
                cell[1] = now

    # -- queries -----------------------------------------------------------
    def video_names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._views) | set(self._heat))

    def hot_views(
        self, name: str, min_score: float, now: Optional[float] = None
    ) -> List[Tuple[tuple, float]]:
        """[(view key, decayed score)] at/above ``min_score``, hottest
        first."""
        now = self._clock() if now is None else now
        with self._lock:
            views = self._views.get(name, {})
            out = [
                (k, _decayed(c[0], c[1], now, self.half_life_s))
                for k, c in views.items()
            ]
        out = [(k, s) for k, s in out if s >= min_score]
        out.sort(key=lambda ks: -ks[1])
        return out

    def heat(
        self, name: str, t0: float, t1: float, now: Optional[float] = None
    ) -> float:
        """Peak decayed heat over the buckets overlapping [t0, t1)."""
        now = self._clock() if now is None else now
        iv = self.interval_s
        b0 = int(math.floor(t0 / iv))
        b1 = max(b0 + 1, int(math.ceil(t1 / iv)))
        peak = 0.0
        with self._lock:
            heat = self._heat.get(name, {})
            for b in range(b0, b1):
                cell = heat.get(b)
                if cell is not None:
                    peak = max(peak, _decayed(
                        cell[0], cell[1], now, self.half_life_s))
        return peak

    def bucket_scores(
        self, name: str, now: Optional[float] = None
    ) -> Dict[int, float]:
        now = self._clock() if now is None else now
        with self._lock:
            heat = self._heat.get(name, {})
            return {
                b: _decayed(c[0], c[1], now, self.half_life_s)
                for b, c in heat.items()
            }

    def bucket_span(self, b: int) -> Tuple[float, float]:
        return (b * self.interval_s, (b + 1) * self.interval_s)

    # -- persistence -------------------------------------------------------
    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            doc = {
                "version": _PROFILE_VERSION,
                "half_life_s": self.half_life_s,
                "interval_s": self.interval_s,
                "videos": {
                    name: {
                        "views": [
                            [list(k[:2]) + [list(k[2]), list(k[3]), k[4]],
                             c[0], c[1]]
                            for k, c in self._views.get(name, {}).items()
                        ],
                        "heat": [
                            [b, c[0], c[1]]
                            for b, c in self._heat.get(name, {}).items()
                        ],
                    }
                    for name in set(self._views) | set(self._heat)
                },
            }
        # atomic publish (temp + os.replace), the storage layer's
        # discipline: a crash mid-save never leaves a torn profile
        tmp = Path(f"{self.path}.tmp-{os.getpid()}")
        tmp.write_text(json.dumps(doc))
        os.replace(tmp, self.path)
        self._c_persists.inc()

    def load(self) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        try:
            doc = json.loads(Path(self.path).read_text())
            if doc.get("version") != _PROFILE_VERSION:
                return  # future format: start fresh rather than misread
            videos = doc.get("videos", {})
            views: Dict[str, Dict[tuple, List[float]]] = {}
            heat: Dict[str, Dict[int, List[float]]] = {}
            for name, tables in videos.items():
                vt: Dict[tuple, List[float]] = {}
                for key, score, last in tables.get("views", []):
                    codec, fps, roi, res, eps = key
                    vt[(codec, float(fps), tuple(roi), tuple(res),
                        float(eps))] = [float(score), float(last)]
                ht: Dict[int, List[float]] = {}
                for b, score, last in tables.get("heat", []):
                    ht[int(b)] = [float(score), float(last)]
                if vt:
                    views[name] = vt
                if ht:
                    heat[name] = ht
        except (ValueError, KeyError, TypeError, OSError):
            return  # a torn profile must never block the store
        with self._lock:
            self._views = views
            self._heat = heat

    def forget(self, name: str) -> None:
        """Drop a video's profile (mirrors `VSS.drop`)."""
        with self._lock:
            self._views.pop(name, None)
            self._heat.pop(name, None)


class AdaptivePolicy:
    """One `run_once()` tick = one pass over the four seams.  Owned and
    invoked by `VSS.adapt()`; never runs behind the store's back."""

    def __init__(self, vss, profiler: AccessProfiler, cfg: AdaptiveConfig):
        self.vss = vss
        self.profiler = profiler
        self.cfg = cfg
        self._lock = threading.Lock()
        self._last_backpressure = 0
        reg = vss.registry
        self._c_runs = reg.counter(
            "vss_adapt_runs_total", "adaptive policy ticks executed")
        self._c_mat = reg.counter(
            "vss_adapt_materialize_total",
            "hot derived views materialized ahead of demand")
        self._c_promote = reg.counter(
            "vss_adapt_promote_total",
            "hot-interval objects promoted into the hot tier")
        self._c_demote = reg.counter(
            "vss_adapt_demote_total",
            "cold-epoch objects demoted out of the hot tier")
        self._c_deferred = reg.counter(
            "vss_adapt_deferred_steps_total",
            "deferred-compression steps scheduled by the policy")
        self._c_resize = reg.counter(
            "vss_adapt_resize_total",
            "ingest pipeline resizes triggered by backpressure")

    # -- continuous seam: heat-boosted spill priority ----------------------
    def priority_fn(self, paths: Sequence[str]) -> Dict[str, float]:
        """LRU_VSS sequence numbers with hot-interval objects boosted
        past every cold one — installed as the `TieredBackend` priority
        function so the spiller keeps hot epochs resident even while a
        scan streams cold bytes through the tier."""
        base = dict(self.vss.catalog.lru_for_paths(paths))
        spans = self.vss.catalog.spans_for_paths(paths)
        if not spans:
            return base
        boost = (max(base.values()) - min(base.values()) + 1.0) if base \
            else 1.0
        now = self.profiler._clock()
        for path, (name, t0, t1) in spans.items():
            h = self.profiler.heat(name, t0, t1, now)
            if h >= 1.0:
                base[path] = base.get(path, 0.0) + boost
        return base

    # -- the tick ----------------------------------------------------------
    def run_once(self) -> Dict[str, Any]:
        with self._lock:
            report: Dict[str, Any] = {
                "materialized": [], "promoted": 0, "demoted": 0,
                "deferred_steps": 0, "resized": None,
            }
            self._materialize(report)
            self._retier(report)
            self._schedule_deferred(report)
            self._autosize(report)
            self._c_runs.inc()
            self.profiler.save()
            return report

    # -- seam 1: ahead-of-demand materialization ---------------------------
    def _materialize(self, report: Dict[str, Any]) -> None:
        vss = self.vss
        gop_budget = int(self.cfg.max_materialize_gops)
        for name in self.profiler.video_names():
            if gop_budget <= 0:
                break
            try:
                orig_id = vss.catalog.get_original_id(name)
            except Exception:
                orig_id = None
            if orig_id is None:
                continue
            orig = vss.catalog.get_physical(orig_id)
            for key, score in self.profiler.hot_views(
                    name, self.cfg.min_view_score):
                if gop_budget <= 0:
                    break
                codec, fps, roi, res, eps = key
                if codec == "rgb":
                    # decoded-output views are served by decode-on-read;
                    # materializing an uncompressed copy trades orders of
                    # magnitude more storage than any transcode saves
                    continue
                if self._is_native(orig, key):
                    continue  # the original already serves this view
                gaps = self._coverage_gaps(name, orig, key)
                gop_s = self._gop_seconds(orig)
                for lo, hi in reversed(gaps):  # newest epochs first
                    if gop_budget <= 0:
                        break
                    span = min(hi - lo, gop_budget * gop_s)
                    lo = max(lo, hi - span)
                    if hi - lo < 1.5 / max(fps, 1e-6):
                        continue
                    spec = ReadSpec(
                        name=name, t=(lo, hi), resolution=res, roi=roi,
                        fps=fps, codec=codec, quality_eps_db=eps,
                        cache=True,
                    )
                    try:
                        with self.profiler.suppress():
                            vss.read_batch([spec])
                    except Exception:
                        continue  # advisory: a failed warm-up is a no-op
                    n = max(1, int(math.ceil((hi - lo) / gop_s)))
                    gop_budget -= n
                    self._c_mat.inc()
                    report["materialized"].append({
                        "name": name, "codec": codec, "t": (lo, hi),
                        "score": round(score, 3),
                    })

    @staticmethod
    def _is_native(orig, key) -> bool:
        codec, fps, roi, res, _eps = key
        return (
            codec == orig.codec
            and abs(fps - orig.fps) < 1e-9
            and tuple(roi) == tuple(orig.roi)
            and tuple(res) == (orig.width, orig.height)
        )

    def _gop_seconds(self, orig) -> float:
        gops = self.vss.catalog.gops_for(orig.physical_id)
        nf = gops[0].num_frames if gops else 30
        return max(nf / max(orig.fps, 1e-6), 1e-3)

    def _serves(self, p, orig, key) -> bool:
        """Can physical ``p`` serve view ``key`` without transcoding?"""
        codec, fps, roi, res, _eps = key
        if p.codec != codec or p.fps < fps - 1e-9:
            return False
        if not p.covers_roi(roi):
            return False
        need_scale = res[0] / max(roi[2] - roi[0], 1)
        return p.scale >= need_scale - 1e-9

    def _coverage_gaps(self, name, orig, key) -> List[Tuple[float, float]]:
        """Sub-intervals of the original's extent where no
        config-matching physical has live GOPs."""
        vss = self.vss
        covered: List[Tuple[float, float]] = []
        for p in vss.catalog.physicals_for(name):
            if p.is_original or not self._serves(p, orig, key):
                continue
            for g in vss.catalog.gops_for(p.physical_id):
                covered.append((
                    g.start_time(p.fps, p.t_start),
                    g.end_time(p.fps, p.t_start),
                ))
        covered.sort()
        gaps: List[Tuple[float, float]] = []
        pos = orig.t_start
        eps_t = 0.5 / max(orig.fps, 1e-6)
        for s, e in covered:
            if s > pos + eps_t:
                gaps.append((pos, s))
            pos = max(pos, e)
        if orig.t_end > pos + eps_t:
            gaps.append((pos, orig.t_end))
        return gaps

    # -- seam 2: tier placement --------------------------------------------
    def _retier(self, report: Dict[str, Any]) -> None:
        from repro_torch.storage import TieredBackend, unwrap

        vss = self.vss
        tiered = unwrap(vss.backend, TieredBackend)
        if tiered is None:
            return
        hot_paths: List[str] = []
        cold_paths: List[str] = []
        for name in self.profiler.video_names():
            scores = self.profiler.bucket_scores(name)
            if not scores:
                continue
            hot_b = [b for b, s in scores.items() if s >= 1.0]
            cold_b = [b for b, s in scores.items()
                      if s <= self.cfg.cold_score]
            for p in vss.catalog.physicals_for(name):
                for b in hot_b:
                    t0, t1 = self.profiler.bucket_span(b)
                    f0, f1 = p.frame_at(t0), p.frame_at(t1)
                    hot_paths.extend(
                        g.path for g in vss.catalog.gops_in_range(
                            p.physical_id, f0, f1)
                        if g.tile_sizes is None and g.joint_ref is None
                    )
                for b in cold_b:
                    t0, t1 = self.profiler.bucket_span(b)
                    f0, f1 = p.frame_at(t0), p.frame_at(t1)
                    cold_paths.extend(
                        g.path for g in vss.catalog.gops_in_range(
                            p.physical_id, f0, f1)
                        if g.tile_sizes is None and g.joint_ref is None
                    )
        hot_set = set(hot_paths)
        cold_paths = [p for p in cold_paths if p not in hot_set]
        if cold_paths:
            n = tiered.demote(cold_paths)
            self._c_demote.inc(n)
            report["demoted"] = n
        if hot_paths:
            resident = set(tiered.hot_keys())
            missing = [p for p in hot_paths if p not in resident]
            # promotion budget: never churn more than a quarter of the
            # hot tier per tick
            budget = tiered.hot_bytes // 4
            take: List[str] = []
            for path in missing:
                try:
                    nb = tiered.stat(path).nbytes
                except Exception:
                    continue
                if nb > budget:
                    break
                budget -= nb
                take.append(path)
            if take:
                try:
                    tiered.batch_get(take)  # fetches promote into hot
                except Exception:
                    take = []
                self._c_promote.inc(len(take))
            report["promoted"] = len(take)

    # -- seam 3: deferred compression scheduling ---------------------------
    def _schedule_deferred(self, report: Dict[str, Any]) -> None:
        vss = self.vss
        if not vss.enable_deferred:
            return
        pipeline = vss._ingest
        queued = pipeline.stats().queued_gops if pipeline is not None else 0
        steps = 0
        if queued == 0:
            # ingest idle: spend the tick's budget freely
            for name in vss.catalog.list_logical():
                while (steps < self.cfg.deferred_budget
                       and vss.deferred.active(name)):
                    if vss.deferred.compress_one(name) is None:
                        break
                    steps += 1
                    if (pipeline is not None
                            and pipeline.stats().queued_gops > 0):
                        break  # live ingest resumed: yield immediately
                if steps >= self.cfg.deferred_budget:
                    break
        else:
            # live ingest in flight: only videos OVER budget justify
            # stealing the pipeline — pause, take a short burst, resume
            urgent = [
                name for name in vss.catalog.list_logical()
                if vss.cache.over_budget_bytes(name) > 0
                and vss.deferred.active(name)
            ]
            if urgent and pipeline is not None:
                pipeline.pause()
                try:
                    for name in urgent[:2]:
                        if vss.deferred.compress_one(name) is not None:
                            steps += 1
                finally:
                    pipeline.resume()
        if steps:
            self._c_deferred.inc(steps)
        report["deferred_steps"] = steps

    # -- seam 4: ingest auto-sizing ----------------------------------------
    def _autosize(self, report: Dict[str, Any]) -> None:
        vss = self.vss
        if not vss.config.ingest.autosize:
            return
        pipeline = vss._ingest
        if pipeline is None or not pipeline.configured_workers:
            return
        st = pipeline.stats()
        if st.backpressure_waits > self._last_backpressure:
            workers = min(_MAX_AUTO_WORKERS,
                          pipeline.configured_workers * 2)
            queue_gops = min(_MAX_AUTO_QUEUE, pipeline.queue_gops * 2)
            pipeline.resize(workers=workers, queue_gops=queue_gops)
            vss.ingest_workers = workers
            vss.ingest_queue_gops = queue_gops
            self._c_resize.inc()
            report["resized"] = {
                "workers": workers, "queue_gops": queue_gops,
                "backpressure_waits": st.backpressure_waits,
            }
        self._last_backpressure = st.backpressure_waits
