"""Workload-adaptive format management (profile.py).

The contract under test, in order of importance:

1. **Observation is free**: with the policy off, a store that profiles
   its reads is bit-identical to one that doesn't — same frames, same
   plans, same fetch/decode counts.
2. The profile **persists** across close/reopen.
3. One ``adapt()`` tick drives the four seams: ahead-of-demand
   materialization, hot/cold tier placement, deferred-compression
   scheduling, and backpressure-driven ingest sizing.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import AdaptiveConfig, IngestConfig, VSSConfig
from repro_torch.core.profile import suggest_ingest_sizing
from repro_torch.obs import MetricsRegistry
from repro_torch.storage import (
    FaultInjectingBackend,
    MemoryBackend,
    TieredBackend,
    unwrap,
)
from repro_torch.core.store import VSS as _PortVSS


# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)


def VSS(root, *, config=None, **kw):
    """The port's store on the CPU (its default device is CUDA)."""
    cfg = config if config is not None else VSSConfig()
    return _PortVSS(root, config=dataclasses.replace(cfg, device="cpu"),
                    **kw)


def _store(tmp_path, name, **cfg_kw):
    cfg_kw.setdefault("registry", MetricsRegistry())
    return VSS(str(tmp_path / name), config=VSSConfig(**cfg_kw))


# ---------------------------------------------------------------------------
# 1. observation changes nothing
# ---------------------------------------------------------------------------

def _read_sequence(store):
    out = [store.read("v", codec="rgb", cache=False).frames]
    out.append(store.read("v", t=(0.5, 1.5), codec="tvc-med").frames)
    out.append(
        store.read("v", roi=(32, 16, 96, 80), codec="rgb", cache=False).frames
    )
    # replay of the cached view: planning must pick the same fragments
    out.append(
        store.read("v", t=(0.5, 1.5), codec="tvc-med", cache=False).frames
    )
    return out


def test_profiler_observation_is_bit_exact(tmp_path, clip):
    on = _store(tmp_path, "on",
                adaptive=AdaptiveConfig(profile=True, enabled=False))
    off = _store(tmp_path, "off", adaptive=AdaptiveConfig(profile=False))
    try:
        assert on.profiler is not None and on.adaptive is None
        assert off.profiler is None
        for s in (on, off):
            s.write("v", clip, fps=30.0, codec="tvc-hi")
        for a, b in zip(_read_sequence(on), _read_sequence(off)):
            assert np.array_equal(a, b)
        sa, sb = on.stats("v"), off.stats("v")
        for key in (
            "physical_videos", "gops", "bytes", "specs_read", "plan_groups",
            "specs_coalesced", "objects_fetched", "fetch_bytes",
            "gops_decoded",
        ):
            assert sa[key] == sb[key], key
    finally:
        on.close()
        off.close()


# ---------------------------------------------------------------------------
# 2. the profile survives a restart
# ---------------------------------------------------------------------------

def test_profile_persists_across_reopen(tmp_path, clip):
    root = str(tmp_path / "s")
    s = VSS(root, config=VSSConfig(registry=MetricsRegistry()))
    s.write("v", clip, fps=30.0, codec="tvc-hi")
    for _ in range(4):
        s.read("v", t=(0.0, 1.0), resolution=(64, 48), codec="rgb",
               cache=False)
    s.close()  # close() persists the profile
    assert os.path.exists(os.path.join(root, "profile.json"))

    s2 = VSS(root, config=VSSConfig(registry=MetricsRegistry()))
    try:
        hot = s2.profiler.hot_views("v", min_score=2.0)
        assert hot, "reopened store lost its learned view frequencies"
        (codec, _fps, _roi, res, _eps), score = hot[0]
        assert codec == "rgb" and tuple(res) == (64, 48)
        assert score >= 2.0
        assert s2.profiler.heat("v", 0.0, 1.0) >= 0.5
    finally:
        s2.close()


def test_drop_forgets_profile(tmp_path, clip):
    s = _store(tmp_path, "s")
    try:
        s.write("v", clip, fps=30.0, codec="tvc-hi")
        s.read("v", codec="rgb", cache=False)
        assert s.profiler.video_names() == ["v"]
        s.drop("v")
        assert s.profiler.video_names() == []
    finally:
        s.close()


# ---------------------------------------------------------------------------
# 3a. seam: ahead-of-demand materialization
# ---------------------------------------------------------------------------

def test_adapt_materializes_hot_view_ahead(tmp_path, clip):
    s = _store(tmp_path, "s", adaptive=AdaptiveConfig(enabled=True))
    try:
        s.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
        for _ in range(4):  # past min_view_score=3: this view is hot
            s.read("v", resolution=(64, 48), codec="tvc-med", cache=False)
        report = s.adapt()
        assert report["materialized"], "hot view was not materialized"
        derived = [
            p for p in s.catalog.physicals_for("v")
            if not p.is_original and p.codec == "tvc-med"
        ]
        assert derived, "no tvc-med physical exists after adapt()"
        # the whole extent is covered now: the next tick converges
        assert s.adapt()["materialized"] == []
        # and the next user read of that view is served from the
        # derived physical (pass-through), not transcoded
        r = s.read("v", resolution=(64, 48), codec="tvc-med", cache=False)
        chosen = {c.video_idx for c in r.plan.selection.chosen(r.plan.problem)}
        assert {r.plan.runs[i].physical.codec for i in chosen} == {"tvc-med"}
    finally:
        s.close()


# ---------------------------------------------------------------------------
# 3b. seam: tier placement by interval heat
# ---------------------------------------------------------------------------

def test_adapt_retiers_hot_and_cold_epochs(tmp_path, clip):
    tiered = TieredBackend(MemoryBackend(), hot_bytes=256 << 20)
    s = _store(
        tmp_path, "s", backend=tiered,
        adaptive=AdaptiveConfig(
            enabled=True, half_life_s=0.4, interval_s=0.5,
            min_view_score=1e9,  # isolate the tiering seam
        ),
    )
    try:
        s.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
        s.read("v", codec="rgb", cache=False)  # touch every epoch once
        time.sleep(1.8)                        # ... and let them go cold
        for _ in range(5):                     # epoch [0, 0.5) runs hot
            s.read("v", t=(0.0, 0.5), codec="rgb", cache=False)
        orig_id = s.catalog.get_original_id("v")
        path = {g.index: g.path for g in s.catalog.gops_for(orig_id)}

        report = s.adapt()
        hot_keys = set(unwrap(s.backend, TieredBackend).hot_keys())
        assert report["demoted"] > 0
        assert path[0] in hot_keys, "hot epoch was evicted from the hot tier"
        assert path[3] not in hot_keys, "cold epoch stayed resident"

        # the continuous seam: heat-boosted spill priority outranks LRU
        pf = s.adaptive.priority_fn(list(path.values()))
        assert pf[path[0]] > pf[path[3]]

        # promotion: drop everything, the next tick pulls hot epochs back
        tiered.demote(list(path.values()))
        report2 = s.adapt()
        assert report2["promoted"] > 0
        assert path[0] in set(tiered.hot_keys())
    finally:
        s.close()


# ---------------------------------------------------------------------------
# 3c. seam: deferred compression while ingest is idle
# ---------------------------------------------------------------------------

def test_adapt_schedules_deferred_compression(tmp_path, clip):
    s = _store(
        tmp_path, "s", budget_multiple=2.0,
        adaptive=AdaptiveConfig(enabled=True, min_view_score=1e9),
    )
    try:
        s.write("v", clip, fps=30.0, codec="rgb", gop_frames=15)
        assert s.deferred.active("v")
        report = s.adapt()
        assert report["deferred_steps"] > 0
        gops = s.catalog.gops_for(s.catalog.get_original_id("v"))
        assert any(g.zwrapped for g in gops)
    finally:
        s.close()


# ---------------------------------------------------------------------------
# 3d. seam: ingest auto-sizing
# ---------------------------------------------------------------------------

def test_suggest_ingest_sizing_scales_with_latency():
    class _CM:
        def __init__(self, latency_us):
            self.io_table = {"default": (latency_us, 0.0)}

    class _Backend:
        def kind_for(self, key):
            return "default"

    class _NoKind:
        def kind_for(self, key):
            raise RuntimeError("no kinds here")

    assert suggest_ingest_sizing(_CM(2e3), _Backend()) == (2, 32)
    assert suggest_ingest_sizing(_CM(5e4), _Backend()) == (4, 64)
    assert suggest_ingest_sizing(_CM(5e5), _Backend()) == (8, 128)
    # a backend without kinds falls back to the default io_table row
    assert suggest_ingest_sizing(_CM(2e3), _NoKind()) == (2, 32)


def test_backpressure_grows_ingest_pipeline(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (120, 24, 32, 3), dtype=np.uint8)
    slow = FaultInjectingBackend(MemoryBackend(), seed=0, latency=0.02)
    s = _store(
        tmp_path, "s", backend=slow,
        ingest=IngestConfig(autosize=True),
        adaptive=AdaptiveConfig(enabled=True, min_view_score=1e9),
    )
    try:
        # construction already sized the pipeline from the io_table
        assert (s.ingest_workers, s.ingest_queue_gops) == \
            suggest_ingest_sizing(s.cost_model, slow)
        for i in range(3):  # tiny GOPs against a slow backend: the
            w = s.writer(f"v{i}", fps=30.0, codec="tvc-ll", gop_frames=2)
            w.append(frames)  # bounded queue must push back
            w.close()
            if s._ingest.stats().backpressure_waits > 0:
                break
        assert s._ingest.stats().backpressure_waits > 0
        before_w, before_q = (
            s._ingest.configured_workers, s._ingest.queue_gops)

        report = s.adapt()
        assert report["resized"] is not None
        assert s._ingest.configured_workers == min(16, before_w * 2)
        assert s._ingest.queue_gops == min(512, before_q * 2)
        assert s.ingest_workers == s._ingest.configured_workers

        # no new waits since the resize: the next tick is a no-op
        assert s.adapt()["resized"] is None

        # the grown pipeline still publishes correctly
        w = s.writer("after", fps=30.0, codec="tvc-ll", gop_frames=2)
        w.append(frames[:20])
        w.close()
        got = s.read("after", codec="rgb", cache=False).frames
        assert np.array_equal(got, frames[:20])
    finally:
        s.close()


def test_retier_matches_reference(tmp_path, clip):
    """The tier-placement scenario above in both packages, in lockstep
    on one shared clock: every tick demotes and promotes the same
    counts, and leaves the same objects resident in the hot tier."""
    from repro import storage as jstorage
    from repro.core import AdaptiveConfig as JAdaptive
    from repro.core import VSSConfig as JConfig
    from repro.core.store import VSS as JVSS
    from repro.obs import MetricsRegistry as JRegistry

    now = [1000.0]

    def clock():
        return now[0]

    adaptive = dict(enabled=True, half_life_s=0.4, interval_s=0.5,
                    min_view_score=1e9)
    tiers = [jstorage.TieredBackend(jstorage.MemoryBackend(),
                                    hot_bytes=256 << 20),
             TieredBackend(MemoryBackend(), hot_bytes=256 << 20)]
    stores = [
        JVSS(str(tmp_path / "j"), config=JConfig(
            backend=tiers[0], registry=JRegistry(),
            adaptive=JAdaptive(**adaptive))),
        _store(tmp_path, "t", backend=tiers[1],
               adaptive=AdaptiveConfig(**adaptive)),
    ]
    try:
        for s in stores:
            s.profiler._clock = clock
            s.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
            s.read("v", codec="rgb", cache=False)
        now[0] += 1.8
        for _ in range(5):
            for s in stores:
                s.read("v", t=(0.0, 0.5), codec="rgb", cache=False)
            now[0] += 0.01
        reports = [s.adapt() for s in stores]
        assert reports[0]["demoted"] > 0
        for key in ("demoted", "promoted"):
            assert reports[1].get(key) == reports[0].get(key), key
        assert sorted(tiers[1].hot_keys()) == sorted(tiers[0].hot_keys())

        for tier in tiers:
            tier.demote(tier.list())
        now[0] += 0.01
        reports = [s.adapt() for s in stores]
        assert reports[0]["promoted"] > 0
        for key in ("demoted", "promoted"):
            assert reports[1].get(key) == reports[0].get(key), key
        assert sorted(tiers[1].hot_keys()) == sorted(tiers[0].hot_keys())
    finally:
        for s in stores:
            s.close()
