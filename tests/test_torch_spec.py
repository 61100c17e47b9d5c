"""Declarative ReadSpec/WriteSpec API, joint batch planning, writer
lifecycle, and the backend-aware I/O cost term: the reference's
`tests/test_spec.py` on the port (CPU), plus the same validation
verdicts, joint plans and cost tables as the reference's."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core import spec as jspec
from repro.core.config import VSSConfig as JConfig
from repro.core.store import VSS as JVSS
from repro_torch.core import spec as tspec
from repro_torch.core.config import VSSConfig
from repro_torch.core.cost import DEFAULT_IO_TABLE, CostModel, calibration_path
from repro_torch.core.spec import ReadSpec, WriteSpec
from repro_torch.core.store import VSS as _PortVSS
from repro_torch.storage import (
    LocalFSBackend,
    ShardedBackend,
    StorageBackend,
    TieredBackend,
)


# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)


def VSS(root, *, config=None, **kw):
    """The port's store on the CPU (its default device is CUDA)."""
    cfg = config if config is not None else VSSConfig()
    return _PortVSS(root, config=dataclasses.replace(cfg, device="cpu"),
                    **kw)


@pytest.fixture()
def vss(tmp_path):
    """The port's counterpart of conftest's reference store."""
    store = VSS(str(tmp_path / "vss"))
    yield store
    store.close()


class CountingBackend(StorageBackend):
    """Delegating wrapper that counts object fetches (one per ``get``,
    one per key in ``batch_get``) — the instrument behind the batched-
    read acceptance criterion."""

    def __init__(self, inner):
        self.inner = inner
        self.objects_fetched = 0
        self.batch_get_calls = 0
        self.get_calls = 0

    def reset(self):
        self.objects_fetched = 0
        self.batch_get_calls = 0
        self.get_calls = 0

    def put(self, key, data):
        self.inner.put(key, data)

    def batch_put(self, items):
        self.inner.batch_put(items)

    def get(self, key):
        self.get_calls += 1
        self.objects_fetched += 1
        return self.inner.get(key)

    def batch_get(self, keys):
        self.batch_get_calls += 1
        self.objects_fetched += len(keys)
        return self.inner.batch_get(keys)

    def delete(self, key):
        self.inner.delete(key)

    def stat(self, key):
        return self.inner.stat(key)

    def list(self, prefix=""):
        return self.inner.list(prefix)

    def sweep_temps(self):
        return self.inner.sweep_temps()

    def layout_fingerprint(self):
        return self.inner.layout_fingerprint()

    def kind_for(self, key):
        return self.inner.kind_for(key)

    def close(self):
        self.inner.close()


# ---------------------------------------------------------------------------
# construction-time validation
# ---------------------------------------------------------------------------

def test_unknown_codec_rejected():
    with pytest.raises(ValueError):
        ReadSpec(name="v", codec="vp9")
    with pytest.raises(ValueError):
        WriteSpec(name="v", codec="av1-maybe")


def test_codec_canonicalized_at_construction():
    assert ReadSpec(name="v", codec="H264").codec == "tvc-med"
    assert WriteSpec(name="v", codec="HEVC").codec == "tvc-hi"


def test_empty_or_malformed_interval_rejected():
    with pytest.raises(ValueError):
        ReadSpec(name="v", t=(2.0, 1.0))
    with pytest.raises(ValueError):
        ReadSpec(name="v", t=(1.0, 1.0))
    with pytest.raises(ValueError):
        ReadSpec(name="v", t=(0.0,))
    with pytest.raises(ValueError):
        ReadSpec(name="v", t=(0.0, float("nan")))


def test_degenerate_roi_rejected():
    for roi in [(10, 0, 5, 5), (0, 0, 0, 5), (-1, 0, 5, 5), (0, 0, 5)]:
        with pytest.raises(ValueError):
            ReadSpec(name="v", roi=roi)


def test_bad_resolution_fps_method_rejected():
    with pytest.raises(ValueError):
        ReadSpec(name="v", resolution=(0, 10))
    with pytest.raises(ValueError):
        ReadSpec(name="v", fps=-1.0)
    with pytest.raises(ValueError):
        ReadSpec(name="v", method="annealing")
    with pytest.raises(ValueError):
        WriteSpec(name="v", fps=0.0)
    with pytest.raises(ValueError):
        WriteSpec(name="v", gop_frames=0)
    with pytest.raises(ValueError):
        ReadSpec(name="")


def test_specs_are_immutable_and_hashable():
    spec = ReadSpec(name="v", t=(0.0, 1.0))
    with pytest.raises(Exception):
        spec.codec = "hevc"
    assert spec == ReadSpec(name="v", t=(0.0, 1.0))
    assert len({spec, ReadSpec(name="v", t=(0.0, 1.0))}) == 1


# ---------------------------------------------------------------------------
# resolve-time validation (against the stored original)
# ---------------------------------------------------------------------------

def test_out_of_range_interval_rejected(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    with pytest.raises(ValueError):
        vss.read_spec(ReadSpec(name="v", t=(1.0, 3.0)))
    with pytest.raises(ValueError):
        vss.read_spec(ReadSpec(name="v", t=(-0.5, 1.0)))


def test_roi_outside_frame_bounds_rejected(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")  # 128x96 frame
    with pytest.raises(ValueError):
        vss.read_spec(ReadSpec(name="v", roi=(0, 0, 500, 500)))


def test_unknown_video_raises_keyerror(vss):
    with pytest.raises(KeyError):
        vss.read_spec(ReadSpec(name="nope"))


# ---------------------------------------------------------------------------
# shim back-compat: keyword read() == spec path
# ---------------------------------------------------------------------------

def test_keyword_shim_matches_spec_path(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    kw = vss.read("v", t=(0.5, 1.5), codec="rgb", cache=False)
    sp = vss.read_spec(
        ReadSpec(name="v", t=(0.5, 1.5), codec="rgb", cache=False)
    )
    assert np.array_equal(kw.frames, sp.frames)
    assert kw.plan.segments == sp.plan.segments
    assert kw.plan.selection.assignment == sp.plan.selection.assignment


def test_keyword_shim_matches_spec_path_encoded(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    kw = vss.read("v", codec="hevc", cache=False)
    sp = vss.read_spec(ReadSpec(name="v", codec="hevc", cache=False))
    assert kw.nbytes == sp.nbytes
    assert np.array_equal(kw.frames, sp.frames)


# ---------------------------------------------------------------------------
# read_batch semantics
# ---------------------------------------------------------------------------

def test_read_batch_empty(vss):
    assert vss.read_batch([]) == []


def test_read_batch_rejects_non_specs(vss):
    with pytest.raises(TypeError):
        vss.read_batch(["v"])


def test_read_batch_matches_sequential(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    specs = [
        ReadSpec(name="v", t=(0.0, 1.5), cache=False),
        ReadSpec(name="v", t=(0.5, 2.0), cache=False),
        ReadSpec(name="v", t=(1.0, 2.0), cache=False),
    ]
    seq = [vss.read_spec(s).frames for s in specs]
    batch = vss.read_batch(specs)
    assert len(batch) == len(specs)
    for got, want in zip(batch, seq):
        assert np.array_equal(got.frames, want)


def test_read_batch_duplicate_specs_independent_results(vss, clip):
    """Duplicates share one execution (see the fetch-count test) but the
    returned buffers stay independently mutable, as from sequential
    reads."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    spec = ReadSpec(name="v", t=(0.0, 1.0), cache=False)
    a, b = vss.read_batch([spec, ReadSpec(name="v", t=(0.0, 1.0),
                                          cache=False)])
    assert a.frames is not b.frames
    assert np.array_equal(a.frames, b.frames)
    a.frames[:] = 0  # mutating one result must not corrupt the other
    assert not np.array_equal(a.frames, b.frames)
    ref = vss.read_spec(spec).frames
    assert np.array_equal(b.frames, ref)


def test_read_batch_subframe_interval_matches_sequential(vss, clip):
    """A sub-frame spec inside a larger batch must return the same
    frames as its sequential read, not a neighbouring segment's."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    tiny = ReadSpec(name="v", t=(1.0, 1.01), cache=False)
    seq = vss.read_spec(tiny).frames
    _big, got = vss.read_batch([
        ReadSpec(name="v", t=(0.0, 1.0), cache=False), tiny,
    ])
    assert got.frames.shape == seq.shape
    assert np.array_equal(got.frames, seq)


def test_read_batch_joint_plan_demands(vss, clip):
    """Overlapping same-view specs share one joint problem; segments in
    the overlap carry demand > 1."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    out = vss.read_batch([
        ReadSpec(name="v", t=(0.0, 1.5), cache=False),
        ReadSpec(name="v", t=(0.5, 2.0), cache=False),
    ])
    demands = [d for r in out for d in (r.plan.problem.demands or [])]
    assert demands and max(demands) == 2


def test_read_batch_across_videos(vss, clip):
    vss.write("a", clip, fps=30.0, codec="tvc-hi")
    vss.write("b", clip[:30], fps=30.0, codec="tvc-ll")
    ra, rb = vss.read_batch([
        ReadSpec(name="a", t=(0.0, 1.0), cache=False),
        ReadSpec(name="b", cache=False),
    ])
    assert ra.frames.shape[0] == 30
    assert np.array_equal(rb.frames, clip[:30])


def test_read_batch_mixed_configs_same_video(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    r1, r2 = vss.read_batch([
        ReadSpec(name="v", t=(0.0, 2.0), codec="rgb", cache=False),
        ReadSpec(name="v", t=(0.0, 2.0), resolution=(64, 48),
                 codec="rgb", cache=False),
    ])
    assert r1.frames.shape[1:3] == (96, 128)
    assert r2.frames.shape[1:3] == (48, 64)


def test_read_batch_admissions_visible_after(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    before = vss.stats("v")["physical_videos"]
    vss.read_batch([
        ReadSpec(name="v", t=(0.0, 1.0), codec="tvc-med"),
        ReadSpec(name="v", t=(1.0, 2.0), codec="tvc-med"),
    ])
    assert vss.stats("v")["physical_videos"] > before


def test_read_batch_fewer_fetches_than_sequential(tmp_path, clip):
    """The acceptance criterion: N overlapping specs on ShardedBackend
    fetch strictly fewer objects through read_batch than N sequential
    read() calls, and each joint plan issues a single batch_get."""
    counting = CountingBackend(
        ShardedBackend.local(str(tmp_path / "objects"), 3)
    )
    vss = VSS(str(tmp_path / "vss"), backend=counting,
              enable_deferred=False, enable_compaction=False)
    try:
        vss.write("v", clip, fps=30.0, codec="tvc-ll", gop_frames=5)
        intervals = [(0.0, 1.5), (0.5, 2.0), (1.0, 2.0), (0.0, 1.5)]
        specs = [
            ReadSpec(name="v", t=t, cache=False) for t in intervals
        ]

        counting.reset()
        seq_frames = [
            vss.read("v", t=t, cache=False).frames for t in intervals
        ]
        seq_fetched = counting.objects_fetched

        counting.reset()
        batch = vss.read_batch(specs)
        batch_fetched = counting.objects_fetched

        assert batch_fetched < seq_fetched
        # one plan group (same view config) -> one batch_get for the union
        assert counting.batch_get_calls == 1
        assert counting.get_calls == 0
        # no key fetched twice within the batch
        assert batch_fetched <= 12  # 60 frames / 5-frame GOPs
        for got, want in zip(batch, seq_frames):
            assert np.array_equal(got.frames, want)
    finally:
        vss.close()


# ---------------------------------------------------------------------------
# priority hints (QoS)
# ---------------------------------------------------------------------------

def test_priority_validated_and_canonicalized():
    assert ReadSpec(name="v").priority == 0
    assert ReadSpec(name="v", priority=7).priority == 7
    assert ReadSpec(name="v", priority=-2).priority == -2
    assert ReadSpec(name="v", priority="3").priority == 3  # canonicalized
    with pytest.raises(ValueError):
        ReadSpec(name="v", priority="urgent")
    with pytest.raises(ValueError):
        ReadSpec(name="v", priority=None)


def test_priority_does_not_split_plan_groups(vss, clip):
    """Priority is an execution hint, not part of the view identity:
    same-view specs still share one joint problem."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    out = vss.read_batch([
        ReadSpec(name="v", t=(0.0, 1.5), cache=False, priority=0),
        ReadSpec(name="v", t=(0.5, 2.0), cache=False, priority=9),
    ])
    demands = [d for r in out for d in (r.plan.problem.demands or [])]
    assert demands and max(demands) == 2  # still jointly planned


def test_read_batch_executes_by_priority_within_group(vss, clip,
                                                      monkeypatch):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    order = []
    orig = _PortVSS._execute

    def spy(self, plan, roi, resolution, out_fps, io):
        order.append((plan.segments[0][0], plan.segments[-1][1]))
        return orig(self, plan, roi, resolution, out_fps, io)

    monkeypatch.setattr(_PortVSS, "_execute", spy)
    specs = [
        ReadSpec(name="v", t=(0.0, 0.5), cache=False, priority=0),
        ReadSpec(name="v", t=(0.5, 1.0), cache=False, priority=5),
        ReadSpec(name="v", t=(1.0, 1.5), cache=False, priority=2),
        ReadSpec(name="v", t=(1.5, 2.0), cache=False, priority=5),
    ]
    out = vss.read_batch(specs)
    # execution: priority 5 specs first (submission order breaks the
    # tie), then 2, then 0
    want = [(0.5, 1.0), (1.5, 2.0), (1.0, 1.5), (0.0, 0.5)]
    got_order = list(order)
    assert len(got_order) == len(want)
    for (ga, gb), (wa, wb) in zip(got_order, want):
        assert ga == pytest.approx(wa) and gb == pytest.approx(wb)
    # results stay order-preserving regardless of execution order
    seq = [vss.read_spec(sp).frames for sp in specs]
    for got, ref in zip(out, seq):
        assert np.array_equal(got.frames, ref)


# ---------------------------------------------------------------------------
# install-time calibration persistence
# ---------------------------------------------------------------------------

def test_calibrate_io_persists_and_loads_at_startup(tmp_path):
    root = str(tmp_path / "vss")
    vss = VSS(root, backend="memory")
    table = vss.calibrate_io(
        trials=1, small_bytes=1 << 10, large_bytes=1 << 16,
        reference_pixels_per_s=1e9,
    )
    assert "memory" in table
    assert os.path.exists(calibration_path(root))
    assert not vss.backend.list("_calib/")  # probe objects cleaned up
    saved = tuple(vss.cost_model.io_table["memory"])
    vss.close()

    vss2 = VSS(root, backend="memory")  # startup loads the saved model
    try:
        assert tuple(vss2.cost_model.io_table["memory"]) == \
            pytest.approx(saved)
        # kinds that were never measured fall back to the shipped table
        assert tuple(vss2.cost_model.io_table["remote"]) == \
            DEFAULT_IO_TABLE["remote"]
    finally:
        vss2.close()


def test_store_without_calibration_uses_defaults(tmp_path):
    vss = VSS(str(tmp_path / "vss"))
    try:
        assert vss.cost_model.io_table == DEFAULT_IO_TABLE
    finally:
        vss.close()


def test_torn_calibration_file_never_blocks_startup(tmp_path):
    """A crash mid-save (or hand-editing gone wrong) must not brick the
    store: an unreadable table warns and falls back to defaults."""
    root = str(tmp_path / "vss")
    os.makedirs(root, exist_ok=True)
    with open(calibration_path(root), "w") as f:
        f.write('{"alpha": {"rgb->rgb": [[100, ')  # torn JSON
    with pytest.warns(UserWarning, match="unreadable cost calibration"):
        vss = VSS(root)
    try:
        assert vss.cost_model.io_table == DEFAULT_IO_TABLE
    finally:
        vss.close()


# ---------------------------------------------------------------------------
# backend-aware I/O cost
# ---------------------------------------------------------------------------

def test_io_cost_orders_backend_kinds():
    cm = CostModel.default()
    n = 1 << 20
    assert cm.io_cost("memory", n) < cm.io_cost("localfs", n)
    assert cm.io_cost("localfs", n) < cm.io_cost("remote", n)
    assert cm.io_cost("unknown-kind", n) == cm.io_cost("default", n)


def test_cost_model_save_load_roundtrip(tmp_path):
    cm = CostModel.default()
    cm.io_table["remote"] = (123.0, 0.5)
    path = str(tmp_path / "cost.json")
    cm.save(path)
    loaded = CostModel.load(path)
    assert loaded.io_table["remote"] == (123.0, 0.5)
    assert loaded.alpha("rgb", "tvc-hi", 960 * 540) == pytest.approx(
        cm.alpha("rgb", "tvc-hi", 960 * 540)
    )


def test_tiered_kind_for_answers_per_key(tmp_path):
    tiered = TieredBackend(LocalFSBackend(str(tmp_path / "cold")),
                           hot_bytes=1 << 20)
    tiered.put("hot.bin", b"x" * 128)
    assert tiered.kind_for("hot.bin") == "memory"
    big = b"y" * (2 << 20)  # larger than the hot tier: cold only
    tiered.put("cold.bin", big)
    assert tiered.kind_for("cold.bin") == "localfs"
    tiered.close()


def test_plans_prefer_hot_tier_fragments(tmp_path, clip):
    """Two otherwise-identical candidate fragments on different tiers:
    the io_cost term must resolve the tie toward the faster one."""
    from repro_torch.core.select import (
        SegmentChoice,
        SelectionProblem,
        solve,
    )

    cm = CostModel.default()
    nbytes = 500_000
    base = 1000.0
    hot = SegmentChoice(0, base + cm.io_cost("memory", nbytes), 0.0)
    cold = SegmentChoice(1, base + cm.io_cost("localfs", nbytes), 0.0)
    sel = solve(SelectionProblem([(0.0, 1.0)], [[cold, hot]]), "dp")
    assert sel.assignment == [1]  # the memory-tier copy wins


# ---------------------------------------------------------------------------
# writer lifecycle (orphaned-logical fix) + batched publish
# ---------------------------------------------------------------------------

def test_abandoned_writer_leaves_nothing(vss, clip):
    w = vss.writer("x", fps=30.0, codec="tvc-hi")
    del w  # never appended, never closed
    assert not vss.catalog.logical_exists("x")
    # the name is immediately reusable
    vss.write("x", clip[:15], fps=30.0, codec="tvc-hi")
    assert vss.read("x", cache=False).frames.shape[0] == 15


def test_writer_registers_on_first_flush(vss, clip):
    w = vss.writer("y", fps=30.0, codec="tvc-hi", gop_frames=15)
    assert not vss.catalog.logical_exists("y")
    w.append(clip[:30])
    assert vss.catalog.logical_exists("y")
    w.close()


def test_writer_race_loses_at_first_flush(vss, clip):
    wa = vss.writer("z", fps=30.0, codec="tvc-hi", gop_frames=15)
    wb = vss.writer("z", fps=30.0, codec="tvc-hi", gop_frames=15)
    wa.append(clip[:15])
    with pytest.raises(ValueError):
        wb.append(clip[:15])


def test_writer_close_without_frames_raises(vss):
    w = vss.writer("w0", fps=30.0)
    with pytest.raises(ValueError):
        w.close()
    assert not vss.catalog.logical_exists("w0")


def test_recovery_drops_empty_logical(tmp_path):
    root = str(tmp_path / "vss")
    vss = VSS(root)
    vss.catalog.create_logical("ghost", 0)  # pre-flush crash turd
    vss.catalog.close()  # crash: no clean_shutdown marker
    vss.backend.close()
    reopened = VSS(root)
    try:
        assert not reopened.catalog.logical_exists("ghost")
    finally:
        reopened.close()


def test_writer_batch_gops_publishes_in_windows(vss, clip):
    from repro_torch.core.spec import WriteSpec

    w = vss.writer_spec(
        WriteSpec(name="bw", fps=30.0, codec="tvc-hi", gop_frames=10),
        batch_gops=4,
    )
    w.append(clip[:30])  # 3 full GOPs buffered, below the window
    assert vss.stats("bw")["gops"] == 0
    w.append(clip[30:50])  # 5th GOP crosses the window -> publish
    assert vss.stats("bw")["gops"] >= 4
    w.append(clip[50:])
    w.close()
    assert vss.stats("bw")["gops"] == 6
    out = vss.read("bw", cache=False).frames
    assert np.array_equal(out, vss.read("bw", cache=False).frames)
    assert out.shape[0] == 60


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

SPEC_CASES = [
    ("read", dict(name="v")),
    ("read", dict(name="v", codec="H264", t=(0, 2), priority="3",
                  deadline_ms="25")),
    ("read", dict(name="v", roi=(1, 2, 30, 40), resolution=(16, 12),
                  fps=15, method="greedy", quality_eps_db=30)),
    ("read", dict(name="v", codec="vp9")),
    ("read", dict(name="v", t=(2.0, 1.0))),
    ("read", dict(name="v", t=(0.0,))),
    ("read", dict(name="v", t=(0.0, float("nan")))),
    ("read", dict(name="v", roi=(10, 0, 5, 5))),
    ("read", dict(name="v", roi=(0, 0, 5))),
    ("read", dict(name="v", resolution=(0, 10))),
    ("read", dict(name="v", fps=-1.0)),
    ("read", dict(name="v", method="annealing")),
    ("read", dict(name="")),
    ("read", dict(name="v", priority="urgent")),
    ("read", dict(name="v", priority=None)),
    ("read", dict(name="v", deadline_ms=-1)),
    ("read", dict(name="v", deadline_ms="soon")),
    ("write", dict(name="v", codec="HEVC", gop_frames=10, tiles=(2, 2))),
    ("write", dict(name="v", codec="av1-maybe")),
    ("write", dict(name="v", fps=0.0)),
    ("write", dict(name="v", gop_frames=0)),
]


def _verdict(S, kind, kw):
    cls = S.ReadSpec if kind == "read" else S.WriteSpec
    try:
        return ("ok", dataclasses.astuple(cls(**kw)))
    except Exception as exc:  # noqa: BLE001 - the verdict is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("kind,kw", SPEC_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(SPEC_CASES)])
def test_spec_verdicts_match_reference(kind, kw):
    """Both packages accept and canonicalize the same specs, and refuse
    the same ones with the same exception and message."""
    assert _verdict(tspec, kind, kw) == _verdict(jspec, kind, kw)


def test_joint_plans_match_reference(tmp_path, clip):
    """The same batch of overlapping and mixed specs plans the same
    segments, demands and assignments in both packages, and returns
    the same frames."""
    j = JVSS(str(tmp_path / "j"), config=JConfig(backend="local"))
    t = VSS(str(tmp_path / "t"), config=VSSConfig(backend="local"))
    try:
        kws = [dict(t=(0.0, 1.5)), dict(t=(0.5, 2.0), priority=4),
               dict(t=(1.0, 2.0), resolution=(64, 48)),
               dict(t=(0.2, 0.9), codec="tvc-med")]
        out = []
        for vss, S in ((j, jspec), (t, tspec)):
            vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
            out.append(vss.read_batch(
                [S.ReadSpec(name="v", cache=False, **kw) for kw in kws]))
        for a, b in zip(*out):
            assert b.plan.segments == a.plan.segments
            assert b.plan.problem.demands == a.plan.problem.demands
            assert b.plan.selection.assignment == a.plan.selection.assignment
            assert np.array_equal(b.frames, a.frames)
    finally:
        j.close()
        t.close()


def test_cost_tables_match_reference(tmp_path):
    """The shipped tables and the io cost per kind are the reference's,
    and a calibration file either package saves loads in the other."""
    assert DEFAULT_IO_TABLE == jcost.DEFAULT_IO_TABLE
    cj, ct = jcost.CostModel.default(), CostModel.default()
    assert ct.table == cj.table and ct.io_table == cj.io_table
    for kind in ("memory", "localfs", "remote", "tiered", "nope"):
        for n in (0, 1 << 10, 1 << 20, 5 << 20):
            assert ct.io_cost(kind, n) == cj.io_cost(kind, n)
    for codec_pair, pixels in ((("rgb", "tvc-hi"), 960 * 540),
                               (("tvc-med", "rgb"), 1920 * 1080),
                               (("tvc-lo", "tvc-hi"), 333 * 77)):
        assert ct.alpha(*codec_pair, pixels) == cj.alpha(*codec_pair, pixels)
    ct.io_table["remote"] = (321.0, 0.25)
    ct.save(str(tmp_path / "t.json"))
    assert jcost.CostModel.load(str(tmp_path / "t.json")).io_table == \
        ct.io_table
    cj.io_table["memory"] = (9.0, 0.125)
    cj.save(str(tmp_path / "j.json"))
    assert CostModel.load(str(tmp_path / "j.json")).io_table == cj.io_table
