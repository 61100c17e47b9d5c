"""Reads of jointly stored GOPs in the port, on the CPU: the rebuild's
counters, its spans under ``reconstruct``, its slice fetches through the
read's own GOP loader, and `VSS.gop_frames` outside any read.

Two pairs of ``configs/vss_paper.py``'s Visual Road 1K-75 at its CPU
scale (160x96, 75 % overlap, seed 104), one GOP a camera, written as the
benchmark's ``vroad-1k-75`` writes them (h264, 30-frame GOPs): the pair
itself, stored as three slices (sides a and b), and the left camera
twice, stored as a pointer (the duplicate's side b)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.vss_paper import DATASETS
from repro_torch.core import store as store_mod
from repro_torch.core.config import VSSConfig
from repro_torch.core.spec import ReadSpec
from repro_torch.core.store import VSS
from repro_torch.data.video import synthesize_overlapping_pair
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

VROAD_1K_75 = next(d for d in DATASETS if d.name == "vroad-1k-75")
SIDES = ("a", "b", "duplicate")
GOP = 30


def _open(root):
    return VSS(str(root), config=VSSConfig(device="cpu",
                                           registry=MetricsRegistry()))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A closed store: ``cam_l``/``cam_r`` jointly, ``dup_a``/``dup_b``
    as a duplicate; the names of each record's sides."""
    d = VROAD_1K_75
    left, right, _ = synthesize_overlapping_pair(
        GOP, width=d.width, height=d.height, overlap=d.overlap, seed=d.seed)
    path = tmp_path_factory.mktemp("vss")
    vss = _open(path)
    for name, frames in (("cam_l", left), ("cam_r", right),
                         ("dup_a", left), ("dup_b", left.copy())):
        vss.write(name, frames, fps=30.0, codec="h264", gop_frames=GOP)
    sides = {}
    for pair in (["cam_l", "cam_r"], ["dup_a", "dup_b"]):
        (jid,) = vss.apply_joint_compression(pair)
        rec = vss.catalog.get_joint(jid)
        for key, side in (("gop_a", "a"), ("gop_b", "b")):
            g = vss.catalog.get_gop(rec[key])
            name = vss.catalog.get_physical(g.physical_id).logical
            sides[name] = "duplicate" if rec["duplicate"] and side == "b" \
                else side
    vss.close()
    return path, sides


@pytest.fixture
def vss(root):
    v = _open(root[0])
    yield v
    v.close()


def _name(sides, side):
    return next(n for n, s in sides.items() if s == side)


def _joint_gop(vss, name):
    (p,) = [p for p in vss.catalog.physicals_for(name) if p.is_original]
    (g,) = vss.catalog.gops_for(p.physical_id)
    return g


def _rebuilds(vss):
    reg = vss.registry
    out = {s: reg.value("vss_joint_rebuilds_total", {"side": s})
           for s in SIDES}
    out["frames"] = reg.value("vss_joint_rebuild_frames_total")
    return out


def _find(node, name):
    if node["name"] == name:
        yield node
    for c in node.get("children", ()):
        yield from _find(c, name)


def test_the_fixture_stores_each_side(root):
    _, sides = root
    assert sorted(sides.values()) == ["a", "a", "b", "duplicate"]


def test_a_reopened_store_counts_each_side_it_rebuilds(vss, root):
    _, sides = root
    assert "vss_joint" not in vss.registry.render_prometheus()
    for side in SIDES:
        frames = vss.read(_name(sides, side), cache=False).frames
        assert frames.shape[0] == GOP
    want = {"a": 1.0, "b": 1.0, "duplicate": 1.0, "frames": 3.0 * GOP}
    assert _rebuilds(vss) == want
    # the duplicate's side a is stored plainly: no rebuild
    plain = next(n for n, s in sides.items() if s == "a"
                 and _joint_gop(vss, n).joint_ref is None)
    vss.read(plain, cache=False)
    assert _rebuilds(vss) == want
    text = vss.registry.render_prometheus()
    for side in SIDES:
        assert f'vss_joint_rebuilds_total{{side="{side}"}} 1' in text


@pytest.mark.parametrize("side,warps,concats", [("a", 0, 2), ("b", 1, 3)])
def test_the_rebuild_spans_sit_under_reconstruct(vss, root, side, warps,
                                                 concats):
    _, sides = root
    vss.read(_name(sides, side), cache=False)
    (read,) = vss.recent_traces(1)
    (rebuild,) = list(_find(read, "reconstruct"))
    names = [c["name"] for c in rebuild["children"]]
    assert names.count("rebuild_warp") == warps
    assert names.count("rebuild_concat") == concats
    assert all(not n.startswith("kernel.") for n in names)
    # the composite's join comes before the warp, side b's join after it
    if warps:
        w = names.index("rebuild_warp")
        assert "rebuild_concat" in names[:w] and \
            "rebuild_concat" in names[w + 1:]


@pytest.mark.parametrize("side,objects", [("a", 2), ("b", 3)])
def test_the_slices_are_fetched_through_the_reads_loader(
        vss, root, monkeypatch, side, objects):
    _, sides = root
    name = _name(sides, side)
    rec = vss.catalog.get_joint(_joint_gop(vss, name).joint_ref)
    parts = ("left", "overlap", "right")[:objects]
    keys = [seg["paths"][p] for seg in rec["segments"] for p in parts]
    seen = []
    real = store_mod._BatchIO.batch_get

    def spy(self, ks):
        seen.append(list(ks))
        return real(self, ks)

    monkeypatch.setattr(store_mod._BatchIO, "batch_get", spy)
    reg = vss.registry
    objs0 = reg.value("vss_read_objects_fetched_total")
    bytes0 = reg.value("vss_read_fetch_bytes_total")
    vss.read(name, cache=False)
    assert [k for ks in seen for k in ks] == keys
    nbytes = sum(len(vss.backend.get(k)) for k in keys)
    assert reg.value("vss_read_objects_fetched_total") - objs0 == objects
    assert reg.value("vss_read_fetch_bytes_total") - bytes0 == nbytes
    (read,) = vss.recent_traces(1)
    (rebuild,) = list(_find(read, "reconstruct"))
    fetches = [c for c in rebuild["children"] if c["name"] == "fetch"]
    assert [f["attrs"]["objects"] for f in fetches] == [objects]
    inline = [c for c in read["children"] if c["name"] == "fetch"
              and c.get("attrs", {}).get("inline")]
    assert [(f["attrs"]["objects"], f["attrs"]["bytes"]) for f in inline] \
        == [(objects, nbytes)]


@pytest.mark.parametrize("side", SIDES)
def test_gop_frames_reads_the_backend_outside_any_read(vss, root,
                                                       monkeypatch, side):
    _, sides = root
    name = _name(sides, side)
    want = vss.read(name, cache=False).frames
    traces = len(vss.recent_traces())
    reg = vss.registry
    objs0 = reg.value("vss_read_objects_fetched_total")

    def refuse(self, keys):
        raise AssertionError("gop_frames fetched through a read's loader")

    monkeypatch.setattr(store_mod._BatchIO, "batch_get", refuse)
    monkeypatch.setattr(store_mod._BatchIO, "get", refuse)
    got = vss.gop_frames(_joint_gop(vss, name))
    np.testing.assert_array_equal(got, want)
    assert len(vss.recent_traces()) == traces
    assert reg.value("vss_read_objects_fetched_total") == objs0
    assert _rebuilds(vss)[side] == 2.0


def test_read_batch_over_both_sides_gives_the_single_reads(vss, root):
    _, sides = root
    names = [n for n in ("cam_l", "cam_r")]
    singles = [vss.read(n, cache=False).frames for n in names]
    reg = vss.registry
    objs0 = reg.value("vss_read_objects_fetched_total")
    decoded0 = reg.value("vss_read_gops_decoded_total")
    out = vss.read_batch([ReadSpec(n, cache=False) for n in names])
    for got, want in zip(out, singles):
        np.testing.assert_array_equal(got.frames, want)
    # one loader a video, so each side fetches its own slices; each
    # joint GOP counts as one decode of the read path
    assert reg.value("vss_read_objects_fetched_total") - objs0 == 2 + 3
    assert reg.value("vss_read_gops_decoded_total") - decoded0 == 2
    assert _rebuilds(vss)["a"] == 2.0 and _rebuilds(vss)["b"] == 2.0
