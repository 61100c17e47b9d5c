"""The joint pass's spans and counters in the port, on the CPU.

The pair is ``configs/vss_paper.py``'s Visual Road 1K-75 at its
CPU scale (160x96, 75 % overlap, seed 104), written as the benchmark's
``vroad-1k-75`` writes it (h264, 30-frame GOPs).  Each span of the pass
attaches to the span open around it, so a pass run inside a root span
leaves a tree; each pair Algorithm 1 ran on counts once under its
outcome."""
import numpy as np
import pytest
import torch

from repro_torch.configs.vss_paper import DATASETS
from repro_torch.core import features
from repro_torch.core.config import VSSConfig
from repro_torch.core.store import VSS
from repro_torch.data.video import synthesize_overlapping_pair
from repro_torch.obs import MetricsRegistry, Tracer

torch.set_num_threads(1)

VROAD_1K_75 = next(d for d in DATASETS if d.name == "vroad-1k-75")
OUTCOMES = ("joint", "duplicate", "abort", "no_h")
STAGES = ("fingerprint", "correspond", "estimate", "verify", "encode",
          "reconstruct")


@pytest.fixture(scope="module")
def pair():
    d = VROAD_1K_75
    left, right, _ = synthesize_overlapping_pair(
        30, width=d.width, height=d.height, overlap=d.overlap, seed=d.seed)
    return left, right


def _store(root, left, right):
    vss = VSS(str(root), config=VSSConfig(device="cpu",
                                          registry=MetricsRegistry()))
    vss.write("cam_l", left, fps=30.0, codec="h264", gop_frames=30)
    vss.write("cam_r", right, fps=30.0, codec="h264", gop_frames=30)
    return vss


def _counts(vss):
    reg = vss.registry
    out = {o: reg.value("vss_joint_pairs_total", {"outcome": o})
           for o in OUTCOMES}
    out["candidates"] = reg.value("vss_joint_candidates_total")
    out["gops"] = reg.value("vss_joint_gops_total")
    return out


def _names(node):
    return [c["name"] for c in node.get("children", [])]


def test_a_joint_pass_leaves_a_tree_of_its_stages(tmp_path, pair):
    vss = _store(tmp_path / "vss", *pair)
    try:
        assert "vss_joint" not in vss.registry.render_prometheus()
        tracer = Tracer()
        with tracer.span("pass"):
            ids = vss.apply_joint_compression(["cam_l", "cam_r"])
        assert len(ids) == 1
        (root,) = tracer.recent()
        # the originals' decodes (the codec's spans) sit beside the stages
        assert [n for n in _names(root) if n in STAGES] == [
            "fingerprint", "fingerprint", "correspond", "estimate",
            "verify", "encode"]
        assert "h2d" in _names(root)
        encode = root["children"][-1]
        codec = _names(encode)
        assert codec.count("h2d") == 3 and codec.count("d2h") == 3
        assert any(n.startswith("deflate.") for n in codec)
        side_b = vss.catalog.get_gop(
            vss.catalog.get_joint(ids[0])["gop_b"])
        name = vss.catalog.get_physical(side_b.physical_id).logical
        vss.read(name, cache=False)
        (read,) = vss.recent_traces(1)
        decode = next(c for c in read["children"] if c["name"] == "decode")
        (rebuild,) = [c for c in decode["children"]
                      if c["name"] == "reconstruct"]
        assert _names(rebuild).count("inflate.zlib") + _names(
            rebuild).count("inflate.zstd") >= 3
        assert _counts(vss) == {"joint": 1, "duplicate": 0, "abort": 0,
                                "no_h": 0, "candidates": 1, "gops": 2}
        assert "vss_joint_pairs_total" in vss.registry.render_prometheus()
    finally:
        vss.close()


def _no_homography(monkeypatch):
    monkeypatch.setattr(features, "estimate_homography",
                        lambda *a, **k: None)


@pytest.mark.parametrize("outcome", ["duplicate", "abort", "no_h"])
def test_each_outcome_is_counted(tmp_path, pair, monkeypatch, outcome):
    left, right = pair
    tau_db = 24.0
    if outcome == "duplicate":
        right = left.copy()
    elif outcome == "abort":
        tau_db = 1000.0  # no frame verifies, before or after re-estimating
    else:
        _no_homography(monkeypatch)
    vss = _store(tmp_path / "vss", left, right)
    try:
        ids = vss.apply_joint_compression(["cam_l", "cam_r"], tau_db=tau_db)
        assert len(ids) == (outcome == "duplicate")
        want = {o: float(o == outcome) for o in OUTCOMES}
        want.update(candidates=1.0,
                    gops=2.0 if outcome == "duplicate" else 0.0)
        assert _counts(vss) == want
    finally:
        vss.close()


def test_spans_build_nothing_without_a_parent(tmp_path, pair):
    """Outside any span and with no profiler, the pass builds no tree
    and the store's read traces hold only reads."""
    vss = _store(tmp_path / "vss", *pair)
    try:
        vss.apply_joint_compression(["cam_l", "cam_r"])
        assert vss.recent_traces() == []
        frames = vss.read("cam_r", cache=False).frames
        assert frames.shape == (30, 96, 160, 3) and frames.dtype == np.uint8
    finally:
        vss.close()
