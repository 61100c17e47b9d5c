"""LRU_VSS eviction policy (§4): the reference's `tests/test_cache.py`
on the port (CPU), plus the same eviction decisions in both packages."""
import dataclasses

import pytest
import torch

from repro.core.cache import CachePolicy as JCachePolicy
from repro.core.config import VSSConfig as JConfig
from repro.core.store import VSS as JVSS
from repro_torch.core.cache import CachePolicy
from repro_torch.core.config import VSSConfig
from repro_torch.core.quality import exact_psnr
from repro_torch.core.store import VSS as _PortVSS


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


def _fill(vss, clip, budget):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=budget)


def test_baseline_guard_protects_last_lossless_cover(vss, clip):
    _fill(vss, clip, budget=1)  # budget below even the original's size
    evicted = vss.cache.maybe_evict("v")
    # the original is the only ≥τ cover: guard = +∞ on every page
    assert evicted == []
    out = vss.read("v", codec="rgb", cache=False).frames
    assert exact_psnr(out, clip) >= 40.0


def test_eviction_respects_budget_when_possible(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=10**9)
    vss.read("v", codec="rgb")  # large raw cached view (≥τ cover too)
    before = vss.catalog.total_bytes("v")
    vss.catalog.set_budget("v", before // 2)
    vss.cache.maybe_evict("v")
    after = vss.catalog.total_bytes("v")
    assert after < before
    out = vss.read("v", codec="rgb", cache=False).frames
    assert exact_psnr(out, clip) >= 40.0  # a lossless cover survived


def test_position_offset_prefers_run_ends(vss, clip):
    """With equal LRU, the policy should evict run ends before middles
    (anti-fragmentation)."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=10,
              budget_bytes=10**9)
    vss.read("v", codec="tvc-med")  # cached view with 2 GOPs... make more
    policy = CachePolicy()
    seqs = policy.sequence_numbers(vss.catalog, "v")
    by_phys = {}
    for p in vss.catalog.physicals_for("v"):
        gops = vss.catalog.gops_for(p.physical_id)
        if len(gops) >= 3 and not p.is_original:
            ends = [seqs[gops[0].gop_id], seqs[gops[-1].gop_id]]
            mids = [seqs[g.gop_id] for g in gops[1:-1]]
            assert min(mids) >= min(ends)
            by_phys[p.physical_id] = True
    # at least one multi-GOP cached view was checked
    # (tvc-med of 60 frames @ default GOP 30 → 2 GOPs; force via raw read)
    vss.read("v", codec="rgb")
    seqs = policy.sequence_numbers(vss.catalog, "v")
    checked = False
    for p in vss.catalog.physicals_for("v"):
        gops = vss.catalog.gops_for(p.physical_id)
        if len(gops) >= 3:
            ends = [seqs[gops[0].gop_id], seqs[gops[-1].gop_id]]
            mids = [s for g in gops[1:-1]
                    if (s := seqs[g.gop_id]) != float("inf")]
            if mids and min(ends) != float("inf"):
                assert min(mids) >= min(ends)
                checked = True
    assert checked


def test_downsampled_view_never_counts_as_cover(vss, clip):
    """Regression: a thumbnail view's (own-resolution) bound is ~0 but it
    must NOT un-guard the full-resolution original — eviction would
    otherwise destroy the only full-detail copy."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi",
              budget_bytes=vss.catalog.total_bytes("v") * 3
              if vss.catalog.logical_exists("v") else None)
    vss.catalog.set_budget("v", vss.catalog.total_bytes("v") + 50_000)
    vss.read("v", resolution=(64, 48), codec="rgb",
             quality_eps_db=20.0)  # big raw thumbnail busts the budget
    # full-resolution read must still be possible at lossless quality
    out = vss.read("v", codec="rgb", cache=False).frames
    assert out.shape == clip.shape
    assert exact_psnr(out, clip) >= 40.0


def test_ordinary_lru_mode(vss, clip):
    """use_vss_offsets=False degrades to plain LRU (the paper's baseline)."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=10**9)
    vss.read("v", codec="tvc-med")
    policy = CachePolicy(use_vss_offsets=False)
    seqs = policy.sequence_numbers(vss.catalog, "v")
    finite = [s for s in seqs.values() if s != float("inf")]
    gops = [g for p in vss.catalog.physicals_for("v")
            for g in vss.catalog.gops_for(p.physical_id)]
    by_id = {g.gop_id: g for g in gops}
    for gid, s in seqs.items():
        if s != float("inf"):
            assert s == float(by_id[gid].lru_seq)


def _catalog_state(vss, name):
    """Every GOP the catalog holds for ``name`` with its bytes, LRU stamp
    and physical's codec."""
    return sorted(
        (p.codec, p.t_start, p.t_end, g.start_frame, g.num_frames,
         g.nbytes, g.lru_seq, g.path)
        for p in vss.catalog.physicals_for(name)
        for g in vss.catalog.gops_for(p.physical_id))


@pytest.mark.parametrize("offsets", [True, False])
def test_eviction_matches_reference(tmp_path, clip, offsets):
    """Both packages, the same writes, cached reads and budget cut: the
    same sequence numbers, the same GOPs evicted, the same catalog."""
    stores = [JVSS(str(tmp_path / "j"), config=JConfig(backend="local")),
              VSS(str(tmp_path / "t"), config=VSSConfig(backend="local"))]
    try:
        seen = []
        for vss, policy in zip(stores, (JCachePolicy, CachePolicy)):
            vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=10,
                      budget_bytes=10**9)
            vss.read("v", codec="tvc-med")
            vss.read("v", t=(0.5, 1.5), codec="rgb")
            seqs = policy(use_vss_offsets=offsets).sequence_numbers(
                vss.catalog, "v")
            before = _catalog_state(vss, "v")
            vss.catalog.set_budget("v", vss.catalog.total_bytes("v") // 2)
            evicted = vss.cache.maybe_evict("v")
            seen.append((sorted(seqs.items()), before, sorted(evicted),
                         _catalog_state(vss, "v")))
        assert seen[1] == seen[0]
        assert seen[0][2], "the budget cut evicted nothing"
    finally:
        for vss in stores:
            vss.close()
