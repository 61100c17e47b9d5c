"""Deferred compression (§5.2) and compaction (§5.3): the reference's
`tests/test_deferred_compact.py` on the port (CPU), plus byte-identical
wraps, deferred GOPs and merged views in both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compact as JC
from repro.core import deferred as jdeferred
from repro.core.config import VSSConfig as JConfig
from repro.core.store import VSS as JVSS
from repro_torch.core import compact as C
from repro_torch.core.config import VSSConfig
from repro_torch.core.deferred import is_wrapped, unwrap_bytes, wrap_bytes
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


def test_wrap_roundtrip():
    data = b"x" * 10000 + bytes(range(256))
    w = wrap_bytes(data, 3)
    assert is_wrapped(w)
    assert unwrap_bytes(w) == data
    assert len(w) < len(data)


def test_deferred_activates_over_threshold(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=3_000_000)
    # raw read caches uncompressed views → cache fraction rises
    vss.read("v", codec="rgb")
    assert vss.deferred.active("v")
    gid = vss.deferred.compress_one("v")
    assert gid is not None
    g = vss.catalog.get_gop(gid)
    assert g.zwrapped
    assert is_wrapped(vss.backend.get(g.path))
    # wrapped GOPs decode transparently on read
    out = vss.read("v", codec="rgb", cache=False).frames
    assert out.shape == clip.shape


def test_compression_level_scales_with_usage(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=10**8)
    lvl_low = vss.deferred.current_level("v")
    vss.catalog.set_budget("v", vss.catalog.total_bytes("v"))
    lvl_high = vss.deferred.current_level("v")
    assert lvl_high > lvl_low


def test_compaction_merges_contiguous_views(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", budget_bytes=10**9)
    vss.enable_compaction = False  # manual control
    vss.read("v", t=(0.0, 1.0), codec="tvc-med")
    vss.read("v", t=(1.0, 2.0), codec="tvc-med")
    phys_before = len(vss.catalog.physicals_for("v"))
    merged = C.compact(vss.catalog, "v", vss.backend)
    assert merged >= 1
    assert len(vss.catalog.physicals_for("v")) < phys_before
    # contiguous merged view serves the whole range
    r = vss.read("v", t=(0.0, 2.0), codec="tvc-med", cache=False)
    assert r.frames.shape[0] == 60


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_wrap_bytes_match_reference(level):
    rng = np.random.default_rng(level)
    data = (rng.integers(0, 8, 50_000, dtype=np.uint8).tobytes()
            + bytes(range(256)))
    w = wrap_bytes(data, level)
    assert w == jdeferred.wrap_bytes(data, level)
    assert jdeferred.unwrap_bytes(w) == unwrap_bytes(w) == data
    assert jdeferred.is_wrapped(w) and is_wrapped(w)
    assert not is_wrapped(data) and not jdeferred.is_wrapped(data)
    for unwrap in (unwrap_bytes, jdeferred.unwrap_bytes):
        with pytest.raises(ValueError, match="not a deferred-compressed"):
            unwrap(data)


def _objects(vss):
    return {g.path: vss.backend.get(g.path) for g in vss.catalog.all_gops()}


def test_deferred_and_compaction_match_reference(tmp_path, clip):
    """The same writes, raw reads, deferred steps and compaction in both
    packages: the same GOPs wrapped at the same levels, the same merged
    views, the same objects byte for byte and the same frames."""
    stores = [JVSS(str(tmp_path / "j"), config=JConfig(backend="local")),
              VSS(str(tmp_path / "t"), config=VSSConfig(backend="local"))]
    try:
        seen = []
        for vss, compact in zip(stores, (JC.compact, C.compact)):
            vss.write("v", clip, fps=30.0, codec="tvc-hi",
                      budget_bytes=3_000_000)
            vss.enable_compaction = False
            vss.read("v", t=(0.0, 1.0), codec="rgb")
            vss.read("v", t=(1.0, 2.0), codec="rgb")
            steps = [(vss.deferred.active("v"),
                      vss.deferred.current_level("v"),
                      vss.deferred.compress_one("v")) for _ in range(3)]
            merged = compact(vss.catalog, "v", vss.backend)
            frames = vss.read("v", codec="rgb", cache=False).frames
            seen.append((steps, merged, len(vss.catalog.physicals_for("v")),
                         _objects(vss), frames))
        for a, b in zip(seen[0][:4], seen[1][:4]):
            assert b == a
        assert np.array_equal(seen[1][4], seen[0][4])
        assert any(gid is not None for _a, _l, gid in seen[0][0])
    finally:
        for vss in stores:
            vss.close()
