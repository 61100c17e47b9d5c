"""The port's tiled layout and region reads against the benchmark's plain
reference (``vssbench/reference/roi.py``) on the CPU.

A seeded 128x96 clip of two 30-frame GOPs is written in the ``h264`` tier
on a (3, 3) grid (fig. 28's) and on a ragged (4, 7) grid (columns of 18
and 19 pixels).  Held against the reference: every tile object byte for
byte against the reference's encoding of that tile's pixels, and region
reads past the cache (a box inside one tile, across one edge, across one
corner, the whole frame; over one GOP and across two) against the
reference's whole-frame decode cut to the box.  Each read must fetch its
covering tiles and no other (``vss_tile_fetches_total``), count as a tile
read only when it covers part of the grid (``vss_tile_reads_total``), and
carry one ``stitch`` span in its trace."""
import pytest
import torch

from repro_torch.core.config import VSSConfig
from repro_torch.core.spec import WriteSpec
from repro_torch.core.store import VSS
from repro_torch.core.types import tile_key
from repro_torch.data.video import synthesize_road
from repro_torch.obs import MetricsRegistry
from vssbench.reference import roi as ref_roi
from vssbench.reference import tvc as ref_tvc

torch.set_num_threads(1)

H, W, GOP, FPS = 96, 128, 30, 30.0
TIER = "h264"
GRIDS = {"3x3": (3, 3), "4x7": (4, 7)}
PLACEMENTS = ("tile", "edge", "corner", "whole")
INTERVALS = {"one_gop": (1.0, 2.0), "two_gops": (0.5, 1.5)}


def _box(grid, placement):
    """A box of ``placement`` around tile (1, 1) of ``grid``."""
    x0, y0, x1, y1 = ref_roi.tile_box(H, W, grid, 1, 1)
    qx, qy = (x1 - x0) // 4, (y1 - y0) // 4
    if placement == "tile":
        return x0 + qx, y0 + qy, x1 - qx, y1 - qy
    if placement == "edge":  # across the edge to tile (1, 2)
        return x1 - 2 * qx, y0 + qy, x1 + qx, y1 - qy
    if placement == "corner":  # across the corner of tiles (0..1, 0..1)
        return x0 - 2 * qx, y0 - 2 * qy, x0 + qx, y0 + qy
    return 0, 0, W, H


@pytest.fixture(scope="module")
def clip():
    return synthesize_road(2 * GOP, width=W, height=H, seed=32)


@pytest.fixture(scope="module")
def recon(clip):
    """The reference's decode of the whole frames, GOP by GOP."""
    t = ref_tvc.tier(TIER)
    return torch.cat([ref_tvc.encode(torch.from_numpy(clip[s:s + GOP]), t)[2]
                      for s in range(0, clip.shape[0], GOP)])


@pytest.fixture(scope="module")
def stores(tmp_path_factory, clip):
    out = {}
    for name, grid in GRIDS.items():
        store = VSS(str(tmp_path_factory.mktemp(name)), config=VSSConfig(
            backend="local", device="cpu", registry=MetricsRegistry()))
        meta = store.write_spec(WriteSpec(name="v", fps=FPS, codec=TIER,
                                          gop_frames=GOP, tiles=grid), clip)
        out[name] = (store, meta)
    yield out
    for store, _ in out.values():
        store.close()


@pytest.mark.parametrize("grid", GRIDS)
def test_each_tile_object_is_the_reference_encoding_of_its_pixels(
        stores, clip, grid):
    store, meta = stores[grid]
    rows, cols = GRIDS[grid]
    gops = store.catalog.gops_for(meta.physical_id)
    assert len(gops) == 2
    for g in gops:
        frames = torch.from_numpy(
            clip[g.start_frame:g.start_frame + g.num_frames])
        for r in range(rows):
            for c in range(cols):
                want = ref_roi.tile_blob(frames, ref_tvc.tier(TIER),
                                         GRIDS[grid], r, c)
                assert store.backend.get(tile_key(g.path, r, c)) == want


def _count(node, name):
    return int(node["name"] == name) + sum(
        _count(c, name) for c in node.get("children", ()))


@pytest.mark.parametrize("interval", INTERVALS)
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_region_read_equals_the_reference_crop(stores, recon, grid,
                                               placement, interval):
    store, _ = stores[grid]
    box = _box(GRIDS[grid], placement)
    cover = ref_roi.covering(H, W, GRIDS[grid], box)
    assert len(cover) == {"tile": 1, "edge": 2, "corner": 4,
                          "whole": GRIDS[grid][0] * GRIDS[grid][1]}[
                              placement]
    s, e = INTERVALS[interval]
    f0, f1 = int(s * FPS), int(e * FPS)
    reg = store.registry
    fetches0 = reg.value("vss_tile_fetches_total")
    reads0 = reg.value("vss_tile_reads_total")
    got = store.read("v", t=(s, e), roi=box, codec="rgb",
                     cache=False).frames
    want = ref_roi.crop(recon, f0, f1, box)
    assert torch.equal(torch.from_numpy(got), want)
    gops = -(-f1 // GOP) - f0 // GOP
    assert reg.value("vss_tile_fetches_total") - fetches0 == \
        len(cover) * gops
    assert reg.value("vss_tile_reads_total") - reads0 == \
        int(placement != "whole")
    trace, = store.recent_traces(1)
    assert _count(trace, "stitch") == 1
