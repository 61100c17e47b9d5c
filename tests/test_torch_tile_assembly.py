"""A tiled region read assembled in one pass, held against the stitch
and cut it replaced, on the CPU.

A seeded 128x96 clip of two 30-frame GOPs is written in the ``h264``
tier on a (3, 3) grid and on a ragged (4, 7) grid (columns of 18 and 19
pixels).  Each read runs twice on the same store: as the port runs it,
and with ``VSS._extract`` swapped for `_legacy_extract`, a copy of the
algorithm before the one-pass assembly (every covering tile of every
GOP stitched by three ``np.concatenate`` calls, then the frames and the
box cut from the stitched frames).  The answers must agree bit for bit
and shape for shape: a box inside one tile, across an edge, across a
corner, the whole frame and flush with the right and bottom edges, over
one GOP and over two; at half the frame rate; resized after the cut; as
hevc through ``_execute_encoded``; and boxes that reach past the frame,
which only a direct ``_extract`` call can ask for.

Besides: the answer is C-contiguous, shares no memory with any decoded
tile the read kept, is not changed by writing into another answer, and
its read carries one ``stitch`` span whose ``bytes`` is its ``nbytes``."""
import numpy as np
import pytest
import torch

from repro_torch.core import store as store_mod
from repro_torch.core.config import VSSConfig
from repro_torch.core.resize import resample
from repro_torch.core.spec import ReadSpec, WriteSpec
from repro_torch.core.store import VSS, Run
from repro_torch.core.types import tile_bounds, tile_key, tiles_covering
from repro_torch.data.video import synthesize_road
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

H, W, GOP, FPS = 96, 128, 30, 30.0
GRIDS = {"3x3": (3, 3), "4x7": (4, 7)}
PLACEMENTS = ("tile", "edge", "corner", "whole", "flush")
INTERVALS = {"one_gop": (1.0, 2.0), "two_gops": (0.5, 1.5)}


def _box(grid, placement):
    """A box of ``placement`` around tile (1, 1) of ``grid``."""
    y0, y1 = tile_bounds(H, grid[0])[1]
    x0, x1 = tile_bounds(W, grid[1])[1]
    qx, qy = (x1 - x0) // 4, (y1 - y0) // 4
    if placement == "tile":
        return x0 + qx, y0 + qy, x1 - qx, y1 - qy
    if placement == "edge":  # across the edge to tile (1, 2)
        return x1 - 2 * qx, y0 + qy, x1 + qx, y1 - qy
    if placement == "corner":  # across the corner of tiles (0..1, 0..1)
        return x0 - 2 * qx, y0 - 2 * qy, x0 + qx, y0 + qy
    if placement == "flush":  # to the right and bottom edges
        return W - 3 * qx, H - 3 * qy, W, H
    return 0, 0, W, H


def _legacy_stitch(store, p, gops, box):
    """Every covering tile of ``gops`` decoded and stitched by band, by
    row and by GOP; with the stitched region's pixel origin."""
    rows, cols = tiles_covering(p.tiles, p.width, p.height, box)
    ys = tile_bounds(p.height, p.tiles[0])
    xs = tile_bounds(p.width, p.tiles[1])
    tile = {
        (g.gop_id, r, c): store._decode_gop_bytes(
            store.backend.get(tile_key(g.path, r, c)))
        for g in gops for r in rows for c in cols
    }
    return np.concatenate([
        np.concatenate([
            np.concatenate([tile[g.gop_id, r, c] for c in cols], axis=2)
            for r in rows
        ], axis=1)
        for g in gops
    ], axis=0), (xs[cols[0]][0], ys[rows[0]][0])


def _legacy_extract(store, run, a, b, roi, resolution, out_fps, io):
    """``VSS._extract`` of a tiled run before the one-pass assembly."""
    p = run.physical
    f0, f1 = store._clamp_frames(run, p.frame_at(a), p.frame_at(b))
    gops = [
        g for g in run.gops
        if g.start_frame < f1 and g.start_frame + g.num_frames > f0
    ]
    lx0, ly0, lx1, ly1 = store._local_box(p, roi)
    frames, (ox, oy) = _legacy_stitch(store, p, gops, (lx0, ly0, lx1, ly1))
    base = gops[0].start_frame
    frames = frames[f0 - base : f1 - base]
    step = int(round(p.fps / out_fps))
    if step > 1:
        frames = frames[::step]
    frames = frames[:, ly0 - oy : ly1 - oy, lx0 - ox : lx1 - ox]
    frames = resample(frames, resolution, device=store.device)
    return frames, [g.gop_id for g in gops]


def _legacy(store, call):
    """``call()`` with the store's ``_extract`` swapped for the legacy
    one."""
    store._extract = lambda *a: _legacy_extract(store, *a)
    try:
        return call()
    finally:
        del store._extract


@pytest.fixture(scope="module")
def clip():
    return synthesize_road(2 * GOP, width=W, height=H, seed=33)


@pytest.fixture(scope="module")
def stores(tmp_path_factory, clip):
    out = {}
    for name, grid in GRIDS.items():
        store = VSS(str(tmp_path_factory.mktemp(name)), config=VSSConfig(
            backend="local", device="cpu", registry=MetricsRegistry()))
        meta = store.write_spec(WriteSpec(name="v", fps=FPS, codec="h264",
                                          gop_frames=GOP, tiles=grid), clip)
        out[name] = (store, meta)
    yield out
    for store, _ in out.values():
        store.close()


@pytest.fixture()
def kept(monkeypatch):
    """Every decoded frame array the reads' `_BatchIO` kept."""
    arrays = []
    real = store_mod._BatchIO.keep

    def keep(self, frames, *a, **kw):
        arrays.append(frames)
        return real(self, frames, *a, **kw)

    monkeypatch.setattr(store_mod._BatchIO, "keep", keep)
    return arrays


def _stitch_spans(node):
    here = [node] if node["name"] == "stitch" else []
    return here + [s for c in node.get("children", ())
                   for s in _stitch_spans(c)]


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("interval", INTERVALS)
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_region_read_equals_the_stitch_and_cut(stores, kept, grid,
                                               placement, interval):
    store, _ = stores[grid]
    kw = dict(t=INTERVALS[interval], roi=_box(GRIDS[grid], placement),
              codec="rgb", cache=False)
    got = store.read("v", **kw).frames
    trace, = store.recent_traces(1)
    tiles = list(kept)
    want = _legacy(store, lambda: store.read("v", **kw).frames)
    _same(got, want)
    assert got.flags.c_contiguous
    assert tiles and not any(np.shares_memory(got, t) for t in tiles)
    span, = _stitch_spans(trace)
    assert span["attrs"]["bytes"] == got.nbytes


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_half_frame_rate_equals_the_stitch_and_cut(stores, grid, placement):
    store, _ = stores[grid]
    kw = dict(t=(0.5, 1.5), roi=_box(GRIDS[grid], placement), fps=15.0,
              codec="rgb", cache=False)
    got = store.read("v", **kw).frames
    want = _legacy(store, lambda: store.read("v", **kw).frames)
    assert got.shape[0] == 15
    _same(got, want)
    assert got.flags.c_contiguous


@pytest.mark.parametrize("resize", ("box_mean", "bilinear"))
@pytest.mark.parametrize("grid", GRIDS)
def test_resized_answer_equals_the_stitch_and_cut(stores, kept, grid,
                                                  resize):
    store, _ = stores[grid]
    box = (30, 20, 70, 60)  # across tiles of both grids, 40 x 40
    res = (20, 20) if resize == "box_mean" else (27, 13)
    kw = dict(t=(0.5, 1.5), roi=box, resolution=res, codec="rgb",
              cache=False)
    got = store.read("v", **kw).frames
    tiles = list(kept)
    want = _legacy(store, lambda: store.read("v", **kw).frames)
    assert got.shape == (30, res[1], res[0], 3)
    _same(got, want)
    assert got.flags.c_contiguous
    assert not any(np.shares_memory(got, t) for t in tiles)


@pytest.mark.parametrize("interval", INTERVALS)
@pytest.mark.parametrize("grid", GRIDS)
def test_hevc_answer_equals_the_stitch_and_cut(stores, grid, interval):
    store, _ = stores[grid]
    kw = dict(t=INTERVALS[interval], roi=_box(GRIDS[grid], "corner"),
              codec="hevc", cache=False)
    got = store.read("v", **kw).encoded
    want = _legacy(store, lambda: store.read("v", **kw).encoded)
    assert len(got) == len(want) >= 1
    assert got == want


@pytest.mark.parametrize("box", (
    (100, 70, 140, 110),  # past the right and bottom edges
    (-3, 10, 20, 40),  # a negative start: wraps to nothing
    (10, -3, 40, 20),
    (-3, -5, W + 2, H + 4),  # a negative start and past the far edges
    (-40, 10, 60, 40),
), ids=("past_far_edges", "negative_left", "negative_top",
        "around_the_frame", "negative_start_far"))
@pytest.mark.parametrize("grid", GRIDS)
def test_a_box_past_the_frame_is_cut_as_a_slice_cuts(stores, grid, box):
    store, meta = stores[grid]
    run = Run(meta, store.catalog.gops_for(meta.physical_id))
    stitched, (ox, oy) = _legacy_stitch(store, meta, run.gops, box)
    cut = stitched[15:45, box[1] - oy:box[3] - oy, box[0] - ox:box[2] - ox]
    args = (run, 0.5, 1.5, box, (cut.shape[2], cut.shape[1]), FPS)
    want, gops = _legacy_extract(store, *args,
                                 store_mod._BatchIO(store.backend))
    got, got_gops = store._extract(*args, store_mod._BatchIO(store.backend))
    assert got_gops == gops == [g.gop_id for g in run.gops]
    _same(want, cut)
    _same(got, want)


@pytest.mark.parametrize("grid", GRIDS)
def test_writing_into_an_answer_leaves_another_unchanged(stores, kept, grid):
    """Two reads, and a batch of two specs that share the decoded tiles
    of their common GOP: each answer is memory of its own."""
    store, _ = stores[grid]
    box = _box(GRIDS[grid], "edge")
    first = store.read("v", t=(0.5, 1.5), roi=box, cache=False).frames
    want = first.copy()
    first[...] = 255 - first
    again = store.read("v", t=(0.5, 1.5), roi=box, cache=False).frames
    _same(again, want)

    del kept[:]
    specs = [ReadSpec("v", t=t, roi=box, cache=False)
             for t in ((0.5, 1.5), (0.5, 1.0))]
    a, b = (r.frames for r in store.read_batch(specs))
    tiles = list(kept)
    b_want = b.copy()
    a[...] = 0
    _same(b, b_want)
    _same(b, want[:15])
    assert not any(np.shares_memory(x, t) for x in (a, b) for t in tiles)
