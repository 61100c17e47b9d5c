"""Sub-GOP ranged reads and the tiled ROI layout: the port against the
reference on the CPU.

Both packages write the same seeded clip (60 frames of 128x96, two
30-frame GOPs, as ``hevc``) untiled, on a (3, 3) grid (fig28's) and on a
(4, 7) grid (tile widths 18 and 19), each into a fresh ``local`` store
with a registry of its own.  Then, past the cache: prefix trims of 1, 3,
22 and 23 frames at the start of each GOP (22 is the last within
``RANGED_HI_FRACTION`` = 0.75 of a GOP: a ranged prefix fetch on an
untiled video; 23 takes the whole object), ROI reads inside one tile,
across the 2x2 tiles of the first grid corner, of the whole frame and
across at half resolution, and one ``read_batch`` of three overlapping
ROI specs.  Held between the two packages: every stored object byte for
byte, every read's frames bit for bit, and each read's change in
``vss_read_ranged_fetches_total``, ``vss_read_ranged_bytes_saved_total``,
``vss_tile_fetches_total``, ``vss_tile_reads_total`` and the read path's
GOPs decoded, objects fetched and bytes fetched.  Planted faults
in the port (the stitched tiles one column off, a ranged prefix one frame
short) must fail the same comparison."""
import numpy as np
import pytest
import torch

from repro.core.config import VSSConfig as JConfig
from repro.core.spec import ReadSpec as JReadSpec
from repro.core.spec import WriteSpec as JWriteSpec
from repro.core.store import VSS as JVSS
from repro.core.types import tile_keys
from repro.obs import MetricsRegistry as JRegistry
from repro_torch.core import store as tstore_mod
from repro_torch.core.config import VSSConfig as TConfig
from repro_torch.core.resize import resample as tresample
from repro_torch.core.spec import ReadSpec as TReadSpec
from repro_torch.core.spec import WriteSpec as TWriteSpec
from repro_torch.core.store import VSS as TVSS
from repro_torch.obs import MetricsRegistry as TRegistry

torch.set_num_threads(1)

GOP = 30
TILINGS = {"untiled": None, "3x3": (3, 3), "4x7": (4, 7)}
COUNTERS = ("vss_read_ranged_fetches_total",
            "vss_read_ranged_bytes_saved_total", "vss_tile_fetches_total",
            "vss_tile_reads_total", "vss_read_gops_decoded_total",
            "vss_read_objects_fetched_total", "vss_read_fetch_bytes_total")
TRIMS = (1, 3, 22, 23)


def _bands(extent, n):
    return [((extent * i) // n, (extent * (i + 1)) // n) for i in range(n)]


def _boxes(h, w, tiles):
    """(a box inside tile (1, 1), a box straddling the 2x2 tiles around
    the first grid corner) of a ``tiles`` grid; each side even."""
    ys, xs = _bands(h, tiles[0]), _bands(w, tiles[1])
    (y0, y1), (x0, x1) = ys[1], xs[1]
    iy, ix = (y1 - y0) // 8, (x1 - x0) // 8
    ay, ax = (ys[0][1] - ys[0][0]) // 2, (xs[0][1] - xs[0][0]) // 2
    cy, cx = ys[1][0], xs[1][0]
    return (x0 + ix, y0 + iy, x1 - ix, y1 - iy), (cx - ax, cy - ay,
                                                  cx + ax, cy + ay)


class _Pair:
    """The same video written by both packages, each store with its own
    registry; ``read`` runs one read in both and returns the frames and
    the counters' changes of each."""

    def __init__(self, root, clip, tiles):
        self.regs = (JRegistry(), TRegistry())
        self.stores = (
            JVSS(str(root / "j"), config=JConfig(backend="local",
                                                 registry=self.regs[0])),
            TVSS(str(root / "t"), config=TConfig(
                backend="local", device="cpu", registry=self.regs[1])))
        for store, spec in zip(self.stores, (JWriteSpec, TWriteSpec)):
            store.write_spec(spec(name="v", fps=30.0, codec="hevc",
                                  gop_frames=GOP, tiles=tiles), clip)
        self.tiles = tiles or (1, 1)

    def _run(self, i, fn):
        before = [self.regs[i].value(c) for c in COUNTERS]
        out = fn(self.stores[i])
        return out, {c: self.regs[i].value(c) - b
                     for c, b in zip(COUNTERS, before)}

    def read(self, **kw):
        return [self._run(i, lambda s: s.read("v", cache=False, **kw).frames)
                for i in (0, 1)]

    def read_batch(self, specs):
        return [self._run(i, lambda s: [r.frames for r in s.read_batch(
            [spec(name="v", cache=False, **kw) for kw in specs])])
            for i, spec in ((0, JReadSpec), (1, TReadSpec))]

    def objects(self, i):
        """{key: bytes} of every GOP object, each tile under its key."""
        store = self.stores[i]
        out = {}
        for g in store.catalog.all_gops():
            keys = (tile_keys(g.path, self.tiles) if self.tiles != (1, 1)
                    else [g.path])
            out.update({k: store.backend.get(k) for k in keys})
        return out

    def close(self):
        for store in self.stores:
            store.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, clip):
    out = {name: _Pair(tmp_path_factory.mktemp(name), clip, tiles)
           for name, tiles in TILINGS.items()}
    yield out
    for p in out.values():
        p.close()


def _same(results):
    (fj, cj), (ft, ct) = results
    assert ft.shape == fj.shape
    assert np.array_equal(ft, fj)
    assert ct == cj
    return ft, ct


def _roi_reads(clip):
    _t, h, w, _c = clip.shape
    inside, across = _boxes(h, w, (3, 3))
    return {"inside one tile": ({"roi": inside}, inside, False),
            "across 2x2 tiles": ({"roi": across}, across, False),
            "whole frame": ({}, None, False),
            "across at half resolution": (
                {"roi": across, "resolution": ((across[2] - across[0]) // 2,
                                               (across[3] - across[1]) // 2)},
                across, True)}


def test_clip_gops_are_big_enough_for_ranged_reads(pairs):
    sizes = [len(b) for b in pairs["untiled"].objects(1).values()]
    assert len(sizes) == 2
    assert min(sizes) >= tstore_mod.MIN_RANGED_BYTES
    assert tstore_mod.RANGED_HI_FRACTION * GOP == 22.5


@pytest.mark.parametrize("tiling", TILINGS)
def test_stored_objects_equal_reference_byte_for_byte(pairs, tiling):
    pair = pairs[tiling]
    want = pair.objects(0)
    assert len(want) == 2 * pair.tiles[0] * pair.tiles[1]
    assert pair.objects(1) == want


@pytest.mark.parametrize("start", (0, GOP), ids=("gop0", "gop1"))
@pytest.mark.parametrize("hi", TRIMS)
@pytest.mark.parametrize("tiling", TILINGS)
def test_prefix_trim_matches_reference(pairs, clip, tiling, hi, start):
    pair = pairs[tiling]
    frames, counts = _same(pair.read(t=(start / 30, (start + hi) / 30)))
    assert frames.shape == (hi, *clip.shape[1:])
    whole, _ = _same(pair.read())
    assert np.array_equal(frames, whole[start:start + hi])
    ranged = tiling == "untiled" and hi <= 22
    assert counts["vss_read_ranged_fetches_total"] == int(ranged)
    assert (counts["vss_read_ranged_bytes_saved_total"] > 0) == ranged
    assert counts["vss_tile_fetches_total"] == (
        0 if tiling == "untiled" else pair.tiles[0] * pair.tiles[1])


@pytest.mark.parametrize("read", ("inside one tile", "across 2x2 tiles",
                                  "whole frame", "across at half resolution"))
@pytest.mark.parametrize("tiling", TILINGS)
def test_roi_read_matches_reference(pairs, clip, tiling, read):
    pair = pairs[tiling]
    kw, box, half = _roi_reads(clip)[read]
    frames, counts = _same(pair.read(**kw))
    x0, y0, x1, y1 = box or (0, 0, clip.shape[2], clip.shape[1])
    whole, _ = _same(pair.read())
    want = whole[:, y0:y1, x0:x1]
    if half:
        want = tresample(want, ((x1 - x0) // 2, (y1 - y0) // 2),
                         device="cpu")
    assert np.array_equal(frames, want)
    if tiling == "untiled":
        assert counts["vss_tile_fetches_total"] == 0
        return
    rows = [r for r, (a, b) in enumerate(_bands(clip.shape[1], pair.tiles[0]))
            if a < y1 and b > y0]
    cols = [c for c, (a, b) in enumerate(_bands(clip.shape[2], pair.tiles[1]))
            if a < x1 and b > x0]
    assert counts["vss_tile_fetches_total"] == 2 * len(rows) * len(cols)
    assert counts["vss_tile_reads_total"] == int(box is not None)


@pytest.mark.parametrize("tiling", TILINGS)
def test_read_batch_matches_reference(pairs, clip, tiling):
    """Three overlapping ROI specs: each covering tile of each GOP is
    fetched once for the batch."""
    pair = pairs[tiling]
    _t, h, w, _c = clip.shape
    inside, across = _boxes(h, w, (3, 3))
    shift = (across[2] - across[0]) // 2
    right = (across[0] + shift, across[1], across[2] + shift, across[3])
    specs = ({"roi": across, "t": (0.0, 1.0)},
             {"roi": inside, "t": (0.5, 2.0)},
             {"roi": right, "t": (0.2, 1.8)})
    (fj, cj), (ft, ct) = pair.read_batch(specs)
    assert ct == cj
    whole, _ = _same(pair.read())
    for spec, a, b, (f0, f1) in zip(specs, fj, ft, ((0, 30), (15, 60),
                                                    (6, 54))):
        x0, y0, x1, y1 = spec["roi"]
        assert np.array_equal(b, a)
        assert np.array_equal(b, whole[f0:f1, y0:y1, x0:x1])
    if tiling != "untiled":
        need = set()
        for spec, (f0, f1) in zip(specs, ((0, 30), (15, 60), (6, 54))):
            x0, y0, x1, y1 = spec["roi"]
            for g in range(f0 // GOP, (f1 - 1) // GOP + 1):
                for r, (a, b) in enumerate(_bands(h, pair.tiles[0])):
                    for c, (d, e) in enumerate(_bands(w, pair.tiles[1])):
                        if a < y1 and b > y0 and d < x1 and e > x0:
                            need.add((g, r, c))
        assert ct["vss_tile_fetches_total"] == len(need)


def _fault_shifted_stitch(store):
    load = store._load_tiled_frames

    def shifted(*a, **kw):
        frames, origin = load(*a, **kw)
        return np.roll(frames, 1, axis=2), origin

    return "_load_tiled_frames", shifted


def _fault_short_prefix(store):
    load = store._load_gop_prefix
    return "_load_gop_prefix", lambda g, hi, io: load(g, hi - 1, io)


@pytest.mark.parametrize("fault,tiling,kw", (
    (_fault_shifted_stitch, "3x3", {"roi": (32, 24, 96, 72)}),
    (_fault_shifted_stitch, "4x7", {}),
    (_fault_short_prefix, "untiled", {"t": (0.0, 0.1)}),
), ids=("stitch one column off 3x3", "stitch one column off 4x7",
        "prefix one frame short"))
def test_a_planted_fault_fails_the_comparison(pairs, fault, tiling, kw):
    pair = pairs[tiling]
    _same(pair.read(**kw))
    store = pair.stores[1]
    attr, fn = fault(store)
    setattr(store, attr, fn)
    try:
        with pytest.raises(AssertionError):
            _same(pair.read(**kw))
    finally:
        delattr(store, attr)
    _same(pair.read(**kw))
