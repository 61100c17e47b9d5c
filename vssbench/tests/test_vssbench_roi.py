"""The tiled region-read cell: its reads cover the tiles their placement
names, and faults planted in the tile path are caught or read by the
metric that owns them, on the CPU rehearsal of the cell.

``tile_fetch_share.roi_tiled`` reads 17.8 % by construction: a block of
10 reads covers 6 x 1 + 3 x 2 + 1 x 4 = 16 of its 90 tile objects."""
import itertools
import json
import math
import sys
import types
from pathlib import Path

import pytest

from vssbench import harness
from vssbench.devtrace import DeviceTrace
from vssbench.reference import roi as ref_roi
from vssbench.traffic import roi_reads

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import FULL  # noqa: E402
from test_vssbench_rehearsal import SEED, SHRINK  # noqa: E402

CELL = "vroad-2k-roi-tiled-reads"
SHARE = 100.0 * 16 / 90
COVERS = {"tile": 1, "edge": 2, "corner": 4}


def _run(*, trace=False, seconds=0.4):
    return harness.execute(CELL, seed=SEED, seconds=seconds, trace=trace,
                           device="cpu", shrink=SHRINK, bench=FULL,
                           own_process=False)


def _reads(shrink, n, seed=SEED):
    run = harness.Run(CELL, seed=seed, seconds=1.0, trace=False,
                      device="cpu", bench=FULL, shrink=shrink)
    try:
        n_frames = int(run.config["seconds"] * run.config["fps"])
        reads = list(itertools.islice(
            roi_reads.requests(run, n_frames, "window"), n))
        return run.config, run.traffic, n_frames, reads
    finally:
        run.cleanup()


@pytest.mark.parametrize("shrink", [None, SHRINK], ids=["1920x1080",
                                                         "96x54"])
def test_each_box_covers_the_tiles_its_placement_names(shrink):
    cfg, traffic, n_frames, reads = _reads(shrink, 300)
    h, w, tiles = cfg["height"], cfg["width"], cfg["tiles"]
    lo, hi = traffic["box_tiles"]
    assert (lo, hi) == (0.5, 1.0)
    for p in reads:
        assert p["f1"] - p["f0"] == cfg["gop_frames"]
        assert p["f0"] % cfg["fps"] == 0 and p["f1"] <= n_frames
        x0, y0, x1, y1 = p["box"]
        assert 0 <= x0 < x1 <= w and 0 <= y0 < y1 <= h
        cover = ref_roi.covering(h, w, tiles, p["box"])
        assert len(cover) == COVERS[p["span"]], p
        # each side from half the side of the tile it starts in to all of it
        r, c = cover[0]
        tx0, ty0, tx1, ty1 = ref_roi.tile_box(h, w, tiles, r, c)
        assert math.ceil(lo * (tx1 - tx0)) <= x1 - x0 <= hi * (tx1 - tx0)
        assert math.ceil(lo * (ty1 - ty0)) <= y1 - y0 <= hi * (ty1 - ty0)
    blocks = [reads[k:k + 10] for k in range(0, len(reads), 10)]
    for blk in blocks:
        assert sorted(p["span"] for p in blk) == sorted(
            ["tile"] * 6 + ["edge"] * 3 + ["corner"])
        assert blk[-1]["block_end"] and not any(
            p["block_end"] for p in blk[:-1])
    fetched = sum(COVERS[p["span"]] for p in reads)
    assert 100.0 * fetched / (9 * len(reads)) == pytest.approx(SHARE)
    # every tile, inner edge and inner corner is drawn
    spans = {p["span"]: set() for p in reads}
    for p in reads:
        spans[p["span"]].add(tuple(ref_roi.covering(h, w, tiles, p["box"])))
    assert (len(spans["tile"]), len(spans["edge"]),
            len(spans["corner"])) == (9, 12, 4)


def test_every_seed_sends_one_sequence_of_reads():
    assert _reads(SHRINK, 40)[3] == _reads(SHRINK, 40, SEED + 1)[3]


def test_a_sound_run_reads_the_share_by_construction():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["tile_fetch_share.roi_tiled"]["value"] == \
        pytest.approx(SHARE)
    assert r["checks"]["tile_streams_differing"]["value"] == 0.0


def test_a_read_that_fetches_every_tile_stays_correct_at_100(monkeypatch):
    from repro_torch.core import store

    monkeypatch.setattr(store, "tiles_covering", lambda tiles, w, h, box: (
        list(range(tiles[0])), list(range(tiles[1]))))
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["tile_fetch_share.roi_tiled"]["value"] == \
        pytest.approx(100.0)


def test_a_crop_one_pixel_off_is_caught(monkeypatch):
    from repro_torch.core import store

    real = store.VSS._load_tiled_frames

    def shifted(self, *a, **kw):
        frames, (ox, oy) = real(self, *a, **kw)
        return frames, (ox - 1, oy)  # the crop one pixel to the right

    monkeypatch.setattr(store.VSS, "_load_tiled_frames", shifted)
    assert not _run()["correct"]


def test_a_tile_object_altered_after_its_encode_is_caught(monkeypatch):
    """The header written again with other separators: every read still
    decodes the same pixels, so only the byte check can see it."""
    from repro_torch import codec

    real = codec.serialize_gop

    def altered(enc):
        data = real(enc)
        hlen = int.from_bytes(data[4:8], "little")
        head = json.dumps(json.loads(data[8:8 + hlen]),
                          separators=(",", ":")).encode()
        return data[:4] + len(head).to_bytes(4, "little") + head + \
            data[8 + hlen:]

    monkeypatch.setattr(codec, "serialize_gop", altered)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["tile_streams_differing"]["value"] == 18.0
    assert r["checks"]["pixel_diff_max"]["value"] == 0.0


def test_the_stitch_share_reads_only_where_the_program_has_the_span():
    read = harness.metric_reader("stitch_idle_share.roi_tiled")
    gaps = [("vss.store.stitch", 2.0), ("vss.store.concat", 3.0),
            ("vss.codec.inflate.zlib", 5.0)]
    trace = DeviceTrace(busy_s=90.0, window_s=100.0, device_ops=[],
                        idle_gaps=gaps, entry_s={})

    def run(spans, device="cuda"):
        return types.SimpleNamespace(devtrace=trace, device=device,
                                     values={"stitch_spans": spans})

    assert read(run(12)) == pytest.approx(2.0)
    assert read(run(0)) is None  # a program without the span
    assert read(run(12, device="cpu")) is None
