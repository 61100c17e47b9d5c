"""Region reads of one camera clip stored in the tiled layout, by one
closed-loop client.

Set-up draws the clip on the device from the seed (``frames.py``),
writes it through ``VSS.write_spec`` in the configuration's tier, GOP
and tile grid (``tiles``: each GOP's tiles are objects of their own),
and warms the store with reads from the cell's own distribution.  The
window then sends ``VSS.read`` calls with ``roi=``, rgb at the box's own
size, one after another, each as soon as the last returned: the whole
blocks of reads that take about ``--seconds`` at the rate the cell's
file states (``block_seconds``).  The window ends with its last read.

The traffic file sets the mix (``traffic/<name>.json``):

- ``length_frames``: the smallest and largest read, in frames, from a
  uniform whole-second start;
- ``box_tiles``: the smallest and largest side of a box, as a share of
  the side of the tile it is drawn in (each side drawn on its own), so
  a frame of another size keeps the geometry;
- ``placement``: shares of ``tile`` (the box wholly inside one tile),
  ``edge`` (across one inner edge: two tiles) and ``corner`` (across
  one inner corner: four tiles); the tile, edge or corner drawn
  uniformly;
- ``block``: reads come in blocks that hold each placement in its share;
  every seed sends one sequence of reads (the warm-up's apart from the
  window's), and the seed draws only the scene;
- ``quality_eps_db`` and ``cache``, as ``VSS.read`` takes them.

The check cuts the reference's decode of the whole frames to each
read's box and compares each answer with it pixel for pixel, and holds
every tile object of ``SAMPLED_GOPS`` stored GOPs (drawn from the seed,
the last one among them) byte for byte against the reference's encoding
of that tile's pixels (``reference/roi.py``).
"""
from __future__ import annotations

import math
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vssbench.harness import Check, Request, Run
from vssbench.reference import roi as ref_roi
from vssbench.reference import tvc as ref_tvc
from vssbench.traffic.view_reads import (BLOCK_SEED, PSNR_PEAK, _counters,
                                         _expected_clip, _tier, draw_clip,
                                         make_store, put_bytes)

SAMPLED_GOPS = 2  # GOPs whose every tile object the check encodes anew
TILE_COUNTERS = ("vss_tile_fetches_total", "vss_tile_reads_total")


def _side(rng: np.random.Generator, tile: int, lo: float, hi: float) -> int:
    """A box side from ``lo`` to ``hi`` of a ``tile``-long side, at least
    2 pixels so that it can cross an edge."""
    return int(rng.integers(max(2, math.ceil(lo * tile)),
                            max(2, math.floor(hi * tile)) + 1))


def _start(rng: np.random.Generator, band: Tuple[int, int], side: int,
           cross: bool) -> int:
    """Where a ``side``-long span starts: inside ``band``, or across its
    far end (so it covers this band and the next)."""
    a, b = band
    if cross:
        return int(rng.integers(b - side + 1, b))
    return int(rng.integers(a, b - side + 1))


def _box(rng: np.random.Generator, span: str, ys: List[Tuple[int, int]],
         xs: List[Tuple[int, int]], lo: float, hi: float
         ) -> Tuple[int, int, int, int]:
    """A box (x0, y0, x1, y1) placed as ``span`` says, in the tile (r, c)
    where it starts."""
    rows, cols = len(ys), len(xs)
    if span == "tile":
        r, c = int(rng.integers(0, rows)), int(rng.integers(0, cols))
        cross_x = cross_y = False
    elif span == "edge":  # the inner edges between columns, then rows
        between_cols = rows * (cols - 1)
        k = int(rng.integers(0, between_cols + (rows - 1) * cols))
        cross_x = k < between_cols
        cross_y = not cross_x
        r, c = (divmod(k, cols - 1) if cross_x
                else divmod(k - between_cols, cols))
    elif span == "corner":
        r, c = int(rng.integers(0, rows - 1)), int(rng.integers(0, cols - 1))
        cross_x = cross_y = True
    else:
        raise ValueError(f"unknown placement {span!r}")
    w = _side(rng, xs[c][1] - xs[c][0], lo, hi)
    h = _side(rng, ys[r][1] - ys[r][0], lo, hi)
    x0 = _start(rng, xs[c], w, cross_x)
    y0 = _start(rng, ys[r], h, cross_y)
    return x0, y0, x0 + w, y0 + h


def requests(run: Run, n_frames: int, tag: str) -> Iterator[Dict]:
    """Endless reads of the cell's distribution, block by block, by a
    generator fixed by ``BLOCK_SEED`` and ``tag``: the same sequence for
    every seed.  The last read of each block carries ``block_end``."""
    tr = run.traffic
    cfg = run.config
    fps = cfg["fps"]
    ys = ref_roi.bands(cfg["height"], cfg["tiles"][0])
    xs = ref_roi.bands(cfg["width"], cfg["tiles"][1])
    lo, hi = tr["length_frames"]
    hi = min(hi, n_frames)
    blo, bhi = tr["box_tiles"]
    block = int(tr["block"])
    spans: List[str] = []
    for m in tr["placement"]:
        spans += [m["span"]] * int(round(m["share"] * block))
    if len(spans) != block:
        raise ValueError(f"placement shares do not fill a block of {block}")
    rng = np.random.default_rng([BLOCK_SEED, zlib.crc32(tag.encode())])
    while True:
        order = rng.permutation(block)
        for j, i in enumerate(order):
            n = int(rng.integers(lo, hi + 1))
            f0 = min(int(rng.integers(0, n_frames // fps)) * fps,
                     n_frames - n)
            yield {"f0": f0, "f1": f0 + n, "codec": "rgb", "span": spans[i],
                   "box": _box(rng, spans[i], ys, xs, blo, bhi),
                   "block_end": j == block - 1}


def _read(run: Run, store, p: Dict) -> np.ndarray:
    fps = run.config["fps"]
    return store.read(
        "cam0", t=(p["f0"] / fps, p["f1"] / fps), roi=p["box"],
        codec="rgb", quality_eps_db=run.traffic["quality_eps_db"],
        cache=run.traffic["cache"]).frames


def setup(run: Run) -> None:
    from repro_torch.core.spec import WriteSpec

    cfg = run.config
    n_frames = int(cfg["seconds"] * cfg["fps"])
    clip = draw_clip(run, n_frames)
    root = str(Path(run.tmp) / "store")
    store = make_store(run, root)
    store.write_spec(WriteSpec(
        name="cam0", fps=cfg["fps"], codec=_tier(run),
        gop_frames=cfg["gop_frames"], tiles=tuple(cfg["tiles"])), clip)
    warm = requests(run, n_frames, "warm")
    for _ in range(int(run.workload["warm_reads"])):
        _read(run, store, next(warm))
    run.state.update(clip=clip, store=store, root=root, n_frames=n_frames,
                     stream=requests(run, n_frames, "window"))


def _tile_counters(store) -> Dict[str, float]:
    out = _counters(store)
    out.update({name: store.registry.value(name) for name in TILE_COUNTERS})
    return out


def _count_spans(node: Dict, name: str) -> int:
    return int(node["name"] == name) + sum(
        _count_spans(c, name) for c in node.get("children", ()))


def window(run: Run) -> None:
    store = run.state["store"]
    stream = run.state["stream"]
    gop = run.config["gop_frames"]
    before = _tile_counters(store)
    blocks = max(1, round(run.seconds / run.workload["block_seconds"]))
    t_begin = time.perf_counter()
    while blocks:
        p = next(stream)
        req = Request("read", time.perf_counter(), params=p)
        try:
            with torch.profiler.record_function("vss.read"):
                req.answer = _read(run, store, p)
            req.frames = int(req.answer.shape[0])
            req.ok = True
        except Exception as exc:  # noqa: BLE001 - a failed read is counted
            req.error = f"{type(exc).__name__}: {exc}"
        req.t_end = time.perf_counter()
        run.requests.append(req)
        blocks -= p["block_end"]
    run.window_s = run.requests[-1].t_end - t_begin
    after = _tile_counters(store)
    run.counters = {k: after[k] - before[k] for k in after}
    # the GOPs the window's reads covered, each a grid of tile objects
    run.values["roi_gops_covered"] = sum(
        -(-r.params["f1"] // gop) - r.params["f0"] // gop
        for r in run.requests if r.ok)
    # the program's stitch spans among the reads' retained traces
    run.values["stitch_spans"] = sum(
        _count_spans(t, "stitch") for t in store.recent_traces())


def _tile_objects(run: Run) -> Dict[Tuple[int, int, int], Optional[bytes]]:
    """Every tile object of the sampled GOPs, read from the backend's
    directory (``objects/cam0/<physical>/<gop>.tvc/t<r>_<c>``); None
    where one is missing."""
    gop_dirs = sorted(
        (d for d in (Path(run.state["root"]) / "objects" / "cam0").glob(
            "*/*.tvc") if d.is_dir()),
        key=lambda d: int(d.stem))
    n = run.state["n_frames"] // run.config["gop_frames"]
    picks = {n - 1} | {int(i) for i in run.rng("check").choice(
        n - 1, size=min(n - 1, SAMPLED_GOPS - 1), replace=False)}
    rows, cols = run.config["tiles"]
    out: Dict[Tuple[int, int, int], Optional[bytes]] = {}
    for i in sorted(picks):
        for r in range(rows):
            for c in range(cols):
                f = gop_dirs[i] / f"t{r}_{c}" if i < len(gop_dirs) else None
                out[i, r, c] = f.read_bytes() if f and f.is_file() else None
    return out


def release(run: Run) -> None:
    store = run.state.pop("store")
    run.values["backend_put_bytes"] = put_bytes(store)
    store.close()
    del store
    run.state.pop("stream", None)
    run.state["tile_objects"] = _tile_objects(run)
    shutil.rmtree(run.state["root"], ignore_errors=True)
    if run.device != "cpu":
        torch.cuda.empty_cache()


def _tile_streams_differing(run: Run) -> int:
    cfg = run.config
    gop = cfg["gop_frames"]
    tier = ref_tvc.tier(cfg["tier"])
    clip = run.state["clip"]
    differing = 0
    with ThreadPoolExecutor(8) as pool:
        for (i, r, c), stored in run.state["tile_objects"].items():
            x = torch.from_numpy(clip[i * gop:(i + 1) * gop]).to(run.device)
            want = ref_roi.tile_blob(x, tier, cfg["tiles"], r, c, pool)
            differing += stored != want
    return differing


def check(run: Run) -> None:
    expected_clip = _expected_clip(run)
    wrong = 0
    mse_max = 0.0
    diff_max = 0
    for req in run.requests:
        if not req.ok:
            continue
        p = req.params
        want = ref_roi.crop(expected_clip, p["f0"], p["f1"], p["box"])
        got = torch.from_numpy(req.answer).to(run.device)
        if tuple(got.shape) != tuple(want.shape):
            req.error = (f"answer of shape {tuple(got.shape)}, expected"
                         f" {tuple(want.shape)}")
            wrong += 1
            continue
        d = got.to(torch.int16) - want.to(torch.int16)
        diff_max = max(diff_max, int(d.abs().max().item()))
        mse = (d.to(torch.float64) ** 2).mean(dim=(1, 2, 3))
        mse_max = max(mse_max, float(mse.max().item()))
        req.answer = None
    limit = run.workload["limits"]
    eps = float(run.traffic["quality_eps_db"])
    run.checks = [
        Check("reads_wrong", float(wrong), 0.0),
        # the configuration's read quality bound, as a squared error
        Check("frame_mse_max", mse_max,
              PSNR_PEAK ** 2 / 10 ** (eps / 10)),
        # an rgb answer at its own size is the stored pixels, and the
        # tile split is lossless
        Check("pixel_diff_max", float(diff_max),
              float(limit["pixel_diff_max"])),
        # every stored tile object is the reference's encoding of the
        # tile's pixels, byte for byte
        Check("tile_streams_differing", float(_tile_streams_differing(run)),
              0.0),
    ]
    run.values["psnr_min_db"] = (
        10 * math.log10(PSNR_PEAK ** 2 / mse_max) if mse_max > 0
        else float("inf"))
