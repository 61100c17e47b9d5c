"""View reads of one stored camera clip by one closed-loop client.

Set-up draws the clip on the device from the seed (``frames.py``), writes
it through ``VSS.write`` in the configuration's tier and GOP, and warms
the store with reads from the cell's own distribution.  The window then
sends ``VSS.read`` calls one after another, each as soon as the last
returned: a fixed amount of work, the whole blocks of reads (below)
that take about ``--seconds`` at the rate the cell's file states
(``block_seconds``), so that every run measures the same reads.  The
window ends with its last read.

The traffic file sets the mix (``traffic/<name>.json``):

- ``start``: ``zipf`` (whole-second slots, the most recent hottest, with
  exponent ``s``), ``uniform`` (whole-second slots) or ``uniform_frame``
  (any frame: each offset into a GOP equally often);
- ``length_frames``: the smallest and largest read, in frames;
- ``mix``: shares of output kinds, each a ``codec`` and a ``scale`` (the
  frame size divided by it);
- ``block``: requests come in blocks that hold the same reads (length,
  start or offset into a GOP, kind) whatever the seed, shuffled by the
  seed, so two seeds do the same work in another order;
- ``order``: ``seeded`` (the default: the seed shuffles each block) or
  ``fixed``: every seed sends one sequence of reads, each block drawn
  afresh from the distribution (the warm-up's blocks apart from the
  window's), and the seed draws only the scene.  Where a cache sits in
  the path, the order decides which reads hit it, so a seeded order
  changes the work, and blocks that repeat one set of reads all hit;
- ``quality_eps_db`` and ``cache``, as ``VSS.read`` takes them.

The check rebuilds, with the reference codec, what the stored original
decodes to, cuts and resizes it for every read of the window, and
compares each answer (``hevc`` answers decoded by the reference) frame by
frame.
"""
from __future__ import annotations

import math
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np
import torch

from vssbench.harness import Check, Request, Run
from vssbench.reference import tvc as ref_tvc
from vssbench.reference import view as ref_view
from vssbench.traffic import frames as scene_frames

CONTROL_TIER = "tvc-lo"  # one tier below the configuration's, for the control
BLOCK_SEED = 2103_16604  # fixes the reads of a block for every seed
PSNR_PEAK = 255.0


def _tier(run: Run) -> str:
    return CONTROL_TIER if run.control else run.config["tier"]


def make_store(run: Run, root: str):
    """A VSS store as the configuration states it."""
    from repro_torch.core.cache import CachePolicy
    from repro_torch.core.config import (DeferredConfig, IngestConfig,
                                         VSSConfig)
    from repro_torch.core.store import VSS
    from repro_torch.obs import MetricsRegistry

    st = run.config["store"]
    config = VSSConfig(
        backend=run.config["backend"],
        budget_multiple=st["budget_multiple"],
        cache=CachePolicy(gamma=st["gamma"], zeta=st["zeta"],
                          tau_db=st["tau_db"]),
        deferred=DeferredConfig(
            enabled=True, activation_fraction=st["deferred_activation"]),
        ingest=IngestConfig(pipelined=run.config["ingest"]["pipelined"]),
        registry=MetricsRegistry(),
        device=run.device,
    )
    return VSS(root, config=config)


def draw_clip(run: Run, frames: int, camera: int = 0) -> np.ndarray:
    """The camera's first ``frames`` frames, drawn on the device and
    copied to host memory (T, H, W, 3) uint8."""
    cfg = run.config
    scene = scene_frames.make_scene(
        cfg["height"], cfg["width"], cameras=cfg["cameras"],
        overlap=cfg["overlap"], seed=run.subseed("scene"), device=run.device)
    out = np.empty((frames, cfg["height"], cfg["width"], 3), np.uint8)
    gop = cfg["gop_frames"]
    for s in range(0, frames, gop):
        n = min(gop, frames - s)
        out[s:s + n] = scene_frames.render(
            scene, s, n, camera=camera, overlap=cfg["overlap"]).cpu().numpy()
    return out


def _zipf_slots(n_slots: int, s: float, count: int) -> List[int]:
    """``count`` stratified draws of Zipf(s) over ranks 1..n_slots, rank 1
    the most recent slot: the inverse CDF at (i + 0.5) / count."""
    w = np.arange(1, n_slots + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w / w.sum())
    ranks = np.searchsorted(cdf, (np.arange(count) + 0.5) / count) + 1
    return [n_slots - int(r) for r in ranks]


def requests(run: Run, n_frames: int, tag: str) -> Iterator[Dict]:
    """Endless reads of the cell's distribution, block by block; the last
    read of each block carries ``block_end``.  A block's reads are the
    same whatever the seed (drawn with ``BLOCK_SEED``); the seed orders
    them, and for ``uniform_frame`` picks the GOP each offset falls in.
    With the traffic's ``order`` ``fixed``, see ``_fixed_requests``."""
    tr = run.traffic
    fps = run.config["fps"]
    lo, hi = tr["length_frames"]
    hi = min(hi, n_frames)
    start = tr["start"]
    block = int(tr["block"])
    n_slots = n_frames // fps
    fixed = np.random.default_rng(BLOCK_SEED)
    kinds: List[Dict] = []
    for m in tr["mix"]:
        kinds += [m] * int(round(m["share"] * block))
    if len(kinds) != block:
        raise ValueError(f"mix shares do not fill a block of {block}")
    kinds = [kinds[i] for i in fixed.permutation(block)]
    lengths = np.rint(np.linspace(lo, hi, block)).astype(int)[
        fixed.permutation(block)]
    if start["dist"] == "uniform_frame":
        gop = run.config["gop_frames"]
        # every offset into a GOP once a block
        starts = (np.arange(block) * gop // block)[fixed.permutation(block)]
    elif start["dist"] == "zipf":
        starts = np.array(_zipf_slots(n_slots, float(start["s"]), block)
                          )[fixed.permutation(block)] * fps
    elif start["dist"] == "uniform":
        starts = np.array([int((i + 0.5) * n_slots / block)
                           for i in range(block)])[fixed.permutation(block)] \
            * fps
    else:
        raise ValueError(f"unknown start distribution {start!r}")
    if tr.get("order", "seeded") == "fixed":
        yield from _fixed_requests(run, n_frames, tag, kinds)
        return
    rng = run.rng(tag)
    while True:
        order = rng.permutation(block)
        for j, i in enumerate(order):
            n = int(lengths[i])
            f0 = int(starts[i])
            if start["dist"] == "uniform_frame":
                f0 += int(rng.integers(0, n_frames // gop)) * gop
                if f0 + n > n_frames:  # the same offset, a GOP earlier
                    f0 -= gop
            f0 = max(0, min(f0, n_frames - n))
            yield {"f0": f0, "f1": f0 + n, "codec": kinds[i]["codec"],
                   "scale": int(kinds[i]["scale"]),
                   "block_end": j == block - 1}


def _fixed_requests(run: Run, n_frames: int, tag: str,
                    kinds: List[Dict]) -> Iterator[Dict]:
    """Reads drawn independently from the distribution, one block of
    ``kinds`` (in the mix's shares) after another, by a generator fixed
    by ``BLOCK_SEED`` and ``tag``: the same sequence for every seed."""
    tr = run.traffic
    fps = run.config["fps"]
    lo, hi = tr["length_frames"]
    hi = min(hi, n_frames)
    start = tr["start"]
    n_slots = n_frames // fps
    rng = np.random.default_rng([BLOCK_SEED, zlib.crc32(tag.encode())])
    if start["dist"] == "zipf":
        w = np.arange(1, n_slots + 1, dtype=np.float64) ** -float(start["s"])
        cdf = np.cumsum(w / w.sum())
    while True:
        order = rng.permutation(len(kinds))
        for j, i in enumerate(order):
            n = int(rng.integers(lo, hi + 1))
            if start["dist"] == "zipf":  # rank 1 the most recent second
                rank = min(int(np.searchsorted(cdf, rng.random())), n_slots - 1)
                f0 = (n_slots - 1 - rank) * fps
            elif start["dist"] == "uniform":
                f0 = int(rng.integers(0, n_slots)) * fps
            elif start["dist"] == "uniform_frame":
                f0 = int(rng.integers(0, n_frames))
            else:
                raise ValueError(f"unknown start distribution {start!r}")
            f0 = max(0, min(f0, n_frames - n))
            yield {"f0": f0, "f1": f0 + n, "codec": kinds[i]["codec"],
                   "scale": int(kinds[i]["scale"]),
                   "block_end": j == len(kinds) - 1}


def _read(run: Run, store, p: Dict):
    cfg = run.config
    fps = cfg["fps"]
    res = None
    if p["scale"] > 1:
        res = (cfg["width"] // p["scale"], cfg["height"] // p["scale"])
    out = store.read(
        "cam0", t=(p["f0"] / fps, p["f1"] / fps), resolution=res,
        codec=p["codec"], quality_eps_db=run.traffic["quality_eps_db"],
        cache=run.traffic["cache"])
    if p["codec"] == "rgb":
        answer = out.frames
        return answer, int(answer.shape[0]), out
    answer = list(out.encoded)
    return answer, sum(e.num_frames for e in answer), out


def setup(run: Run) -> None:
    cfg = run.config
    n_frames = int(cfg["seconds"] * cfg["fps"])
    clip = draw_clip(run, n_frames)
    root = str(Path(run.tmp) / "store")
    store = make_store(run, root)
    store.write("cam0", clip, fps=cfg["fps"], codec=_tier(run),
                gop_frames=cfg["gop_frames"])
    warm = requests(run, n_frames, "warm")
    for _ in range(int(run.workload["warm_reads"])):
        _read(run, store, next(warm))
    run.state.update(clip=clip, store=store, root=root, n_frames=n_frames,
                     stream=requests(run, n_frames, "window"))


COUNTERS = ("vss_read_fetch_bytes_total", "vss_read_gops_decoded_total",
            "vss_read_objects_fetched_total",
            "vss_read_ranged_fetches_total")


def _counters(store) -> Dict[str, float]:
    reg = store.registry
    out = {name: reg.value(name) for name in COUNTERS}
    _, total, count = reg.histogram_values("vss_read_plan_seconds")
    out["vss_read_plan_seconds_sum"] = total
    out["vss_read_plan_seconds_count"] = count
    return out


def window(run: Run) -> None:
    store = run.state["store"]
    stream = run.state["stream"]
    before = _counters(store)
    label = "vss.read"
    blocks = max(1, round(run.seconds / run.workload["block_seconds"]))
    t_begin = time.perf_counter()
    while blocks:
        p = next(stream)
        req = Request("read", time.perf_counter(), params=p)
        try:
            with torch.profiler.record_function(label):
                req.answer, req.frames, out = _read(run, store, p)
            req.params["plan"] = _plan_summary(out)
            req.ok = True
        except Exception as exc:  # noqa: BLE001 - a failed read is counted
            req.error = f"{type(exc).__name__}: {exc}"
        req.t_end = time.perf_counter()
        run.requests.append(req)
        blocks -= p["block_end"]
    run.window_s = run.requests[-1].t_end - t_begin
    after = _counters(store)
    run.counters = {k: after[k] - before[k] for k in after}


def _plan_summary(out) -> Dict:
    """Frames of the answer that came from a view other than the stored
    original, by the plan the program returned."""
    plan = out.plan
    cached = 0.0
    total = 0.0
    for i, (a, b) in enumerate(plan.segments):
        n = (b - a) * out.fps
        total += n
        if not plan.runs[plan.run_idx(i)].physical.is_original:
            cached += n
    return {"cached_frames": cached, "planned_frames": total}


def put_bytes(store) -> float:
    """Bytes the store handed its backend to write, set-up included."""
    kind = getattr(store.backend, "kind", None)
    return sum(store.registry.value("vss_backend_op_bytes",
                                    {"kind": kind, "op": op})
               for op in ("put", "batch_put"))


def release(run: Run) -> None:
    store = run.state.pop("store")
    run.values["backend_put_bytes"] = put_bytes(store)
    store.close()
    del store
    run.state.pop("stream", None)
    shutil.rmtree(run.state["root"], ignore_errors=True)
    if run.device != "cpu":
        torch.cuda.empty_cache()


def _expected_clip(run: Run) -> torch.Tensor:
    """What the stored original decodes to: the reference codec's recon of
    the drawn clip, GOP by GOP, in the configuration's tier."""
    clip = run.state["clip"]
    tier = ref_tvc.tier(run.config["tier"])
    gop = run.config["gop_frames"]
    out = torch.empty(clip.shape, dtype=torch.uint8, device=run.device)
    for s in range(0, clip.shape[0], gop):
        x = torch.from_numpy(clip[s:s + gop]).to(run.device)
        out[s:s + gop] = ref_tvc.encode(x, tier)[2]
    return out


def _answer_frames(run: Run, answer, pool) -> torch.Tensor:
    if isinstance(answer, np.ndarray):
        return torch.from_numpy(answer).to(run.device)
    parts = []
    for enc in answer:
        if enc.offsets is None:
            raise ValueError("an encoded answer without its offset table")
        parts.append(ref_tvc.decode_payload(
            enc.codec, enc.shape, enc.offsets, enc.payload, run.device, pool))
    return torch.cat(parts, 0)


def check(run: Run) -> None:
    expected_clip = _expected_clip(run)
    cfg = run.config
    wrong = 0
    mse_max = 0.0
    diff_max = 0
    with ThreadPoolExecutor(8) as pool:
        for req in run.requests:
            if not req.ok:
                continue
            p = req.params
            res = None
            if p["scale"] > 1:
                res = (cfg["width"] // p["scale"], cfg["height"] // p["scale"])
            want = ref_view.view(expected_clip, p["f0"], p["f1"], res)
            try:
                got = _answer_frames(run, req.answer, pool)
            except (ValueError, RuntimeError) as exc:
                req.error = f"answer does not decode: {exc}"
                wrong += 1
                continue
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
        Check("pixel_diff_max", float(diff_max),
              float(limit["pixel_diff_max"])),
    ]
    run.values["psnr_min_db"] = (
        10 * math.log10(PSNR_PEAK ** 2 / mse_max) if mse_max > 0
        else float("inf"))
