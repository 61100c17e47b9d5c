"""Reads of a camera pair stored jointly, by one closed-loop client.

Set-up is the joint cell's (``camera_joint.py``), untimed here: each
camera's GOPs drawn into host memory from the traffic file's
``scene_seed``, noise included, as many as the cell's ``gop_seconds``
give, the codec, histogram and warp kernels warmed; two writers append
their camera's GOPs and close; then ``VSS.apply_joint_compression``
with the configuration's ``joint`` settings and the host's BLAS held
at ``host.blas_threads``.  So the store holds the slices the joint cell
stores.  Set-up then takes each camera's jointly stored GOPs from the
catalog (a GOP whose ``joint_ref`` is set) and warms the reads with
``warm_reads`` of the cell's own distribution.  A camera with no joint
GOP reads its plain GOPs instead, and the check fails on
``joint_gops_read``.

The window then sends ``VSS.read`` calls one after another, each as soon
as the last returned: whole blocks of reads that take about
``--seconds`` at the rate the cell's file states (``block_seconds``).
The traffic file sets the mix (``traffic/<name>.json``):

- ``cameras``: each camera's share of a block's reads;
- ``length_frames``: one read's frames, from a jointly stored GOP's
  first frame (one GOP, drawn uniformly among that camera's joint GOPs);
- ``block``: reads come in blocks that hold each camera in its share;
  with ``order`` ``fixed`` every seed sends one sequence of reads (the
  warm-up's apart from the window's), and the seed draws nothing else:
  the frames are the scene's;
- ``quality_eps_db`` and ``cache``, as ``VSS.read`` takes them; rgb at
  the stored frame size.

A traced run also times the warp kernel (``joint_probes.py``).

The check holds every answer against the benchmark's reference
(``reference/tvc.py``, ``reference/joint.py``) and the catalog alone, as
the joint cell's check does (``camera_joint._expect_records``), so a
program without the rebuild's counters is held alike.  The reference
decodes each camera's originals at the configuration's tier, cuts the
slices each record's columns name, encodes and decodes them, and
rebuilds both sides from those decodes:

- ``reads_wrong``: answers of another shape than the read's GOP;
- ``h_error_px`` at most the joint cell's 1 px: each record's homography
  against the scene's true shift, the joint cell's check;
- ``joint_streams_differing``: each segment object of a joint record
  equals, byte for byte, the reference's encoding of its slice;
- ``pixel_diff_max`` 0: side a, a duplicate's side a and a GOP stored
  apart are the reference's decodes side by side, exact;
- ``side_b_pixel_diff_max`` 1: side b is the reference's ``side_b``
  over its decodes; two f32 bilinear warps may round a half apart, the
  joint cell's reason.  The control (originals one tier down) moves
  every answer's pixels, by far more than 1;
- ``joint_psnr_min`` at least the configuration's joint ``tau_db``: each
  answer against its camera's decoded original, frame by frame, the
  guarantee Algorithm 1's verify step gives;
- ``joint_gops_read`` at least ``limits.joint_gops_read``: the distinct
  GOPs the window read that the reference holds as a side of a joint
  record, or 0 where a camera read none.
"""
from __future__ import annotations

import json
import math
import shutil
import time
import zlib
from typing import Dict, Iterator, List

import numpy as np
import torch

from vssbench import joint_probes
from vssbench.harness import Check, Request, Run
from vssbench.reference import joint as ref_joint
from vssbench.reference import tvc as ref_tvc
from vssbench.traffic import camera_ingest, camera_joint
from vssbench.traffic import frames as scene_frames
from vssbench.traffic import view_reads
from vssbench.traffic.view_reads import BLOCK_SEED, put_bytes

REBUILD_FRAMES = "vss_joint_rebuild_frames_total"


def _gop_metas(store, gop_of: Dict) -> Dict:
    """(camera, GOP index) -> the catalog's GOP, from ``_gop_map``'s."""
    return {key: store.catalog.get_gop(gop_id)
            for gop_id, key in gop_of.items()}


def setup(run: Run) -> None:
    camera_joint.setup(run)
    camera_ingest.window(run)  # the writers
    failed = [r for r in run.requests if not r.ok]
    if failed:
        raise RuntimeError(f"set-up's {failed[0].kind} failed:"
                           f" {failed[0].error}")
    run.state["appended"] = sorted(
        (r.params["camera"], r.params["gop"]) for r in run.requests
        if r.kind == "append")
    run.requests, run.counters, run.window_s = [], {}, 0.0
    store = run.state["store"]
    joint = run.config["joint"]
    cameras = len(run.state["pools"])
    with camera_joint.blas_threads(int(run.config["host"]["blas_threads"])):
        run.state["joint_ids"] = list(store.apply_joint_compression(
            [f"cam{c}" for c in range(cameras)], merge=joint["merge"],
            tau_db=float(joint["tau_db"]), max_pairs=int(joint["max_pairs"])))
    metas = _gop_metas(store, camera_joint._gop_map(
        store, cameras, int(run.traffic["gop_frames"])))
    targets = {}
    for cam in range(cameras):
        gops = sorted(i for c, i in metas if c == cam)
        joint_gops = [i for i in gops if metas[cam, i].joint_ref is not None]
        targets[cam] = joint_gops or gops
        run.values[f"joint_gops_cam{cam}"] = len(joint_gops)
    run.state["targets"] = targets
    warm = requests(run, "warm")
    for _ in range(int(run.workload["warm_reads"])):
        _read(run, store, next(warm))
    run.state["stream"] = requests(run, "window")


def requests(run: Run, tag: str) -> Iterator[Dict]:
    """Endless reads of the cell's distribution, block by block, by a
    generator fixed by ``BLOCK_SEED`` and ``tag``.  The last read of each
    block carries ``block_end``."""
    tr = run.traffic
    if tr["order"] != "fixed":
        raise ValueError(f"unknown order {tr['order']!r}")
    targets = run.state["targets"]
    gop = int(tr["gop_frames"])
    n = int(tr["length_frames"])
    block = int(tr["block"])
    cams: List[int] = []
    for cam, share in enumerate(tr["cameras"]):
        cams += [cam] * int(round(share * block))
    if len(cams) != block:
        raise ValueError(f"camera shares do not fill a block of {block}")
    rng = np.random.default_rng([BLOCK_SEED, zlib.crc32(tag.encode())])
    while True:
        order = rng.permutation(block)
        for j, i in enumerate(order):
            cam = cams[i]
            g = targets[cam][int(rng.integers(0, len(targets[cam])))]
            yield {"camera": cam, "gop": g, "f0": g * gop, "f1": g * gop + n,
                   "codec": "rgb", "scale": 1, "block_end": j == block - 1}


def _read(run: Run, store, p: Dict) -> np.ndarray:
    fps = run.config["fps"]
    return store.read(
        f"cam{p['camera']}", t=(p["f0"] / fps, p["f1"] / fps), codec="rgb",
        quality_eps_db=run.traffic["quality_eps_db"],
        cache=run.traffic["cache"]).frames


def _counters(store) -> Dict[str, float]:
    """The read path's fetch, decode and planner counters, and the
    rebuilt frames where the program counts them."""
    out = view_reads._counters(store)
    if REBUILD_FRAMES in store.registry.snapshot():
        out[REBUILD_FRAMES] = store.registry.value(REBUILD_FRAMES)
    return out


def window(run: Run) -> None:
    store = run.state["store"]
    stream = run.state["stream"]
    if run.trace:
        joint_probes.install(run)
    before = _counters(store)
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
    after = _counters(store)
    run.counters = {k: after[k] - before.get(k, 0.0) for k in after}


def release(run: Run) -> None:
    run.values["backend_put_bytes"] = put_bytes(run.state["store"])
    run.values.update(run.counters)
    if run.devtrace is not None:  # the card's idle seconds in round trips
        run.values["fetch_gap_s"] = sum(
            s for name, s in run.devtrace.idle_gaps
            if name == "vss.store.fetch")
    run.state.pop("stream", None)
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run: Run) -> None:
    cfg = run.config
    store = run.state.pop("store")
    pools = run.state["pools"]
    gop = int(run.traffic["gop_frames"])
    tier = ref_tvc.tier(cfg["tier"])
    limits = run.workload["limits"]
    try:
        recon = {(cam, i): ref_tvc.encode(
            torch.from_numpy(pools[cam][i]).to(run.device), tier)[2]
            for cam, i in run.state["appended"]}
        scene = scene_frames.make_scene(
            cfg["height"], cfg["width"], cameras=len(pools),
            overlap=cfg["overlap"], seed=int(run.traffic["scene_seed"]),
            device=run.device)
        exp = camera_joint._expect_records(
            run, store, recon,
            camera_joint._gop_map(store, len(pools), gop), scene)
    finally:
        store.close()
        shutil.rmtree(run.state["root"], ignore_errors=True)
    wrong = diff_a = diff_b = 0
    psnr = math.inf
    read_joint: Dict[int, set] = {cam: set() for cam in range(len(pools))}
    for req in run.requests:
        if not req.ok:
            continue
        key = (req.params["camera"], req.params["gop"])
        want = exp.side_b.get(key, exp.side_a.get(key, recon[key]))
        if key in exp.side_a or key in exp.side_b:
            read_joint[key[0]].add(key[1])
        got = torch.from_numpy(req.answer).to(run.device)
        req.answer = None
        if tuple(got.shape) != tuple(want.shape):
            req.error = (f"answer of shape {tuple(got.shape)},"
                         f" expected {tuple(want.shape)}")
            wrong += 1
            continue
        d = int((got.to(torch.int16) - want.to(torch.int16)).abs()
                .max().item())
        if key in exp.side_b:
            diff_b = max(diff_b, d)
        else:
            diff_a = max(diff_a, d)
        psnr = min(psnr, ref_joint.psnr_min(got, recon[key]))
    joint_read = (sum(len(s) for s in read_joint.values())
                  if all(read_joint.values()) else 0)
    run.values["joint_gops_read_by_camera"] = {
        f"cam{c}": sorted(s) for c, s in read_joint.items()}
    run.values["joint_pairs"] = json.dumps(exp.pairs)
    run.checks = [
        Check("reads_wrong", float(wrong), 0.0),
        Check("h_error_px", exp.h_error, float(limits["h_error_px"])),
        Check("joint_streams_differing", float(exp.differing), 0.0),
        Check("pixel_diff_max", float(diff_a),
              float(limits["pixel_diff_max"])),
        Check("side_b_pixel_diff_max", float(diff_b),
              float(limits["side_b_pixel_diff_max"])),
        # no answer checked: no reading, which fails as reads_wrong does
        Check("joint_psnr_min", psnr if math.isfinite(psnr) else 0.0,
              float(cfg["joint"]["tau_db"]), le=False),
        Check("joint_gops_read", float(joint_read),
              float(limits["joint_gops_read"]), le=False),
    ]
