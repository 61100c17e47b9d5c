"""A camera pair stored jointly: closed-loop writers, then the joint pass.

Set-up is the camera ingest's (``camera_ingest.py``) but for the sensor
noise: each camera's GOPs are drawn into host memory from the traffic
file's ``scene_seed``, noise included, and the codec is warmed in a
store of its own; then the histogram and warp kernels are loaded and
run once, at the frame size, through the program's ``gop_fingerprint``
and ``warp_frames``.  The noise is drawn with the scene, so every seed
stores the same frames: which GOP pairs pass the candidate search's
m = 20 correspondences turns on it (noise of two run seeds joined 25 %
and 50 % of the GOPs on the H100, 0.0885 and 0.0796 stored bytes per
raw byte, ten times the spread the bytes' bound admits).  The window
starts one writer a camera, each appending its GOPs one after another
and closing (the durability barrier), then runs
``VSS.apply_joint_compression`` over both cameras with the
configuration's ``joint`` settings and the host's BLAS held at its
``host.blas_threads`` (``blas_threads``): the candidate search (a
histogram fingerprint a GOP, BIRCH clusters, feature correspondences),
Algorithm 1 on each pair it returns (the verified homography, the
per-frame verify, the three slice streams) and the catalog's joint
records.  The window ends when the pass returns.  A traced run also
times the two kernels (``joint_probes.py``).

The check holds the store to the configuration's guarantees with the
benchmark's reference (``reference/tvc.py``, ``reference/joint.py``):
every appended GOP is indexed and reads back whole through ``VSS.read``;
there is at least one joint record; each record's homography lies
within ``h_error_px`` of the scene's true shift between the two frames
it was estimated on; each joint object equals, byte for byte, the
reference's encoding of the slice that the record's homography cuts from
the decoded originals; side a (and every GOP stored apart) reads back
exactly as the reference rebuilds it, side b within
``side_b_pixel_diff_max`` of the reference's rebuild (two f32 bilinear
warps may round a half apart) and within the configuration's ``tau_db``
of its decoded original, frame by frame.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import shutil
import time
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from vssbench import joint_probes
from vssbench.harness import Check, Request, Run
from vssbench.reference import joint as ref_joint
from vssbench.reference import tvc as ref_tvc
from vssbench.traffic import camera_ingest
from vssbench.traffic import frames as scene_frames
from vssbench.traffic.view_reads import make_store, put_bytes

# The feature stage (Harris corners past a 9-pixel border, 16x16 patches,
# m = 20 correspondences) finds a 75 % pair and its shift within
# ``h_error_px`` from about this frame size up (320x180: 72-87
# correspondences, 0.2-0.6 px; 96x54: 28 corners and no homography).  A
# smaller configuration, which only a CPU rehearsal's shrunk one is, is
# drawn at this size; the published 960x540 is above it.
MIN_FRAME = (320, 180)
OUTCOMES = ("joint", "duplicate", "abort", "no_h")


def _openblas_pools() -> List[Tuple[ctypes.CDLL, str]]:
    """Each OpenBLAS loaded in this process, with its symbols' prefix and
    suffix (``scipy_`` and ``64_`` in the scipy-openblas numpy ships)."""
    try:
        with open("/proc/self/maps") as f:
            paths = sorted({line.split()[-1] for line in f
                            if "openblas" in line.rsplit("/", 1)[-1]})
    except OSError:
        return []
    pools = []
    for path in paths:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        for affix in ("scipy_openblas_{}64_", "openblas_{}64_",
                      "scipy_openblas_{}", "openblas_{}"):
            if hasattr(lib, affix.format("set_num_threads")):
                pools.append((lib, affix))
                break
    return pools


@contextlib.contextmanager
def blas_threads(n: int) -> Iterator[int]:
    """Holds every OpenBLAS pool of the process at ``n`` threads inside
    the block, and yields how many pools it holds.  The feature stage's
    linear algebra is a few hundred 8x9 SVDs and 300x256 products a
    homography: on an 8-core H100 host a pool as wide as the host spun
    3.5 cores through the joint pass, and the pass's time spread 10.2
    and 13.5 % over two sets of six seeds; on one thread it took a third
    of the CPU and spread 7.6 and 10.6 %, with the same pairs and
    bytes."""
    pools = _openblas_pools()
    before = [lib[affix.format("get_num_threads")]() for lib, affix in pools]
    try:
        for lib, affix in pools:
            lib[affix.format("set_num_threads")](ctypes.c_int(n))
        yield len(pools)
    finally:
        for (lib, affix), was in zip(pools, before):
            lib[affix.format("set_num_threads")](ctypes.c_int(was))


def setup(run: Run) -> None:
    cfg = run.config = {
        **run.config, "width": max(run.config["width"], MIN_FRAME[0]),
        "height": max(run.config["height"], MIN_FRAME[1])}
    gop = int(run.traffic["gop_frames"])
    writers = int(run.traffic["writers"])
    n_gops = camera_ingest._gops_per_writer(run)
    scene = scene_frames.make_scene(
        cfg["height"], cfg["width"], cameras=writers,
        overlap=cfg["overlap"], seed=int(run.traffic["scene_seed"]),
        device=run.device)
    pools = []
    for cam in range(writers):
        pool = np.empty((n_gops, gop, cfg["height"], cfg["width"], 3),
                        np.uint8)
        for i in range(n_gops):
            pool[i] = scene_frames.render(
                scene, i * gop, gop, camera=cam,
                overlap=cfg["overlap"]).cpu().numpy()
        pools.append(pool)
    # load the codec's kernels and warm its buffers at the frame size
    # through a store of its own, and the histogram and warp kernels,
    # so nothing builds inside the window
    warm_root = str(Path(run.tmp) / "warm")
    warm = make_store(run, warm_root)
    w = warm.writer("warm", fps=cfg["fps"], codec=cfg["tier"], gop_frames=2)
    w.append(pools[0][0][:2])
    w.close()
    warm.close()
    shutil.rmtree(warm_root, ignore_errors=True)
    from repro_torch.core.fingerprint import gop_fingerprint
    from repro_torch.core.joint import warp_frames

    gop_fingerprint(pools[0][0], device=run.device)
    warp_frames(pools[0][0], np.eye(3, dtype=np.float32), device=run.device)
    run.sync()
    root = str(Path(run.tmp) / "store")
    run.state.update(pools=pools, store=make_store(run, root), root=root)
    run.values["pool_gops_per_writer"] = n_gops
    run.values["pool_host_bytes"] = sum(p.nbytes for p in pools)


def _counters(store) -> Dict[str, float]:
    """The joint pass's counters, where the program has them."""
    if not hasattr(store, "joint_counters"):
        return {}
    reg = store.registry
    out = {name: reg.value(name) for name in (
        "vss_joint_candidates_total", "vss_joint_gops_total")}
    for o in OUTCOMES:
        out[f"vss_joint_pairs_total.{o}"] = reg.value(
            "vss_joint_pairs_total", {"outcome": o})
    return out


def window(run: Run) -> None:
    store = run.state["store"]
    joint = run.config["joint"]
    names = [f"cam{c}" for c in range(int(run.traffic["writers"]))]
    if run.trace:
        joint_probes.install(run)
    t_begin = time.perf_counter()
    camera_ingest.window(run)
    req = Request("joint", time.perf_counter(), params={"videos": names})
    try:
        with blas_threads(int(run.config["host"]["blas_threads"])) as held:
            run.values["blas_pools_held"] = held
            with torch.profiler.record_function(
                    "vss.apply_joint_compression"):
                ids = store.apply_joint_compression(
                    names, merge=joint["merge"],
                    tau_db=float(joint["tau_db"]),
                    max_pairs=int(joint["max_pairs"]))
        req.ok = True
    except Exception as exc:  # noqa: BLE001 - a failed pass is counted
        req.error = f"{type(exc).__name__}: {exc}"
        ids = []
    req.t_end = time.perf_counter()
    run.requests.append(req)
    run.window_s = req.t_end - t_begin
    run.state["joint_ids"] = list(ids)
    run.counters.update(_counters(store))
    run.values["joint_pass_s"] = req.seconds
    run.values.update({k: v for k, v in run.counters.items()
                       if k.startswith("vss_joint")})


def release(run: Run) -> None:
    store = run.state["store"]
    run.values["backend_put_bytes"] = put_bytes(store)
    base = Path(run.state["root"]) / "objects"
    run.values["stored_bytes"] = sum(
        f.stat().st_size for f in base.rglob("*.tvc")
        if ".tmp-" not in f.name)
    appended = sum(r.frames for r in run.requests
                   if r.kind == "append" and r.ok)
    cfg = run.config
    run.values["raw_bytes"] = appended * cfg["height"] * cfg["width"] * 3
    if run.device != "cpu":
        torch.cuda.empty_cache()


def _pan_left(scene, camera: int, t: int, overlap: float) -> float:
    """Where the camera's frame ``t`` starts in the panorama
    (``frames.render``'s pan, in f64)."""
    phase = (t % scene.pan_period) / scene.pan_period
    pan = scene.pan_px * (1.0 - abs(2.0 * phase - 1.0))
    return scene_frames.camera_offset(scene, camera, overlap) + pan


def _gop_map(store, cameras: int, gop: int) -> Dict[int, Tuple[int, int]]:
    """Catalog GOP id -> (camera, GOP index) of each camera's original."""
    cat = store.catalog
    out = {}
    for cam in range(cameras):
        for p in cat.physicals_for(f"cam{cam}"):
            if not p.is_original:
                continue
            for g in cat.gops_for(p.physical_id):
                out[g.gop_id] = (cam, g.start_frame // gop)
    return out


class _Expected:
    """What the store should hold and read back, from the reference."""

    def __init__(self):
        self.differing = 0
        self.h_error = 0.0
        self.side_a: Dict[Tuple[int, int], torch.Tensor] = {}
        self.side_b: Dict[Tuple[int, int], torch.Tensor] = {}
        self.pairs: List[str] = []


def _expect_records(run: Run, store, recon, gop_of, scene) -> _Expected:
    cfg = run.config
    tier = ref_tvc.tier(cfg["tier"])
    width, height = cfg["width"], cfg["height"]
    gop = int(run.traffic["gop_frames"])
    base = Path(run.state["root"]) / "objects"
    exp = _Expected()
    for jid in run.state["joint_ids"]:
        rec = store.catalog.get_joint(jid)
        a, b = gop_of.get(rec["gop_a"]), gop_of.get(rec["gop_b"])
        if a is None or b is None:
            exp.differing += 1
            continue
        exp.pairs.append(f"cam{a[0]}:{a[1]}+cam{b[0]}:{b[1]}")
        if rec["duplicate"]:
            exp.side_a[a] = recon[a]
            exp.side_b[b] = recon[a]
            continue
        parts_a, parts_b = [], []
        for k, seg in enumerate(rec["segments"]):
            h = np.asarray(seg["h"], np.float64).reshape(3, 3).astype(
                np.float32)
            s, n = int(seg["start"]), int(seg["num_frames"])
            shift = (_pan_left(scene, b[0], b[1] * gop + s, cfg["overlap"])
                     - _pan_left(scene, a[0], a[1] * gop + s,
                                 cfg["overlap"]))
            exp.h_error = max(exp.h_error,
                              ref_joint.corner_error(h, width, height, shift))
            cols = ref_joint.partition_columns(h, width, height)
            if cols is None or cols != (seg["x_f"], seg["x_g"]):
                exp.differing += 3
                continue
            cut = ref_joint.slices(recon[a][s:s + n], recon[b][s:s + n],
                                   *cols)
            got_recon = {}
            for part in ref_joint.PARTS:
                want, got_recon[part] = ref_joint.encode(cut[part], tier)
                path = base / seg["paths"][part]
                if not path.is_file() or path.read_bytes() != want:
                    exp.differing += 1
            composite = torch.cat([got_recon["left"], got_recon["overlap"]],
                                  dim=2)
            parts_a.append(composite)
            parts_b.append(ref_joint.side_b(composite, got_recon["right"], h,
                                            cols[1]))
        if parts_a:
            exp.side_a[a] = torch.cat(parts_a)
            exp.side_b[b] = torch.cat(parts_b)
    return exp


def check(run: Run) -> None:
    cfg = run.config
    store = run.state.pop("store")
    pools = run.state["pools"]
    gop = int(run.traffic["gop_frames"])
    fps = cfg["fps"]
    tier = ref_tvc.tier(cfg["tier"])
    limits = run.workload["limits"]
    try:
        appended = {(r.params["camera"], r.params["gop"])
                    for r in run.requests if r.kind == "append" and r.ok}
        recon = {(cam, i): ref_tvc.encode(
            torch.from_numpy(pools[cam][i]).to(run.device), tier)[2]
            for cam, i in sorted(appended)}
        gop_of = _gop_map(store, len(pools), gop)
        indexed = set(gop_of.values())
        missing = len(appended ^ indexed)
        scene = scene_frames.make_scene(
            cfg["height"], cfg["width"], cameras=len(pools),
            overlap=cfg["overlap"], seed=int(run.traffic["scene_seed"]),
            device=run.device)
        exp = _expect_records(run, store, recon, gop_of, scene)
        diff_a = diff_b = 0
        psnr_b = math.inf
        for cam, i in sorted(appended):
            try:
                out = store.read(f"cam{cam}", t=(i * gop / fps,
                                                 (i + 1) * gop / fps),
                                 cache=False)
                got = torch.from_numpy(np.ascontiguousarray(out.frames)).to(
                    run.device)
            except Exception:  # noqa: BLE001 - a GOP that does not read
                missing += 1
                continue
            key = (cam, i)
            want = exp.side_b.get(key, exp.side_a.get(key, recon[key]))
            if tuple(got.shape) != tuple(want.shape):
                missing += 1
                continue
            d = int((got.to(torch.int16) - want.to(torch.int16)).abs()
                    .max().item())
            if key in exp.side_b:
                diff_b = max(diff_b, d)
                psnr_b = min(psnr_b, ref_joint.psnr_min(got, recon[key]))
            else:
                diff_a = max(diff_a, d)
    finally:
        store.close()
        shutil.rmtree(run.state["root"], ignore_errors=True)
    run.values["joint_pairs"] = json.dumps(exp.pairs)
    run.checks = [
        Check("gops_missing", float(missing), 0.0),
        Check("joint_records", float(len(run.state["joint_ids"])), 1.0,
              le=False),
        Check("h_error_px", exp.h_error, float(limits["h_error_px"])),
        Check("joint_streams_differing", float(exp.differing), 0.0),
        Check("pixel_diff_max", float(diff_a), 0.0),
        Check("side_b_pixel_diff_max", float(diff_b),
              float(limits["side_b_pixel_diff_max"])),
        # no side b read: no reading, which fails as joint_records does
        Check("joint_psnr_min", psnr_b if math.isfinite(psnr_b) else 0.0,
              float(cfg["joint"]["tau_db"]), le=False),
    ]
