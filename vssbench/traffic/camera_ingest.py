"""Live camera ingest: closed-loop writers, one a camera, into one store.

Set-up draws each camera's frames on the device (``frames.py``) and
copies them to host memory, as a camera's frames would arrive: the
scene is the traffic file's ``scene_seed`` and the sensor noise the
run's seed, so every seed stores the same amount of work.  Each camera
has as many distinct GOPs as it writes: a fixed amount of work, the
GOPs a writer appends in about ``--seconds`` at the pace the cell's file
states (``gop_seconds``).  The window starts one thread a camera; each
opens ``VSS.writer``, appends its GOPs one after another, each as soon
as the last ``append`` returned, then calls ``close()``, the store's
durability barrier.  The window ends when every writer has closed.

The traffic file sets ``writers``, ``gop_frames`` and ``scene_seed``.  The check reads
the stored objects back from the backend's directory: every appended
GOP must be there with the right header, and a sample of them, drawn
from the seed with each camera's last GOP in it, must equal byte for
byte the reference's own encoding of the same input frames.
"""
from __future__ import annotations

import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from vssbench.harness import Check, Request, Run
from vssbench.reference import tvc as ref_tvc
from vssbench.traffic import frames as scene_frames
from vssbench.traffic.view_reads import CONTROL_TIER, make_store, put_bytes

SAMPLE_PER_WRITER = 3  # besides each camera's last GOP


def _gops_per_writer(run: Run) -> int:
    return max(1, round(run.seconds / float(run.workload["gop_seconds"])))


def setup(run: Run) -> None:
    cfg = run.config
    gop = int(run.traffic["gop_frames"])
    writers = int(run.traffic["writers"])
    n_gops = _gops_per_writer(run)
    scene = scene_frames.make_scene(
        cfg["height"], cfg["width"], cameras=writers,
        overlap=cfg["overlap"], seed=int(run.traffic["scene_seed"]),
        device=run.device, noise_seed=run.subseed("noise"))
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
    # through a store of its own, so nothing builds inside the window
    warm_root = str(Path(run.tmp) / "warm")
    warm = make_store(run, warm_root)
    w = warm.writer("warm", fps=cfg["fps"], codec=cfg["tier"], gop_frames=2)
    w.append(pools[0][0][:2])
    w.close()
    warm.close()
    shutil.rmtree(warm_root, ignore_errors=True)
    root = str(Path(run.tmp) / "store")
    store = make_store(run, root)
    run.state.update(pools=pools, store=store, root=root)
    run.values["pool_gops_per_writer"] = n_gops
    run.values["pool_host_bytes"] = sum(p.nbytes for p in pools)


def _writer(run: Run, cam: int, out: List[Request],
            lock: threading.Lock) -> None:
    store = run.state["store"]
    pool = run.state["pools"][cam]
    tier = CONTROL_TIER if run.control else run.config["tier"]
    w = store.writer(f"cam{cam}", fps=run.config["fps"], codec=tier,
                     gop_frames=int(run.traffic["gop_frames"]))
    for i in range(len(pool)):
        req = Request("append", time.perf_counter(),
                      params={"camera": cam, "gop": i})
        try:
            with torch.profiler.record_function("vss.append"):
                w.append(pool[i])
            req.frames = pool.shape[1]
            req.ok = True
        except Exception as exc:  # noqa: BLE001 - a failed append is counted
            req.error = f"{type(exc).__name__}: {exc}"
        req.t_end = time.perf_counter()
        with lock:
            out.append(req)
        if not req.ok:
            break
    req = Request("close", time.perf_counter(), params={"camera": cam})
    try:
        with torch.profiler.record_function("vss.close"):
            w.close()
        req.ok = True
    except Exception as exc:  # noqa: BLE001
        req.error = f"{type(exc).__name__}: {exc}"
    req.t_end = time.perf_counter()
    with lock:
        out.append(req)


def window(run: Run) -> None:
    writers = int(run.traffic["writers"])
    out: List[Request] = []
    lock = threading.Lock()
    errors: List[BaseException] = []
    t_begin = time.perf_counter()

    def body(cam: int) -> None:
        try:
            _writer(run, cam, out, lock)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(c,), daemon=True)
               for c in range(writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    run.window_s = time.perf_counter() - t_begin
    run.requests = sorted(out, key=lambda r: r.t_start)
    reg = run.state["store"].registry
    run.counters = {"vss_ingest_gops_total": reg.value(
        "vss_ingest_gops_total")}


def _objects(root: str) -> Dict[str, List[Path]]:
    """Each camera's stored objects, in GOP order, from the backend's
    directory (``objects/<video>/<physical>/<gop>.tvc``)."""
    out: Dict[str, List[Path]] = {}
    base = Path(root) / "objects"
    for video in sorted(p for p in base.iterdir() if p.is_dir()):
        files = [f for f in video.rglob("*.tvc") if ".tmp-" not in f.name]
        out[video.name] = sorted(files, key=lambda f: int(f.stem))
    return out


def release(run: Run) -> None:
    store = run.state.pop("store")
    run.values["backend_put_bytes"] = put_bytes(store)
    store.close()
    del store
    objects = _objects(run.state["root"])
    run.state["objects"] = objects
    stored = sum(f.stat().st_size for fs in objects.values() for f in fs)
    appended = sum(r.frames for r in run.requests
                   if r.kind == "append" and r.ok)
    h, w = run.config["height"], run.config["width"]
    run.values["stored_bytes"] = stored
    run.values["raw_bytes"] = appended * h * w * 3
    if run.device != "cpu":
        torch.cuda.empty_cache()


def check(run: Run) -> None:
    objects = run.state["objects"]
    pools = run.state["pools"]
    cfg = run.config
    gop = int(run.traffic["gop_frames"])
    tier = ref_tvc.tier(cfg["tier"])
    shape = (gop, cfg["height"], cfg["width"], 3)
    missing = 0
    differing = 0
    rng = run.rng("check")
    with ThreadPoolExecutor(8) as tp:
        for cam, pool in enumerate(pools):
            n = sum(1 for r in run.requests if r.kind == "append" and r.ok
                    and r.params["camera"] == cam)
            files = objects.get(f"cam{cam}", [])
            for f in files[:n]:
                with open(f, "rb") as fh:
                    head = fh.read(ref_tvc.HEADER_BYTES)
                try:
                    codec, got_shape, _, _ = ref_tvc.parse(head)
                except (ValueError, KeyError):
                    missing += 1
                    continue
                if codec != tier.name or tuple(got_shape) != shape:
                    missing += 1
            missing += max(0, n - len(files)) + max(0, len(files) - n)
            if n == 0:
                continue
            picks = {n - 1} | set(int(i) for i in rng.choice(
                n, size=min(n, SAMPLE_PER_WRITER), replace=False))
            for i in sorted(picks):
                if i >= len(files):
                    differing += 1
                    continue
                x = torch.from_numpy(pool[i]).to(run.device)
                iframe, resid, _ = ref_tvc.encode(x, tier)
                want = ref_tvc.blob(iframe, resid, tier, shape, tp)
                if files[i].read_bytes() != want:
                    differing += 1
    run.checks = [
        Check("gops_missing", float(missing), 0.0),
        Check("sampled_gops_differing", float(differing), 0.0),
    ]
    shutil.rmtree(run.state["root"], ignore_errors=True)
