"""Checkpointing on VSS — checkpoints are logical videos over training time.

Mapping (DESIGN.md §3.3):
  * a checkpoint step serializes the state pytree into uint8 *frames*
    (fixed frame geometry, zero-padded tail) and writes one logical video
    ``<run>/<step>/<repr>`` per representation,
  * the **fp32 master** is the baseline-quality cover: retention always
    keeps the newest `keep_last` masters (the paper's "original can
    always be reproduced" guarantee, re-expressed over training time),
  * **bf16 / int8 serving copies** are derived views — cheap to recreate,
    first to go under storage pressure (LRU_VSS redundancy offset: they
    are strictly-lower-quality covers of the master),
  * cold masters are shrunk in place by VSS's **deferred zstd
    compression** machinery (same GOP-wrapping path as §5.2),
  * writes are atomic: the video is written under a temp name and the
    manifest row is committed last; a crash mid-write leaves no visible
    checkpoint. `save_async` runs the serialization + write off-thread
    (the training loop keeps stepping), `wait()` joins.

Restore picks the best representation for the request: exact dtype view
if cached, else the master.  Values come back on the host: numpy arrays,
and bf16 leaves as CPU torch tensors (numpy has no bf16 of its own); the
caller moves them to its device.

Port of ``repro.train.checkpoint``: the frames and the spec of a tree
equal the reference's byte for byte (leaves in ``jax.tree_util`` order
under the same ``"a/b/c"`` keys, bf16 written through its bits with the
spec string ``"bfloat16"``), so either package restores the other's
checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import DeferredConfig, VSSConfig
from repro_torch.core.store import VSS
from repro_torch.tree import leaf_paths, tree_map, unflatten

FRAME_H, FRAME_W, FRAME_C = 64, 128, 3
FRAME_BYTES = FRAME_H * FRAME_W * FRAME_C

REPR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}
BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# pytree <-> frames
# ---------------------------------------------------------------------------

def _host(leaf):
    """A leaf on the host, not sharing memory with it: a numpy array, or a
    CPU bf16 tensor for bf16 (a tensor's, or numpy's extension dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    arr = np.array(leaf)
    if arr.dtype.name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _bytes(arr) -> Tuple[bytes, str]:
    if isinstance(arr, torch.Tensor):  # bf16
        return arr.contiguous().view(torch.int16).numpy().tobytes(), BF16
    return np.ascontiguousarray(arr).tobytes(), str(arr.dtype)


def int8_scale(arr: np.ndarray) -> float:
    """The reference's ``max(|arr|.max(), 1e-12) / 127`` as numpy 2 gives
    it: f32 arithmetic, except below 1e-12, where the Python floats'."""
    amax = np.float32(np.abs(arr).max())
    if 1e-12 > amax:
        return 1e-12 / 127.0
    return float(amax / np.float32(127.0))


def tree_to_frames(tree, cast=None) -> Tuple[np.ndarray, Dict]:
    """Serialize a tree of tensors or arrays to (T, 64, 128, 3) uint8
    frames + a spec; ``cast`` "bf16" or "int8" derives that view of its
    f32 leaves."""
    bufs, spec = [], []
    for key, leaf in leaf_paths(tree):
        arr = _host(leaf)
        scale = None
        f32 = not isinstance(arr, torch.Tensor) and arr.dtype == np.float32
        if cast == "bf16" and f32:
            arr = torch.from_numpy(arr).to(torch.bfloat16)
        elif cast == "int8" and f32:
            scale = int8_scale(arr)
            arr = np.clip(np.round(arr / np.float32(scale)), -127,
                          127).astype(np.int8)
        b, dtype = _bytes(arr)
        spec.append({
            "key": key,
            "shape": list(arr.shape),
            "dtype": dtype,
            "nbytes": len(b),
            "scale": scale,
        })
        bufs.append(b)
    blob = b"".join(bufs)
    pad = (-len(blob)) % FRAME_BYTES
    blob += b"\0" * pad
    frames = np.frombuffer(blob, np.uint8).reshape(
        -1, FRAME_H, FRAME_W, FRAME_C
    )
    return frames, {"leaves": spec, "total": len(blob) - pad}


def frames_to_tree(frames: np.ndarray, spec: Dict, like=None):
    """The leaves (numpy; bf16 as CPU torch tensors), or with ``like`` a
    tree of its structure holding them."""
    blob = frames.tobytes()
    leaves, off = [], 0
    for s in spec["leaves"]:
        raw = blob[off: off + s["nbytes"]]
        off += s["nbytes"]
        if s["dtype"] == BF16:
            arr = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(
                torch.bfloat16).reshape(s["shape"])
        else:
            arr = np.frombuffer(raw, np.dtype(s["dtype"])).reshape(s["shape"])
        if s["scale"] is not None:
            arr = arr.astype(np.float32) * np.float32(s["scale"])
        leaves.append(arr)
    if like is not None:
        return unflatten(like, leaves)
    return leaves


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointInfo:
    step: int
    reprs: List[str]
    nbytes: int
    created: float


class CheckpointManager:
    def __init__(
        self,
        root: str,
        run: str = "run",
        *,
        keep_last: int = 3,
        derived_reprs: Tuple[str, ...] = (),
        vss: Optional[VSS] = None,
        device: str = "cuda",
    ):
        self.root = root
        self.run = run
        self.keep_last = keep_last
        self.derived_reprs = derived_reprs
        os.makedirs(root, exist_ok=True)
        # checkpoints exist to survive a process death: pin the default
        # store to the durable local layout instead of inheriting
        # VSS_STORAGE_BACKEND (a memory-backed checkpoint store cannot
        # resume anything).  A pre-existing store written under another
        # persistent layout still opens: the layout guard rejects the
        # local pin and we fall back to the env-selected backend that
        # created it.  Callers with a dedicated replicated/sharded
        # checkpoint volume pass their own ``vss``.  ``device`` is the
        # default store's (its codec work: none for the raw frames).
        if vss is None:
            cfg = VSSConfig(
                deferred=DeferredConfig(enabled=False),  # driven here
                compaction=False,
                device=device,
            )
            try:
                vss = VSS(os.path.join(root, "vss"),
                          config=cfg.replace(backend="local"))
            except ValueError:
                vss = VSS(os.path.join(root, "vss"), config=cfg)
        self.vss = vss
        self._manifest_path = os.path.join(root, f"{run}.manifest.json")
        self._manifest: Dict[str, Dict] = self._load_manifest()
        self._worker: Optional[threading.Thread] = None

    # -- manifest (committed last → atomicity) ------------------------------
    def _load_manifest(self) -> Dict[str, Dict]:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {}

    def _commit_manifest(self):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)

    def _video_name(self, step: int, repr_: str) -> str:
        return f"{self.run}.step{step:08d}.{repr_}"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = True):
        state = tree_map(_host, state)  # snapshot now
        if blocking:
            self._save_impl(step, state)
        else:
            self.wait()
            self._worker = threading.Thread(
                target=self._save_impl, args=(step, state), daemon=True
            )
            self._worker.start()

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _save_impl(self, step: int, state):
        entry = {"reprs": {}, "created": time.time()}
        total = 0
        for repr_ in ("f32",) + tuple(self.derived_reprs):
            cast = None if repr_ == "f32" else repr_
            frames, spec = tree_to_frames(state, cast=cast)
            name = self._video_name(step, repr_)
            if self.vss.catalog.logical_exists(name):
                self.vss.drop(name)
            self.vss.write(name, frames, fps=1.0, codec="rgb")
            entry["reprs"][repr_] = {
                "video": name,
                "spec": spec,
                "frames": int(frames.shape[0]),
            }
            total += self.vss.catalog.total_bytes(name)
        entry["nbytes"] = total
        self._manifest[str(step)] = entry
        self._gc()
        self._commit_manifest()

    # -- retention + deferred compression of cold masters -------------------
    def _gc(self):
        steps = sorted(int(s) for s in self._manifest)
        protect = set(steps[-self.keep_last:])
        for s in steps:
            if s in protect:
                continue
            entry = self._manifest.pop(str(s))
            for r in entry["reprs"].values():
                self.vss.drop(r["video"])
        # cold = every protected master except the newest: zstd-wrap in place
        for s in steps[-self.keep_last:-1]:
            if str(s) not in self._manifest:
                continue
            name = self._manifest[str(s)]["reprs"]["f32"]["video"]
            while self.vss.deferred.compress_one(name) is not None:
                pass
            self._manifest[str(s)]["nbytes"] = sum(
                self.vss.catalog.total_bytes(r["video"])
                for r in self._manifest[str(s)]["reprs"].values()
            )

    # -- restore --------------------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(int(s) for s in self._manifest)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, repr_: str = "f32",
                like=None):
        """Returns (the state tree on the host, its step) at `step`
        (default latest)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints")
        entry = self._manifest[str(step)]
        use = repr_ if repr_ in entry["reprs"] else "f32"
        r = entry["reprs"][use]
        res = self.vss.read(r["video"], codec="rgb", cache=False)
        return frames_to_tree(res.frames, r["spec"], like=like), step

    def stats(self) -> Dict[int, CheckpointInfo]:
        return {
            int(s): CheckpointInfo(
                int(s), list(e["reprs"]), e["nbytes"], e["created"]
            )
            for s, e in self._manifest.items()
        }

    def close(self):
        self.wait()
        self.vss.close()

