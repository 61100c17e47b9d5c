"""Transcode + look-back cost models — §3.1.

Transcode cost:   c_t(f, P, S) = α(S_f, P_f, S, P) · |f|
with α the per-pixel cost of converting (spatial, physical) format
(S,P) → (S',P'). The paper calibrates α by running vbench on the install
hardware and interpolating piecewise-linearly over resolution; we do the
same against TVC (`calibrate()` times decode/encode/transcode per tier
at several resolutions and persists the table). A shipped default table
keeps the model usable without calibration.

Look-back cost:   c_l(Ω, f) = |A − Ω| + η·|(Δ − A) − Ω|,  η = 1.45
(Costa et al.: dependent frames ≈45% costlier to decode than
independent ones). For TVC, A = the I-frame of the GOP containing the
fragment start and Δ−A = the P-frames preceding the start within that
GOP; Ω is the set of frames already decoded by the previous selection.

I/O cost (beyond-paper): the paper's c_t assumes uniform fragment
fetch cost, which stops holding once GOP objects live on different
storage tiers (memory hot tier, local volumes, sharded pools, remote
stores).  ``io_cost(backend_kind, nbytes)`` prices the fetch as
latency + nbytes/throughput per backend *kind* (the class a
`StorageBackend.kind_for` reports), in the same relative units as α so
it composes additively with transcode cost.  The shipped defaults come
from fig22-style measurements (`benchmarks/fig22_backend_scaling.py`)
normalized against the rgb→tvc-hi encode rate — small enough not to
perturb transcode-vs-passthrough decisions, large enough that two
otherwise-equal fragments resolve to the faster tier.  ``calibrate_io``
re-measures the table on the install host's actual backends.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.codec import canonical_codec

ETA = 1.45  # dependent-frame decode premium

# Install-time calibration lands next to the store's catalog: a single
# JSON file holding the α table and the measured io_table together.
# `VSS` loads it at startup when present (`calibration_path`), falling
# back to the shipped defaults (`_default_table` + DEFAULT_IO_TABLE).
COST_MODEL_FILENAME = "cost_model.json"


def calibration_path(root: str) -> str:
    """Where a store rooted at ``root`` keeps its calibrated cost model."""
    return str(Path(root) / COST_MODEL_FILENAME)

# Default α table: per-pixel relative cost, keyed (codec_in, codec_out),
# each entry a list of (pixels_per_frame, cost_per_pixel) calibration
# points. "rgb" decode/encode is cheap (memcpy-ish); tvc tiers pay the
# recon chain; cross-tier transcode pays decode+encode (fused kernel
# halves the memory traffic — reflected by the fused discount).
_DEFAULT_POINTS = [(240 * 135, 1.0), (960 * 540, 1.0), (3840 * 2160, 1.0)]


def _flat(scale: float):
    return [(px, scale) for px, _ in _DEFAULT_POINTS]


def _default_table() -> Dict[str, list]:
    tiers = ("tvc-ll", "tvc-hi", "tvc-med", "tvc-lo")
    table: Dict[str, list] = {}
    for cin in ("rgb",) + tiers:
        for cout in ("rgb",) + tiers:
            if cin == "rgb" and cout == "rgb":
                cost = 0.15  # copy / crop only
            elif cin == "rgb":
                cost = 1.0  # encode
            elif cout == "rgb":
                cost = 1.0  # decode
            elif cin == cout:
                cost = 1.6  # decode + re-encode (no-op avoided by planner)
            else:
                cost = 1.6  # decode + re-encode (fused: see FUSED_DISCOUNT)
            table[f"{cin}->{cout}"] = _flat(cost)
    return table


FUSED_DISCOUNT = 0.65  # fused Pallas transcode vs staged decode→encode

# Default per-backend I/O profiles: kind -> (per-object latency,
# per-byte cost), in α's relative units (1.0 ≈ encoding one rgb pixel
# to tvc-hi).  Ratios follow the fig22 sweep on a warm local disk:
# memory serves from a dict (≈free next to any codec work); sharded
# volumes amortize per-object latency across the thread-pool fan-out
# the §3 multi-fragment plans trigger; remote object stores pay
# round-trip latency plus WAN-ish throughput.
DEFAULT_IO_TABLE: Dict[str, Tuple[float, float]] = {
    "memory": (0.0, 1e-4),
    "localfs": (2.0e3, 2e-2),
    "sharded": (2.0e3, 1.2e-2),
    # `ReplicatedBackend.kind_for` answers with the serving CHILD's kind
    # whenever a live replica holds the key, so this entry prices only
    # the fallback case (key resolvable on no live replica — a read that
    # will fail or be repaired); charge it like a slow local fetch
    "replicated": (2.4e3, 2e-2),
    # what `RemoteBackend.kind_for` answers (and `TieredBackend` answers
    # for a write-back cache MISS): an HTTP round trip per object plus
    # WAN-ish throughput.  Deliberately pessimistic next to the local
    # kinds so two otherwise-equal fragments always resolve to the
    # cached copy; `calibrate_io` replaces it with the measured profile
    # of the actual server (fig26 is the benchmark-side measurement).
    "remote": (5.0e5, 2e-1),
    "default": (2.0e3, 2e-2),
}


@dataclasses.dataclass
class CostModel:
    """α lookup with piecewise-linear interpolation over resolution,
    plus the per-backend-kind I/O profile."""

    table: Dict[str, list]
    fused_transcode: bool = True
    io_table: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_IO_TABLE)
    )

    @classmethod
    def default(cls) -> "CostModel":
        return cls(_default_table())

    @classmethod
    def load(cls, path: str) -> "CostModel":
        obj = json.loads(Path(path).read_text())
        if "alpha" in obj:  # current format: {"alpha": ..., "io": ...}
            io = {k: tuple(v) for k, v in obj.get("io", {}).items()}
            return cls(obj["alpha"], io_table={**DEFAULT_IO_TABLE, **io})
        return cls(obj)  # legacy alpha-only table

    def save(self, path: str) -> None:
        """Atomic publish (temp + ``os.replace``), matching the storage
        layer's discipline: a crash mid-save must never leave a torn
        table where the next startup expects a readable one."""
        p = Path(path)
        tmp = p.with_name(p.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps({
            "alpha": self.table,
            "io": {k: list(v) for k, v in self.io_table.items()},
        }))
        os.replace(tmp, p)

    def alpha(
        self, codec_in: str, codec_out: str, pixels_per_frame: int
    ) -> float:
        codec_in = canonical_codec(codec_in)
        codec_out = canonical_codec(codec_out)
        pts = self.table[f"{codec_in}->{codec_out}"]
        xs = np.array([p[0] for p in pts], dtype=np.float64)
        ys = np.array([p[1] for p in pts], dtype=np.float64)
        a = float(np.interp(pixels_per_frame, xs, ys))
        if (
            self.fused_transcode
            and codec_in != "rgb"
            and codec_out != "rgb"
            and codec_in != codec_out
        ):
            a *= FUSED_DISCOUNT
        return a

    def transcode_cost(
        self,
        codec_in: str,
        codec_out: str,
        num_pixels: int,
        pixels_per_frame: int,
    ) -> float:
        """c_t = α · |f| (|f| = total pixels in the fragment)."""
        return self.alpha(codec_in, codec_out, pixels_per_frame) * num_pixels

    PASSTHROUGH_ALPHA = 0.02  # byte copy of encoded GOPs (no codec work)

    def passthrough_cost(self, num_pixels: int) -> float:
        return self.PASSTHROUGH_ALPHA * num_pixels

    def io_cost(
        self, backend_kind: str, nbytes: int, objects: int = 1
    ) -> float:
        """Cost of fetching ``nbytes`` spread over ``objects`` GOP
        objects from a backend of the given kind (latency + bytes over
        throughput, in α's relative units)."""
        profile = self.io_table.get(backend_kind)
        if profile is None:
            profile = self.io_table.get("default", (0.0, 0.0))
        latency, per_byte = profile
        return objects * latency + per_byte * nbytes


# ---------------------------------------------------------------------------
# install-time calibration (the paper's vbench step, against TVC)
# ---------------------------------------------------------------------------

def calibrate(
    save_path: Optional[str] = None,
    resolutions: Tuple[Tuple[int, int], ...] = ((240, 136), (480, 272)),
    frames: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> CostModel:
    """Measure per-pixel transcode costs on ``device`` and build α.

    Times encode/decode/transcode for every codec pair at the given
    resolutions; normalizes so rgb→tvc-hi at the smallest resolution is
    1.0 (α is a *relative* per-pixel cost, exactly like vbench's
    normalized scores).
    """
    from repro_torch import codec as _codec

    rng = np.random.default_rng(seed)
    tiers = ("rgb", "tvc-ll", "tvc-hi", "tvc-med", "tvc-lo")
    raw: Dict[str, list] = {f"{a}->{b}": [] for a in tiers for b in tiers}
    norm = None
    for (w, h) in resolutions:
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        clip = np.stack([np.roll(base, t, axis=1) for t in range(frames)])
        encoded = {}
        for cin in tiers:
            encoded[cin] = _codec.encode_gop(clip, cin, device=device)
        px = w * h
        for cin in tiers:
            for cout in tiers:
                t0 = time.perf_counter()
                if cin == cout == "rgb":
                    _codec.decode_gop(encoded[cin], device=device)
                else:
                    _codec.transcode_gop(encoded[cin], cout, device=device)
                dt = time.perf_counter() - t0
                per_px = dt / (px * frames)
                raw[f"{cin}->{cout}"].append((px, per_px))
                if cin == "rgb" and cout == "tvc-hi" and norm is None:
                    norm = per_px
    norm = norm or 1.0
    table = {
        k: [(px, c / norm) for px, c in v] for k, v in raw.items()
    }
    model = CostModel(table)
    if save_path:
        model.save(save_path)
    return model


def _reference_pixels_per_second(frames: int = 8, side: int = 128,
                                 seed: int = 0,
                                 device: str = "cuda") -> float:
    """rgb→tvc-hi encode rate on this host — the normalization that puts
    I/O seconds on the same relative scale as the α table (where that
    conversion is 1.0 per pixel)."""
    from repro_torch import codec as _codec

    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 256, (frames, side, side, 3)).astype(np.uint8)
    _codec.encode_gop(clip, "tvc-hi", device=device)  # warm the build
    t0 = time.perf_counter()
    _codec.encode_gop(clip, "tvc-hi", device=device)
    dt = max(time.perf_counter() - t0, 1e-9)
    return clip.size / dt


def calibrate_io(
    backends: Dict[str, "object"],
    *,
    small_bytes: int = 4 << 10,
    large_bytes: int = 4 << 20,
    trials: int = 3,
    reference_pixels_per_s: Optional[float] = None,
    seed: int = 0,
    device: str = "cuda",
) -> Dict[str, Tuple[float, float]]:
    """Measure per-backend-kind I/O profiles (the fig22 measurement as
    an install-time step, mirroring ``calibrate`` for α).

    For each ``{kind: StorageBackend}`` entry, times best-of-``trials``
    gets of a small object (≈pure latency) and a large object
    (≈throughput-bound), converts seconds to α's relative units via the
    host's rgb→tvc-hi encode rate, and returns an ``io_table`` mapping
    suitable for ``CostModel(..., io_table=...)``.  Calibration objects
    are written under a reserved ``_calib/`` prefix and removed.
    """
    ref = reference_pixels_per_s or _reference_pixels_per_second(
        seed=seed, device=device)
    rng = np.random.default_rng(seed)
    out: Dict[str, Tuple[float, float]] = {}
    for kind, backend in backends.items():
        small = rng.integers(0, 256, small_bytes, dtype=np.uint8).tobytes()
        large = rng.integers(0, 256, large_bytes, dtype=np.uint8).tobytes()
        ks, kl = "_calib/small.bin", "_calib/large.bin"
        backend.put(ks, small)
        backend.put(kl, large)
        try:
            backend.get(ks), backend.get(kl)  # warm caches
            t_small = min(
                _timed(backend.get, ks) for _ in range(trials)
            )
            t_large = min(
                _timed(backend.get, kl) for _ in range(trials)
            )
        finally:
            backend.delete(ks)
            backend.delete(kl)
        per_byte_s = max(t_large - t_small, 0.0) / (large_bytes - small_bytes)
        latency_s = max(t_small - per_byte_s * small_bytes, 0.0)
        out[kind] = (latency_s * ref, per_byte_s * ref)
    return out


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0
