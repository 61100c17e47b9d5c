#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of VSS (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and PyTorch built for CUDA.  In order it:

1. prints the card (``nvidia-smi`` name and power limit) and fails when
   torch sees no CUDA device;
2. builds the kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   all started together) and prints the build time;
3. checks, for each tier's q, that the kernels' division-free quotient
   rounds every finite f32 residual as the plain versions' r / q does;
   then holds each CUDA kernel against its plain PyTorch version on the
   card, at a 1080p 30-frame GOP and at a ragged shape, for every codec
   tier and transcode combination, and the joint path's warp and
   histogram at 1080p (a projective homography, one whose Z crosses 0,
   a 30-frame GOP), at ragged shapes and at the seams of their designs
   (output widths 1 to 1919, sources off 16-byte boundaries, rows outside
   the source; planes of 1 to 2 073 601 values, one value everywhere,
   NaN and infinities, 1 to the most bins, vmax other than 255); every
   output must be equal exactly (the warp's NaN, where a source
   coordinate is 0/0, in the same places), a second call must give the
   same bits, and histogram counts must sum to the values counted; one
   warmed histogram call must run exactly one operation on the device,
   its kernel (``torch.profiler``).  It times each kernel and its plain version with CUDA events (mean over
   many calls queued back to back), the warp and histogram beside a
   PyTorch yardstick (``F.grid_sample``, ``torch.bincount``) and an empty
   kernel (the harness's launch floor);
4. drives the storage manager end to end: ``VSS.write`` of a 1080p,
   90-frame synthetic road clip as ``hevc``, ``codec.transcode_gop`` of a
   stored GOP, and five ``VSS.read``s (whole clip, a time window, half
   resolution, re-encoded to ``h264``, a bilinear 2/3 resize).  Every
   decoded frame and blob must equal what the same operations give with
   ``device="cpu"`` (the plain versions; the bilinear resize within 1).
   Each of those seven paths runs with the launch counts set to 0 just
   before it and read just after, and in the CUDA run each must have
   launched exactly the kernels its plan needs;
5. drives the rest of the storage layer under ``VSS`` (the backends
   phase): the main path's clip and a second one (seed 1), 6 GOPs, are
   written as ``hevc`` with two ingest workers and read back (whole
   clips and ``t=(0.5, 1.7)``, past the cache) in a ``local`` store and
   on ``tiered:remote`` (write-back with its journal over the loopback
   object server, a hot tier of a third of the bytes: spills and
   flushes; a close, a reopen and the reads again; one adaptive tick
   after one window is read hot, which must demote; a ``/metrics``
   scrape showing the ``tiered`` and ``remote`` operations, spills,
   flushes and journal appends), ``replicated:3:2:2`` (one child's
   directory deleted, reads through the fallbacks, ``VSS.scrub``
   restoring every replica, the reads again) and ``sharded:4``.  Every
   read must equal the local store's (whose reads equal the main
   path's), every GOP object the local store's under the same catalog
   path, and every write and read must launch what the local store's
   did; ``ops.psnr`` of each store's whole read runs ``mse``.  It
   prints every step's time and launches;
6. drives joint compression (§5.1) in a fresh store, on ``"cuda"`` and
   then on ``"cpu"``: writes two 1080p 30-frame camera pairs as hevc,
   ``apply_joint_compression`` over pair A (side by side: joined) and
   pair B (with perspective: aborted, as the reference does), then reads
   all four cameras.  The two runs must agree in joint ids, ``joint``
   and ``gop`` rows, segment objects and decoded frames, and step by
   step the CUDA run's launches must equal the CPU run's calls of the
   plain versions; pair A's sides must read back at 24 dB or more.  It
   prints each step's time and the compress steps' split (decode, host
   features, warp, histogram, segment encode);
7. holds the serving path's kernels against their plain versions on the
   card: the paged decode attention at Qwen3-32B's decode shape (8
   sequences of 1 to 4096 tokens, 64 query and 8 KV heads of 128, pages
   of 16) in bf16 and f32, at Phi-3-mini's (32 and 32 heads of 96) and
   at a small ragged shape (absent pages, pages shared between rows,
   lengths at 1 and on a page boundary), and at the split-KV kernel's
   seams (lengths at the planned split boundaries and one either side,
   a split wholly on absent pages, rows with no valid position, one
   32 768-token sequence, Command R+'s 96 query heads on 8, heads of
   512): f32 within 1e-4, bf16 within one bf16 ulp of the plain
   version's f32 result, NaN in the same places, and two calls on the
   same inputs equal bit for bit; the per-frame squared error at thirty
   1080p planes in uint8 and f32, at the main path's ninety (1080, 5760)
   uint8 planes, at a ragged shape, all 0 against all 255, planes and
   pointers off 16-byte alignment and f32 NaN and infinities: within
   rtol 1e-5 (NaN and infinities in the same places), uint8 equal bit
   for bit to the true integer sum rounded once to f32, a second call
   the same bits, and one device operation in a warmed call.  It times
   both (the squared error at the main path's shape, and at thirty 1080p
   planes in uint8 and f32), the paged attention's two kernels apart
   (``torch.profiler``), and a gather of the pages followed by
   ``scaled_dot_product_attention`` (the paged attention's
   ``library_ms``).  ``ops.psnr`` of the main path's whole-clip read
   against its source must agree with its plain version and with
   ``exact_mse`` frame by frame;
8. drives the serving engine (``ServingEngine``, a paged KV pool of 1024
   pages of 16 tokens) over a Qwen3-32B-width model cut to 16 of its 64
   layers, with random weights drawn on the card from seed 0: seven
   prompts of 128 to 1024 tokens (two share their first 512), 32 new
   tokens each, then a prompt identical to one of them.  Every token
   must be what the model's dense greedy path (``prefill`` and
   ``decode_step``, no kernel) picks when fed the same tokens, or a near
   tie there (reported); the dedup of the shared and identical prompts
   must be what the pool's page arithmetic predicts; the paged attention
   must launch once per layer and decode round; it prints prefill time
   per request, time to first token, and decode-round times;
9. prints one JSON line of per-kernel numbers, the card line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Any failed phase raises, and the script exits non-zero without the
result line.  It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch import codec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import features, fingerprint, joint  # noqa: E402
from repro_torch import storage as _storage  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    AdaptiveConfig,
    IngestConfig,
    TieringConfig,
    VSSConfig,
)
from repro_torch.core.deferred import is_wrapped, unwrap_bytes  # noqa: E402
from repro_torch.core.quality import exact_mse, exact_psnr  # noqa: E402
from repro_torch.core.store import VSS  # noqa: E402
from repro_torch.data.video import (  # noqa: E402
    synthesize_overlapping_pair,
    synthesize_road,
)
from repro_torch.kernels import (  # noqa: E402
    _build,
    delta_codec,
    histogram,
    ops,
    paged_attention,
    ref,
)
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate, and the f32 rate outside the
# tensor cores (the kernels do scalar f32 work).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

GOP_1080P = (30, 3, 1080, 1920)  # (T, C, H, W): one GOP of the main path
RAGGED = (7, 3, 17, 130)
# (q, lo, hi, residual dtype) of the four tiers: tvc-ll, -hi, -med, -lo
TIERS = ((1.0, -32768, 32767, torch.int16), (2.0, -128, 127, torch.int8),
         (8.0, -128, 127, torch.int8), (24.0, -128, 127, torch.int8))
TRANSCODE_Q = ((2.0, 8.0), (8.0, 2.0), (1.0, 24.0))
# 3 is odd; 12 is past the factors whose input recon states the kernel
# keeps in registers.  Each divides 1080 and 1920.
FACTORS = (1, 2, 3, 4, 12)

KERNELS = {
    "delta_encode": ("src/repro_torch/csrc/delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:61"),
    "delta_decode": ("src/repro_torch/csrc/delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:103"),
    "transcode": ("src/repro_torch/csrc/transcode.cu",
                  "src/repro/kernels/transcode.py:76"),
    "warp": ("src/repro_torch/csrc/warp.cu",
             "src/repro/kernels/warp.py:71"),
    "histogram": ("src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:51"),
    "mse": ("src/repro_torch/csrc/mse.cu", "src/repro/kernels/mse.py:42"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:87"),
}
MAIN_KERNELS = ("delta_encode", "delta_decode", "transcode")
JOINT_KERNELS = ("warp", "histogram")
SERVING_KERNELS = ("paged_attention", "mse")
FRAME_1080P = (3, 1080, 1920)  # (C, H, W): one frame of the joint path
# Z = 1 - x / 1024 is exactly 0 at column 1024 (X / Z = inf, and 0 / 0 at
# the origin's row): the zero fill and the saturating int32 conversion
Z_CROSSING_1080P = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                             [-2.0 ** -10, 0.0, 1.0]], np.float32)
Z_CROSSING = np.array([[0.5, 0.3, -40.0], [0.1, 2.0, 5.0],
                       [-0.013, 0.021, 0.3]], np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def tier_of(q: float):
    return next(t for t in TIERS if t[0] == q)


# device clock cycles spun before timed calls: about 0.1 s at the H100's
# clocks, more than the host needs to queue any ``reps`` calls timed here
HOLD_CYCLES = 200_000_000


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    calls queued back to back behind a spin of the device
    (``torch.cuda._sleep``): the calls are all queued before the device
    reaches them, so the host's per-call work (checks, ctypes) does not
    count even for kernels that run shorter than it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _exact(name: str, what: str, pairs) -> float:
    """Exact agreement of kernel and plain outputs; returns max |Δ|."""
    err = max(_err(k, p) for k, p in pairs)
    ok = all(torch.equal(k, p) for k, p in pairs)
    print(f"  {name:12s} {what:44s} max|d|={err:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: kernel != plain (max|d|={err})")
    return err


def _exact_nan(name: str, what: str, pairs) -> float:
    """``_exact`` for float outputs that may hold NaN (the warp's weights
    are NaN where a source coordinate is 0/0 or inf - inf): NaN in the
    same places, and every other value equal.  Returns max |Δ|."""
    for k, p in pairs:
        if not torch.equal(torch.isnan(k), torch.isnan(p)):
            print(f"  {name:12s} {what:44s} NaN in other places FAIL")
            raise AssertionError(f"{name} {what}: NaN in other places")
    return _exact(name, what, [(torch.nan_to_num(k), torch.nan_to_num(p))
                               for k, p in pairs])


# -- bounds: bytes each input read once and each output written once,
# and the f32 operations the arithmetic needs, over the card's peaks ------

def _bound(nbytes: float, ops_f32: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_f32 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encode_bound(t, c, h, w, rbytes):
    n = c * h * w
    # sub, mul, rint, max, min, mul, add, max, min per pixel and frame
    return _bound(t * n * 4 + n * 4 + (t - 1) * n * rbytes, 9 * (t - 1) * n)


def decode_bound(t, c, h, w, rbytes):
    n = c * h * w
    # mul, add, max, min per pixel and frame
    return _bound(n * 4 + (t - 1) * n * rbytes + t * n * 4, 4 * (t - 1) * n)


def transcode_bound(t, c, h, w, f, rin, rout):
    n_in, n_out = c * h * w, c * (h // f) * (w // f)
    nbytes = n_in * 4 + (t - 1) * n_in * rin + n_out * 4 + (t - 1) * n_out * rout
    # per input pixel: mul, add, max, min, sum; per output pixel: the
    # pooling multiply and the nine encode operations
    return _bound(nbytes, (t - 1) * (5 * n_in + 10 * n_out))


def warp_bound(n, c, h, w, oh, ow, src_bytes):
    pix = n * oh * ow
    # per output pixel: the three coordinate rows (mul, fma, add), two
    # divisions, two floors, two subtractions, the weights (two
    # subtractions, four multiplies); per pixel and channel 4 mul, 3 add
    return _bound(n * c * h * w * src_bytes + pix * c * 4,
                  pix * 19 + pix * c * 7)


def histogram_bound(n, c, h, w, bins, src_bytes):
    # multiply, convert, clamp (2) and count per value
    return _bound(n * c * h * w * src_bytes + n * c * bins * 4,
                  5 * n * c * h * w)


def _repeat_exact(name: str, what: str, first, fn) -> None:
    """A second call on the same inputs must give the same bits."""
    again = fn()
    a = first.view(torch.int32) if first.is_floating_point() else first
    b = again.view(torch.int32) if again.is_floating_point() else again
    if not torch.equal(a, b):
        raise AssertionError(f"{name} {what}: a second call gave other bits")


def warp_grid(hinv, h, w, oh, ow, device):
    """``F.grid_sample``'s normalised grid for the plain warp's source
    coordinates (align_corners=True: -1 and 1 are the centres of the
    first and last source pixel)."""
    m = torch.from_numpy(ops.hmat_f32(hinv)).to(device)
    ys, xs = torch.meshgrid(
        torch.arange(oh, device=device, dtype=torch.float32),
        torch.arange(ow, device=device, dtype=torch.float32), indexing="ij")
    sxyz = [ref.fma_f32(m[r, 1], ys, m[r, 0] * xs) + m[r, 2]
            for r in range(3)]
    sx, sy = sxyz[0] / sxyz[2], sxyz[1] / sxyz[2]
    return torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)[None]


def histogram_keys(x, bins, vmax=255.0):
    """``ref.histogram``'s plane-offset bin keys, for ``torch.bincount``."""
    n, c = x.shape[:2]
    v = torch.nan_to_num(torch.trunc(
        x.to(torch.float32) * ref.histogram_scale(bins, vmax)), nan=0.0)
    idx = torch.clamp(v, 0, bins - 1).to(torch.int64).reshape(n * c, -1)
    return (idx + torch.arange(n * c, device=x.device)[:, None] * bins
            ).reshape(-1)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def warp_cases(frame, gop, ragged, h_rl, x_g, rng, device):
    """(label, source, homography, out_shape) of every warp check: the
    joint path's shapes, the ragged ones, and the seams of the kernel's
    design (4 columns per thread, 16-byte stores only where OW is a
    multiple of 4, 32-bit offsets, sources at any alignment, X = 0 and
    Z near 0, floors past the int32 range)."""
    hinv = np.linalg.inv(h_rl)
    u8 = lambda *shape: torch.from_numpy(rng.integers(  # noqa: E731
        0, 256, shape, dtype=np.uint8)).to(device)
    shift = lambda d: np.array([[1, 0, d], [0, 1, d], [0, 0, 1]],  # noqa: E731
                               np.float32)
    rot = np.array([[0.9, -0.4, 300.0], [0.4, 0.9, -200.0], [0, 0, 1]],
                   np.float32)
    return (
        ("1080p uint8 inv(H_rl) full", frame, hinv, None),
        ("1080p f32 inv(H_rl) full", frame.float(), hinv, None),
        (f"1080p uint8 H_rl -> (1080, {x_g})", frame, h_rl, (1080, x_g)),
        (f"1080p 30-frame GOP H_rl -> (1080, {x_g})", gop, h_rl,
         (1080, x_g)),
        ("1080p uint8 Z crosses 0", frame, Z_CROSSING_1080P, None),
        ("ragged (3,17,130) -> (13,97)", ragged, Z_CROSSING, (13, 97)),
        ("ragged f32 (3,17,130) -> (13,97)", ragged.float(), hinv / 8,
         (13, 97)),
        # seams
        ("N=1 (1,3,1080,1920) inv(H_rl)", frame[None], hinv, None),
        ("30-frame GOP inv(H_rl) full", gop, hinv, None),
        *((f"out width {ow} inv(H_rl)", frame, hinv, (1080, ow))
          for ow in (1, 3, 4, 5, 1919)),
        ("f32 out width 1919", frame.float(), hinv, (1080, 1919)),
        ("rows of 1916 (4-byte, not 16-byte aligned)", u8(3, 1080, 1916),
         hinv, None),
        ("rows of 1917 (not 4-byte aligned)", u8(3, 1080, 1917), hinv,
         None),
        ("identity (X = 0 in column 0)", frame, np.eye(3, dtype=np.float32),
         None),
        ("scaled by 1e7 (floors past 2^22 and 2^31)", frame,
         np.diag([1e7, 1e7, 1.0]).astype(np.float32), (40, 64)),
        ("uint8 source 1 byte past a boundary", _unaligned(frame), hinv,
         None),
        ("f32 source 4 bytes past a boundary", _unaligned(frame.float()),
         hinv, None),
        ("shift by -0.5 (row -1 outside)", frame, shift(-0.5), None),
        ("shift by +0.5 (row 1080 outside)", frame, shift(0.5), None),
        ("zoom out x3", frame,
         np.diag([3.0, 3.0, 1.0]).astype(np.float32), (360, 640)),
        ("rotation", frame, rot, None),
        ("ragged source (3,9,10) -> (11,13)", u8(3, 9, 10), shift(-1.5),
         (11, 13)),
    )


def histogram_cases(frame, gop, ragged, rng, device, max_bins):
    """(label, frames, bins, vmax) of every histogram check: the joint
    path's shapes, the ragged ones, and the seams of the kernel's design
    (16-byte loads with a scalar head and tail, uint8 binned by
    byte >> shift or by the f32 arithmetic, lane-private counters up to
    32 bins and per-warp ones above, one value everywhere, values out of
    range)."""
    one = frame[None]
    rag2 = ragged[None].expand(2, -1, -1, -1).contiguous()

    def full(value, dtype):
        return torch.full((1, *FRAME_1080P), value, dtype=dtype,
                          device=device)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(device)

    cases = [
        ("(1,3,1080,1920) uint8", one, 16, 255.0),
        ("(1,3,1080,1920) f32", one.float(), 16, 255.0),
        ("(30,3,1080,1920) uint8", gop, 16, 255.0),
        ("ragged (2,3,17,130)", rag2, 8, 255.0),
        ("ragged (2,3,17,130) f32", rag2.float(), 32, 255.0),
        # seams
        ("one value 0 uint8", full(0, torch.uint8), 16, 255.0),
        ("one value 255 uint8", full(255, torch.uint8), 16, 255.0),
        *((f"one value {v} f32", full(v, torch.float32), 16, 255.0)
          for v in (float("nan"), float("inf"), float("-inf"), 1e30)),
        ("uint8 1 byte past a boundary", _unaligned(one), 16, 255.0),
        ("f32 4 bytes past a boundary", _unaligned(one.float()), 16, 255.0),
        ("f32 in [0, 1] vmax=1", torch.from_numpy(rng.random(
            (2, 3, 37, 61), dtype=np.float32)).to(device), 10, 1.0),
        ("f32 around [0, 127] vmax=127", torch.from_numpy(
            rng.normal(64.0, 60.0, (2, 3, 37, 61)).astype(np.float32)
        ).to(device), 16, 127.0),
        ("uint8 vmax=127 (no shift)", one, 16, 127.0),
    ]
    for size in (1, 15, 17, 2_073_601):
        x = u8(2 if size < 100 else 1, 3, 1, size)
        cases += [(f"plane of {size} uint8", x, 16, 255.0),
                  (f"plane of {size} f32", x.float(), 16, 255.0)]
    for bins in (1, 16, 17, 256, max_bins):
        cases += [("uint8", one, bins, 255.0),
                  ("f32", one.float(), bins, 255.0)]
    return cases


def check_joint_kernels(device: str, reps: int, seed: int = 0):
    """Hold the warp and histogram kernels against their plain versions
    at the joint path's 1080p shapes, at ragged ones and at the seams of
    their designs (exact, NaN in the same places, the same bits from a
    second call; histogram counts summing to the values counted); time
    both at the shapes the joint path launches most (one uint8 frame
    warped to full size, one uint8 frame's histograms), the warp also on
    a 30-frame GOP, each beside a PyTorch yardstick and an empty kernel
    (the launch floor of the timing harness)."""
    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0.0} for k in JOINT_KERNELS}
    _l, right, h_rl = synthesize_overlapping_pair(1, width=1920,
                                                  height=1080, seed=1)
    x_g = joint.partition_columns(h_rl, 1920, 1080)[1]
    frame = torch.from_numpy(np.ascontiguousarray(
        right[0].transpose(2, 0, 1))).to(device)  # (3, 1080, 1920) uint8
    gop = torch.from_numpy(rng.integers(
        0, 256, (30, *FRAME_1080P), dtype=np.uint8)).to(device)
    ragged = torch.from_numpy(rng.integers(
        0, 256, (3, 17, 130), dtype=np.uint8)).to(device)
    for what, img, hm, out_shape in warp_cases(frame, gop, ragged, h_rl,
                                               x_g, rng, device):
        k = ops.warp(img, hm, out_shape=out_shape)
        p = ref.warp(img, torch.from_numpy(ops.hmat_f32(hm)).to(device),
                     out_shape)
        res["warp"]["max_abs_err"] = max(
            res["warp"]["max_abs_err"],
            _exact_nan("warp", what, [(k, p)]))
        _repeat_exact("warp", what, k,
                      lambda: ops.warp(img, hm, out_shape=out_shape))
    hinv = np.linalg.inv(h_rl)
    hm32 = torch.from_numpy(ops.hmat_f32(hinv)).to(device)
    src = frame.float()[None]
    grid = warp_grid(hinv, 1080, 1920, 1080, 1920, device)
    gs = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=True)
    res["warp"].update(
        ms=time_ms(lambda: ops.warp(frame, hinv), reps),
        plain_ms=time_ms(lambda: ref.warp(frame, hm32), reps),
        library_ms=time_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), reps),
        library_err=_err(torch.nan_to_num(gs[0]),
                         torch.nan_to_num(ops.warp(frame, hinv))),
        gop_ms=time_ms(lambda: ops.warp(gop, h_rl, out_shape=(1080, x_g)),
                       reps),
        gop_bound_ms=warp_bound(30, *FRAME_1080P, 1080, x_g, 1)[0],
        gop_shape=[30, *FRAME_1080P, 1080, x_g],
        shape=[1, *FRAME_1080P], dtype="uint8->f32")
    res["warp"]["bound_ms"], res["warp"]["bound_by"] = warp_bound(
        1, *FRAME_1080P, 1080, 1920, 1)

    max_bins = histogram.max_bins()
    for what, x, bins, vmax in histogram_cases(frame, gop, ragged, rng,
                                               device, max_bins):
        what = f"{what} {tuple(x.shape)} bins={bins} vmax={vmax:g}"
        k = ops.histogram(x, bins=bins, vmax=vmax)
        p = ref.histogram(x, bins=bins, vmax=vmax)
        res["histogram"]["max_abs_err"] = max(
            res["histogram"]["max_abs_err"],
            _exact("histogram", what, [(k, p)]))
        if int(k.sum()) != x.numel():
            raise AssertionError(f"histogram {what}: counts do not sum to"
                                 f" {x.numel()}")
        _repeat_exact("histogram", what, k,
                      lambda: ops.histogram(x, bins=bins, vmax=vmax))
    one = frame[None]
    key = histogram_keys(one, 16)
    if not torch.equal(torch.bincount(key, minlength=3 * 16).view(1, 3, 16)
                       .to(torch.int32), ops.histogram(one, bins=16)):
        raise AssertionError("histogram: the bincount yardstick disagrees")
    res["histogram"].update(
        ms=time_ms(lambda: ops.histogram(one, bins=16), reps),
        plain_ms=time_ms(lambda: ref.histogram(one, bins=16), reps),
        library_ms=time_ms(lambda: torch.bincount(key, minlength=3 * 16),
                           reps),
        shape=list(one.shape), dtype="uint8")
    res["histogram"]["bound_ms"], res["histogram"]["bound_by"] = \
        histogram_bound(1, *FRAME_1080P, 16, 1)
    check_one_kernel_a_call(lambda: ops.histogram(one, bins=16), "histogram")
    res["launch_floor_ms"] = time_ms(lambda: torch.cuda._sleep(0), reps)
    return res


def check_one_kernel_a_call(fn, name: str) -> None:
    """Profile one warmed call of ``fn`` and require that the device ran
    exactly one operation in it, a kernel whose name holds ``name`` (no
    zeroing kernel, fill or memset beside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops_seen = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    print(f"  {name:12s} device operations in one warmed call: {ops_seen}")
    if len(ops_seen) != 1 or name not in ops_seen[0]:
        raise AssertionError(f"{name}: one warmed call ran {ops_seen} on"
                             f" the device, not one {name} kernel")


def check_kernels(device: str, shapes, reps: int, seed: int = 0):
    """Hold every kernel against its plain version at each shape; time
    both at the main path's shapes.  Returns per-kernel numbers."""
    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0.0} for k in MAIN_KERNELS}
    for label, (t, c, h, w) in shapes:
        frames = torch.from_numpy(
            rng.integers(0, 256, (t, c, h, w), dtype=np.uint8)
        ).to(device).to(torch.float32)
        main = label == "1080p"
        for q, lo, hi, rdt in TIERS:
            kw = dict(q=q, lo=lo, hi=hi, vmin=0.0, vmax=255.0)
            ik, rk = ops.delta_encode(frames, resid_dtype=rdt, **kw)
            ip, rp = ref.delta_encode(frames, **kw)
            rp = rp.to(rdt)
            what = f"{label} {tuple(frames.shape)} q={q:g} {rdt}"
            res["delta_encode"]["max_abs_err"] = max(
                res["delta_encode"]["max_abs_err"],
                _exact("delta_encode", what, [(ik, ip), (rk, rp)]))
            dkw = dict(q=q, vmin=0.0, vmax=255.0)
            dk = ops.delta_decode(ip, rp, **dkw)
            dp = ref.delta_decode(ip, rp, **dkw)
            res["delta_decode"]["max_abs_err"] = max(
                res["delta_decode"]["max_abs_err"],
                _exact("delta_decode", what, [(dk, dp)]))
            if main and q == 2.0:
                rb = rk.element_size()
                res["delta_encode"].update(
                    ms=time_ms(lambda: ops.delta_encode(
                        frames, resid_dtype=rdt, **kw), reps),
                    plain_ms=time_ms(
                        lambda: ref.delta_encode(frames, **kw), reps),
                    shape=list(frames.shape), dtype=str(rdt))
                res["delta_encode"]["bound_ms"], \
                    res["delta_encode"]["bound_by"] = encode_bound(
                        t, c, h, w, rb)
                res["delta_decode"].update(
                    ms=time_ms(lambda: ops.delta_decode(ip, rp, **dkw), reps),
                    plain_ms=time_ms(
                        lambda: ref.delta_decode(ip, rp, **dkw), reps),
                    shape=list(dk.shape), dtype=str(rdt))
                res["delta_decode"]["bound_ms"], \
                    res["delta_decode"]["bound_by"] = decode_bound(
                        t, c, h, w, rb)
        del frames
        for f in FACTORS:
            # at the ragged shape the OUTPUT is ragged: the input is f
            # times larger, since f must divide it
            ih, iw = (h, w) if main else (h * f, w * f)
            src = torch.from_numpy(
                rng.integers(0, 256, (t, c, ih, iw), dtype=np.uint8)
            ).to(device).to(torch.float32)
            for q_in, q_out in TRANSCODE_Q:
                _, lo_in, hi_in, rdt_in = tier_of(q_in)
                _, lo, hi, rdt_out = tier_of(q_out)
                ifr, rin = ref.delta_encode(src, q=q_in, lo=lo_in, hi=hi_in,
                                            vmin=0.0, vmax=255.0)
                rin = rin.to(rdt_in)
                kw = dict(q_in=q_in, q_out=q_out, factor=f, lo=lo, hi=hi,
                          vmin=0.0, vmax=255.0)
                iok, rok = ops.transcode(ifr, rin, resid_dtype=rdt_out, **kw)
                iop, rop = ref.transcode(ifr, rin, **kw)
                what = (f"{label} {(t, c, ih, iw)} f={f} q={q_in:g}->"
                        f"{q_out:g}")
                res["transcode"]["max_abs_err"] = max(
                    res["transcode"]["max_abs_err"],
                    _exact("transcode", what,
                           [(iok, iop), (rok, rop.to(rdt_out))]))
                if main and f == 2 and (q_in, q_out) == (2.0, 8.0):
                    res["transcode"].update(
                        ms=time_ms(lambda: ops.transcode(
                            ifr, rin, resid_dtype=rdt_out, **kw), reps),
                        plain_ms=time_ms(
                            lambda: ref.transcode(ifr, rin, **kw), reps),
                        shape=[t, c, ih, iw], dtype=f"{rdt_in}->{rdt_out}")
                    res["transcode"]["bound_ms"], \
                        res["transcode"]["bound_by"] = transcode_bound(
                            t, c, ih, iw, f, rin.element_size(),
                            rok.element_size())
            del src
    return res


class _Steps:
    """Runs named steps, each with the launch counts set to 0 just before
    it and read just after (the plain versions' calls on the CPU), and
    keeps each step's wall time."""

    def __init__(self, device: str):
        self.device = device
        self.secs = {}
        self.launches = {}

    def __call__(self, name: str, fn):
        ops.reset_launch_counts()
        ops.reset_plain_counts()
        t0 = time.perf_counter()
        result = fn()
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.secs[name] = time.perf_counter() - t0
        # on the CPU, the plain versions' calls stand in for launches
        self.launches[name] = (ops.launch_counts() if self.device == "cuda"
                               else ops.plain_counts())
        return result


def reads_for(clip: np.ndarray):
    """The main path's reads, each with the codecs its plan must read from
    and the kernel launches it must make, given the GOPs written and the
    GOPs it returns encoded.  The first read decodes every stored GOP and
    the cache keeps an rgb view of the clip, which serves every later
    read without a decode: the h264 read re-encodes from that view, and
    its ``frames`` decode what it encoded.  The 2/3 resize is no integer
    factor and so runs the bilinear path on the device; it comes last,
    because its cached view differs by up to 1 between devices."""
    _t, h, w, _c = clip.shape
    third = (w * 2 // 3, h * 2 // 3)
    return (
        ("whole clip as rgb", {}, {"tvc-hi"},
         lambda n, n_out: {"delta_decode": n}),
        ("t=(0.5, 1.7)", {"t": (0.5, 1.7)}, {"rgb"}, lambda n, n_out: {}),
        (f"resolution={(w // 2, h // 2)}", {"resolution": (w // 2, h // 2)},
         {"rgb"}, lambda n, n_out: {}),
        ("codec=h264", {"codec": "h264"}, {"rgb"},
         lambda n, n_out: {"delta_encode": n_out, "delta_decode": n_out}),
        (f"bilinear resolution={third}", {"resolution": third}, {"rgb"},
         lambda n, n_out: {}),
    )


def drive_store(root: str, clip: np.ndarray, device: str):
    """The storage manager's main path on ``device``: one write, a
    transcode of the first stored GOP, and five reads.  Each path runs
    with the launch counts set to 0 just before it and read just after.
    Returns every output, the wall times, the counts per path and the
    codecs each read's plan read from."""
    vss = VSS(root, config=VSSConfig(device=device, backend="local"))
    path = _Steps(device)
    out = {"reads": {}, "secs": path.secs, "launches": path.launches,
           "sources": {}, "spans": {}}

    path("write", lambda: vss.write("road", clip, codec="hevc"))
    gops = vss.catalog.gops_for(vss.catalog.get_original_id("road"))
    out["n_gops"] = len(gops)
    data = vss.backend.get(gops[0].path)
    if is_wrapped(data):
        data = unwrap_bytes(data)
    enc = codec.deserialize_gop(data)
    out["transcode_gop"] = codec.serialize_gop(path(
        "transcode_gop", lambda: codec.transcode_gop(
            enc, "tvc-med", scale_factor=2, device=device)))
    for name, kw, _src, _want in reads_for(clip):
        def read():
            r = vss.read("road", **kw)
            return r, r.frames
        r, frames = path(name, read)
        blobs = ([codec.serialize_gop(e) for e in r.encoded]
                 if r.encoded is not None else None)
        out["reads"][name] = (frames, blobs)
        plan = r.plan
        out["sources"][name] = {
            plan.runs[plan.run_idx(i)].physical.codec
            for i in range(len(plan.segments))}
        # the store's own trace of this read: plan, fetch, decode, admit
        spans = vss.recent_traces(1)[0].get("children", [])
        out["spans"][name] = {sp["name"]: sp["dur_s"] for sp in spans}
    vss.close()
    return out


def check_launches(run, clip: np.ndarray) -> None:
    """Every path of the CUDA run launched exactly the kernels its plan
    needs, and each read was planned from the codecs it expects: a path
    that ran on the host instead, or a plan that changed, fails here."""
    n = run["n_gops"]
    want = {"write": {"delta_encode": n}, "transcode_gop": {"transcode": 1}}
    for name, _kw, src, counts in reads_for(clip):
        blobs = run["reads"][name][1]
        want[name] = counts(n, len(blobs) if blobs is not None else 0)
        if run["sources"][name] != src:
            raise AssertionError(
                f"read {name} was planned from {run['sources'][name]},"
                f" expected {src}")
    for name, counts in want.items():
        got = run["launches"][name]
        print(f"  launches in {name}: {got}"
              + (f" (planned from {sorted(run['sources'][name])})"
                 if name in run["sources"] else ""))
        if got != counts:
            raise AssertionError(
                f"{name} launched {got}, expected {counts}; every path:"
                f" {run['launches']}")
    for kernel in MAIN_KERNELS:
        if not any(c.get(kernel) for c in run["launches"].values()):
            raise AssertionError(f"main path never launched {kernel}")


def compare_runs(gpu, cpu, clip: np.ndarray) -> None:
    t, h, w, c = clip.shape
    for name, _kw, _src, _want in reads_for(clip):
        fg, bg = gpu["reads"][name]
        fc, bc = cpu["reads"][name]
        if fg.shape != fc.shape:
            raise AssertionError(f"read {name}: {fg.shape} != {fc.shape}")
        if name.startswith("bilinear"):
            # the weighted sums run in another order on each device: a
            # value within rounding of .5 may land on either side
            d = int(np.abs(fg.astype(np.int16) - fc.astype(np.int16)).max())
            if d > 1:
                raise AssertionError(f"read {name}: max|d|={d} > 1")
            print(f"  read {name:24s} frames {fg.shape} within {d} of cpu")
            continue
        if not np.array_equal(fg, fc):
            raise AssertionError(f"read {name}: cuda frames != cpu frames")
        if bg != bc:
            raise AssertionError(f"read {name}: cuda blobs != cpu blobs")
        print(f"  read {name:24s} frames {fg.shape} equal on cuda and cpu"
              + (f", {len(bg)} blobs equal" if bg is not None else ""))
    whole = gpu["reads"]["whole clip as rgb"][0]
    if whole.shape != clip.shape:
        raise AssertionError(f"whole read shape {whole.shape} != {clip.shape}")
    err = int(np.abs(whole.astype(np.int16) - clip.astype(np.int16)).max())
    if err > 2:  # tvc-hi (q = 2) reconstructs within 2 of the source
        raise AssertionError(f"hevc round trip max|d|={err} > 2")
    print(f"  whole clip vs source: max|d|={err} (tvc-hi allows 2)")
    if gpu["reads"][f"resolution={(w // 2, h // 2)}"][0].shape != (
            t, h // 2, w // 2, c):
        raise AssertionError("half-resolution read has the wrong shape")
    if gpu["transcode_gop"] != cpu["transcode_gop"]:
        raise AssertionError("transcode_gop: cuda blob != cpu blob")
    hdr = codec.parse_gop_header(gpu["transcode_gop"])
    print(f"  transcode_gop -> {hdr[0]} {hdr[1]}: blob equal on cuda and cpu")


# -- the backends phase: the rest of the storage layer under VSS ---------

BACKENDS = ("tiered:remote", "replicated:3:2:2", "sharded:4")
# (step name, read keywords): every read skips the cache, so each one
# fetches its GOPs from the backend and decodes them on the card
BACKEND_READS = (("whole clip", {}), ("t=(0.5, 1.7)", {"t": (0.5, 1.7)}))
HOT_WINDOW = {"t": (0.0, 0.5)}  # the window the adaptive tick keeps hot
COLD_SLEEP_S = 3.0  # six half-lives: every epoch read before it goes cold
ADAPTIVE = dict(enabled=True, half_life_s=0.5, interval_s=0.5,
                min_view_score=1e9)  # tiering alone, no view materialized


def _gop_objects(vss) -> dict:
    """{catalog path: stored bytes} of every GOP the store indexes."""
    return {g.path: vss.backend.get(g.path) for g in vss.catalog.all_gops()}


def _read_all(vss, videos, step, frames, prefix=""):
    for name in videos:
        for what, kw in BACKEND_READS:
            frames[f"{prefix}read {name} {what}"] = step(
                f"{prefix}read {name} {what}",
                lambda: vss.read(name, cache=False, **kw).frames)


def _scrape(url: str) -> dict:
    """{sample with its labels: value} of a live ``/metrics``."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        body = resp.read().decode()
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            head, value = line.rsplit(" ", 1)
            out[head] = float(value)
    return out


def _tiered_remote_steps(vss, root, config, videos, step, frames):
    """Close (the write-back barrier), reopen with the adaptive policy
    on, read everything again, then heat one window and run one tick,
    and scrape the store's metrics.  Returns the new store, the tick's
    report and the metric samples."""
    step("close (flush barrier)", vss.close)
    vss = step("reopen", lambda: VSS(root, config=dataclasses.replace(
        config, adaptive=AdaptiveConfig(**ADAPTIVE))))
    _read_all(vss, videos, step, frames, prefix="reopened ")
    time.sleep(COLD_SLEEP_S)
    for i in range(5):
        step(f"hot window read {i}",
             lambda: vss.read("road", cache=False, **HOT_WINDOW).frames)
    report = step("adapt tick", vss.adapt)
    if not report.get("demoted", 0) > 0:
        raise AssertionError(f"adapt demoted nothing: {report}")
    samples = step("metrics scrape",
                   lambda: _scrape(vss.start_metrics_server().url))
    for kind in ("tiered", "remote"):
        n = sum(v for k, v in samples.items() if k.startswith(
            "vss_backend_ops_total{") and f'kind="{kind}"' in k)
        if not n > 0:
            raise AssertionError(f"/metrics shows no {kind} operations")
    for family in ("vss_cache_spills_total",
                   "vss_cache_writeback_flushes_total",
                   "vss_journal_appends_total"):
        if not samples.get(family, 0) > 0:
            raise AssertionError(f"/metrics: {family} is not above 0")
    return vss, report, samples


def _replicated_steps(vss, videos, step, frames):
    """Lose one child's directory, read through the fallbacks, scrub,
    and read again.  Returns the fallback count and the scrub report."""
    rb = _storage.unwrap(vss.backend, _storage.ReplicatedBackend)
    rb.quiesce()
    victim = rb.children[0].root
    shutil.rmtree(victim)
    os.makedirs(victim)
    before = rb.stats.fallback_reads
    _read_all(vss, videos, step, frames, prefix="degraded ")
    fallbacks = rb.stats.fallback_reads - before
    if not fallbacks > 0:
        raise AssertionError("no read fell back past the lost child")
    report = step("scrub", vss.scrub)
    counts = {g.path: rb.replica_count(g.path)
              for g in vss.catalog.all_gops()}
    short = {p: n for p, n in counts.items() if n != rb.replicas}
    if short or not report.replicas_repaired > 0 or report.gops_dropped:
        raise AssertionError(f"scrub left {short} under-replicated: {report}")
    _read_all(vss, videos, step, frames, prefix="scrubbed ")
    return fallbacks, report


def drive_backend(spec: str, root: str, videos, device: str,
                  hot_bytes=None):
    """One store on ``spec``: both videos written as hevc with two ingest
    workers, every read of `BACKEND_READS`, and the spec's own steps.
    Returns frames, objects, wall times, launch counts and notes."""
    step = _Steps(device)
    frames = {}
    config = VSSConfig(device=device, backend=spec,
                       registry=MetricsRegistry(),
                       ingest=IngestConfig(workers=2))
    if hot_bytes is not None:
        config = dataclasses.replace(
            config, tiering=TieringConfig(hot_bytes=hot_bytes))
    vss = step("open", lambda: VSS(root, config=config))
    for name, clip in videos.items():
        step(f"write {name}",
             lambda: vss.write(name, clip, fps=30.0, codec="hevc"))
    _read_all(vss, videos, step, frames)
    objects = _gop_objects(vss)
    notes = {}
    if spec == "tiered:remote":
        vss, notes["adapt"], samples = _tiered_remote_steps(
            vss, root, config, videos, step, frames)
        notes["metrics"] = {k: v for k, v in samples.items() if k in (
            "vss_cache_spills_total", "vss_cache_writeback_flushes_total",
            "vss_journal_appends_total", "vss_journal_fsyncs_total",
            "vss_remote_connections_created_total")}
    elif spec.startswith("replicated"):
        notes["fallback reads"], scrub = _replicated_steps(
            vss, videos, step, frames)
        notes["scrub"] = {"replicas_repaired": scrub.replicas_repaired,
                          "gops_dropped": scrub.gops_dropped}
    vss.close()
    return {"frames": frames, "objects": objects, "secs": step.secs,
            "launches": step.launches, "notes": notes}


def check_backend(spec: str, run, local) -> None:
    """Every read of ``run`` (again after a reopen, a lost child or a
    scrub) equals the ``local`` store's same read, every GOP object is
    the local store's object under the same catalog path, and each write
    and read launched what the local store's did."""
    for name, frames in run["frames"].items():
        base = name.split("read ", 1)[1]
        want = local["frames"][f"read {base}"]
        if frames.shape != want.shape or not np.array_equal(frames, want):
            raise AssertionError(f"{spec}: {name} != the local store's")
        got = run["launches"][name]
        if got != local["launches"][f"read {base}"]:
            raise AssertionError(
                f"{spec}: {name} launched {got}, the local store's read"
                f" {local['launches'][f'read {base}']}")
    for name, counts in local["launches"].items():
        if name.startswith("write") and run["launches"][name] != counts:
            raise AssertionError(
                f"{spec}: {name} launched {run['launches'][name]}, the"
                f" local store's {counts}")
    if run["objects"].keys() != local["objects"].keys():
        raise AssertionError(f"{spec}: catalog paths differ from local's")
    bad = [p for p, b in run["objects"].items() if b != local["objects"][p]]
    if bad:
        raise AssertionError(f"{spec}: objects differ from local's: {bad}")
    print(f"  {spec}: {len(run['frames'])} reads equal the local store's,"
          f" {len(run['objects'])} GOP objects equal byte for byte,"
          " launches equal in every write and read"
          + "".join(f"; {k} {v}" for k, v in run["notes"].items()))


def drive_backends(root: str, videos, device: str, main_frames=None):
    """The backends phase: a ``local`` store, then one store on each of
    `BACKENDS`, the tiered one with a hot tier of a third of the bytes
    the local store holds.  ``main_frames`` ({read name: frames} of the
    main path's CUDA run) ties the local store to that run.  Returns
    {spec: run}."""
    runs = {"local": drive_backend("local", os.path.join(root, "local"),
                                   videos, device)}
    local = runs["local"]
    for name, frames in (main_frames or {}).items():
        if not np.array_equal(local["frames"][f"read road {name}"], frames):
            raise AssertionError(f"local read road {name} != the main path's")
    hot_bytes = sum(len(b) for b in local["objects"].values()) // 3
    for spec in BACKENDS:
        runs[spec] = drive_backend(
            spec, os.path.join(root, spec.replace(":", "_")), videos,
            device, hot_bytes=hot_bytes if spec.startswith("tiered") else None)
        check_backend(spec, runs[spec], local)
    return runs


# -- the joint path (§5.1): two camera pairs at 1080p -------------------

JOINT_FRAMES = 30
JOINT_STEPS = ("write", "compress pair A", "compress pair B", "read a_l",
               "read a_r", "read b_l", "read b_r")
# apply_joint_compression's split: what each part times (module, name)
JOINT_SPLIT = {
    "decode": ((codec, "decode_gop"),),
    "host features": ((features, "estimate_homography"),
                      (features, "count_correspondences")),
    "warp": ((joint, "warp_frames"),),
    "histogram": ((fingerprint, "gop_fingerprint"),),
    "segment encode": ((codec, "encode_gop"),),
}


def joint_cameras():
    """Two pairs of 1080p cameras with half their view in common: pair A
    side by side (``projective_strength=0``), which Algorithm 1 joins;
    pair B with the default perspective, which it aborts after its
    candidate search and photometric verification (its matcher finds too
    few good corners at this size)."""
    a_l, a_r, _ = synthesize_overlapping_pair(
        JOINT_FRAMES, width=1920, height=1080, overlap=0.5, seed=0,
        projective_strength=0.0)
    b_l, b_r, _ = synthesize_overlapping_pair(
        JOINT_FRAMES, width=1920, height=1080, overlap=0.5, seed=0)
    return {"a_l": a_l, "a_r": a_r, "b_l": b_l, "b_r": b_r}


class _SplitTimer:
    """Adds the wall time of calls to the functions of ``JOINT_SPLIT`` by
    part, while active.  Each of them ends in a copy to the host, so the
    host clock covers its device work."""

    def __init__(self):
        self.secs = {part: 0.0 for part in JOINT_SPLIT}
        self._saved = []

    def __enter__(self):
        for part, targets in JOINT_SPLIT.items():
            for mod, name in targets:
                real = getattr(mod, name)

                def timed(*a, _real=real, _part=part, **kw):
                    t0 = time.perf_counter()
                    try:
                        return _real(*a, **kw)
                    finally:
                        self.secs[_part] += time.perf_counter() - t0

                self._saved.append((mod, name, real))
                setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved.clear()


def _joint_rows(root: str):
    con = sqlite3.connect(os.path.join(root, "catalog.sqlite"))
    try:
        return (con.execute("SELECT * FROM joint ORDER BY id").fetchall(),
                con.execute("SELECT * FROM gop ORDER BY id").fetchall())
    finally:
        con.close()


def _joint_objects(root: str):
    base = os.path.join(root, "objects")
    out = {}
    for d, _dirs, files in os.walk(base):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), base)
            if rel.startswith("_joint"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[rel] = fh.read()
    return out


def drive_joint(root: str, cams, device: str):
    """The joint path on ``device`` in a fresh store: write the four
    cameras as hevc (one 30-frame GOP each), jointly compress pair A,
    then pair B (merge "mean", tau 24 dB), and read every camera back.
    Each step runs with the launch and plain-call counts set to 0 just
    before it and read just after."""
    vss = VSS(root, config=VSSConfig(device=device, backend="local"))
    out = {"secs": {}, "launches": {}, "plain": {}, "reads": {},
           "split": {}, "ids": {}, "bytes": {}}

    def step(name, fn):
        ops.reset_launch_counts()
        ops.reset_plain_counts()
        t0 = time.perf_counter()
        result = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        out["secs"][name] = time.perf_counter() - t0
        out["launches"][name] = ops.launch_counts()
        out["plain"][name] = ops.plain_counts()
        return result

    def write_all():
        for name, frames in cams.items():
            vss.write(name, frames, codec="hevc", gop_frames=JOINT_FRAMES)

    step("write", write_all)
    for pair in ("A", "B"):
        names = [f"{pair.lower()}_l", f"{pair.lower()}_r"]
        before = sum(vss.catalog.total_bytes(n) for n in names)
        with _SplitTimer() as timer:
            out["ids"][pair] = step(
                f"compress pair {pair}", lambda: vss.apply_joint_compression(
                    names, merge="mean", tau_db=24.0))
        out["split"][pair] = dict(timer.secs)
        out["bytes"][pair] = (
            before, sum(vss.catalog.total_bytes(n) for n in names))
    for name in cams:
        out["reads"][name] = step(
            f"read {name}",
            lambda: vss.read(name, codec="rgb", cache=False).frames)
    out["records"] = [vss.catalog.get_joint(j) for j in out["ids"]["A"]]
    vss.close()
    out["rows"] = _joint_rows(root)
    out["objects"] = _joint_objects(root)
    return out


def check_joint(gpu, cpu, cams) -> None:
    """The CUDA run did what the CPU run did, launched what the CPU run
    called, and pair A reads back above Algorithm 1's threshold."""
    if len(gpu["ids"]["A"]) != 1 or gpu["records"][0]["duplicate"]:
        raise AssertionError(f"pair A: joint ids {gpu['ids']['A']},"
                             f" expected one non-duplicate record")
    if gpu["ids"]["B"] != []:
        raise AssertionError(f"pair B: joint ids {gpu['ids']['B']},"
                             " expected [] (Algorithm 1 aborts)")
    for key in ("ids", "rows", "bytes"):
        if gpu[key] != cpu[key]:
            raise AssertionError(f"joint path: cuda {key} != cpu {key}")
    if gpu["objects"] != cpu["objects"]:
        raise AssertionError("joint path: cuda segment objects != cpu")
    for name, frames in gpu["reads"].items():
        if not np.array_equal(frames, cpu["reads"][name]):
            raise AssertionError(f"joint path: read {name} differs")
    for name in JOINT_STEPS:
        got, want = gpu["launches"][name], cpu["plain"][name]
        print(f"  {name:16s} cuda launches {got}; cpu plain calls {want}")
        if got != want:
            raise AssertionError(
                f"joint {name}: cuda launched {got}, the cpu run called"
                f" the plain versions {want}")
        if gpu["plain"][name] or cpu["launches"][name]:
            raise AssertionError(f"joint {name}: the cuda run called a plain"
                                 " version or the cpu run launched")
    for name, kernels in (("compress pair A", JOINT_KERNELS),
                          ("compress pair B", JOINT_KERNELS),
                          ("read a_r", ("warp",))):
        for k in kernels:
            if not gpu["launches"][name].get(k):
                raise AssertionError(f"joint {name} never launched {k}")
    segs = gpu["records"][0]["segments"]
    print(f"  pair A joined: {len(segs)} segment(s), x_f/x_g "
          + ", ".join(f"{s['x_f']}/{s['x_g']}" for s in segs)
          + f"; rows, {len(gpu['objects'])} segment objects and every read"
          " equal on cuda and cpu; pair B aborted on both")
    for name in ("a_l", "a_r"):
        p = exact_psnr(gpu["reads"][name], cams[name])
        print(f"  read {name} vs source: {p:.2f} dB")
        if p < 24.0:
            raise AssertionError(f"joint read {name}: {p:.2f} dB < 24")


# -- the serving path's kernels: paged decode attention and the squared
# error behind PSNR ------------------------------------------------------

# Qwen3-32B decode: 8 sequences, 64 query / 8 KV heads of 128, pages of 16
QWEN3_DECODE = dict(b=8, hq=64, hkv=8, d=128, page=16)
QWEN3_LENS = (1, 4096)  # the 8 lengths are spread evenly over this range
PHI3_DECODE = dict(b=4, hq=32, hkv=32, d=96, page=16)
MSE_1080P = (30, 1080, 1920)
# ``ops.psnr`` and ``ops.mse`` of the main path's whole read: 90 frames of
# 1080 rows of 1920 RGB pixels, as (T, H, W * C) uint8 planes
MSE_PATH = (90, 1080, 5760)
# (a, b) byte offsets: 16-byte aligned, at one offset mod 16, one mod 4
# only, and at none
MSE_OFFSETS = ((0, 0), (2, 2), (15, 15), (4, 8), (5, 9), (1, 0), (3, 7),
               (15, 1))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, taken no lower than at 2**-7 (an absolute floor
    of 2**-14, under the f32 tolerance of 1e-4): nearer 0 a bf16 ulp is
    finer than the rounding of the f32 sums themselves."""
    m = x.abs().to(torch.float32).clamp(min=2.0 ** -7)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def paged_case(rng, b, hq, hkv, d, page, lens, device, extra_pages=0,
               bt=None):
    """Random q and pages (f32) and a block table giving each sequence
    its own scattered pages (or ``bt``), for lengths ``lens``."""
    lens = np.asarray(lens, np.int64)
    need = -(-lens // page)
    maxp = int(need.max()) if bt is None else len(bt[0])
    n_pages = int(need.sum()) + extra_pages if bt is None else int(
        np.max(bt)) + 1 + extra_pages
    if bt is None:
        perm = rng.permutation(n_pages)
        bt = np.full((b, maxp), -1, np.int64)
        at = 0
        for i, n in enumerate(need):
            bt[i, :n] = perm[at:at + n]
            at += n

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    q = t(rng.standard_normal((b, hq, d), dtype=np.float32))
    kp = t(rng.standard_normal((n_pages, page, hkv, d), dtype=np.float32))
    vp = t(rng.standard_normal((n_pages, page, hkv, d), dtype=np.float32))
    return q, kp, vp, t(bt, torch.int32), t(lens, torch.int32)


def valid_mask(bt: torch.Tensor, sl: torch.Tensor, page: int):
    """(B, maxp * page): the positions whose K/V the attention reads, below
    the length and on a page that is not absent."""
    pos = torch.arange(bt.shape[1] * page, device=bt.device)
    return (pos[None] < sl[:, None].long()) & (bt >= 0).repeat_interleave(
        page, dim=1)


def paged_bound(q, kp, bt, sl):
    _p, page, hkv, d = kp.shape
    n = int(valid_mask(bt, sl, page).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * n * hkv * d * kp.element_size())
    # per valid position and query head: D multiplies and adds for the
    # score, D for the weighted sum of V
    return _bound(nbytes, 4 * q.shape[1] * d * n)


def mse_bound(a):
    # both planes read, one f32 a frame written; subtract, multiply, add
    return _bound(2 * a.numel() * a.element_size() + 4 * a.shape[0],
                  3 * a.numel())


def gather_sdpa(q, kp, vp, bt, sl):
    """The yardstick: gather each sequence's pages, then PyTorch's fused
    attention over them with a mask (GQA)."""
    b, hq, d = q.shape
    _p, page, hkv, _ = kp.shape
    maxp = bt.shape[1]
    idx = bt.clamp(min=0).long()
    k = kp[idx].reshape(b, maxp * page, hkv, d).transpose(1, 2)
    v = vp[idx].reshape(b, maxp * page, hkv, d).transpose(1, 2)
    mask = valid_mask(bt, sl, page)
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None],
        scale=ref.decode_scale(d), enable_gqa=True)[:, :, 0]


def _check_paged(what, q, kp, vp, bt, sl) -> float:
    """Kernel against the plain version on the same inputs: f32 within
    1e-4, bf16 within one bf16 ulp of the plain f32 result; NaN (an empty
    row) in the same places; a second call gives the same bits.  Returns
    max |d| against the f32 result."""
    k = ops.paged_decode_attention(q, kp, vp, bt, sl)
    again = ops.paged_decode_attention(q, kp, vp, bt, sl)
    if not torch.equal(k.view(torch.uint8), again.view(torch.uint8)):
        print(f"  paged_attention {what:44s} two calls differ FAIL")
        raise AssertionError(f"paged_attention {what}: two calls differ")
    p32 = ref.paged_decode_attention(q.float(), kp.float(), vp.float(), bt,
                                     sl)
    if not torch.equal(torch.isnan(k), torch.isnan(p32)):
        print(f"  paged_attention {what:44s} NaN in other places FAIL")
        raise AssertionError(f"paged_attention {what}: NaN in other places")
    kf, pf = torch.nan_to_num(k.float()), torch.nan_to_num(p32)
    err = float((kf - pf).abs().max())
    if k.dtype == torch.float32:
        ok, tol = err <= 1e-4, "atol 1e-4"
    else:
        p16 = pf.to(torch.bfloat16).float()
        ulps = float(((kf - p16).abs() / bf16_ulp(p16)).max())
        ok, tol = ulps <= 1.0, f"{ulps:g} bf16 ulp"
    print(f"  paged_attention {what:44s} max|d|={err:.3g} ({tol})"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"paged_attention {what}: kernel != plain"
                             f" ({tol}, max|d|={err})")
    return err


def split_seam_cases(rng, device):
    """The split-KV kernel's seams, each in f32 and bf16: lengths at the
    planned split boundaries and one position either side; a row one of
    whose splits lies wholly on absent pages; rows with no valid position
    (every page absent, or length 0); one 32768-token sequence (many
    splits); Command R+'s grouping (96 query heads on 8 KV heads); heads
    of 512, whose rows a warp holds one at a time."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    b, hkv, page, maxp = 6, 8, 16, 64
    _n, chunk = paged_attention.plan_splits(b, hkv, maxp * page, n_sm)
    at = [chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
          2 * chunk + 1]
    seam = paged_case(rng, b=b, hq=64, hkv=hkv, d=128, page=page,
                      lens=[min(x, maxp * page) for x in at], device=device,
                      bt=np.arange(b * maxp).reshape(b, maxp))
    # row 0: valid pages, then 2 chunks' worth absent, then valid again;
    # row 1: every page absent; row 2: length 0
    _n, c3 = paged_attention.plan_splits(3, hkv, maxp * page, n_sm)
    hole = np.arange(3 * maxp).reshape(3, maxp)
    hole[0, c3 // page:3 * c3 // page] = -1
    hole[1] = -1
    gap = paged_case(rng, b=3, hq=64, hkv=hkv, d=128, page=page,
                     lens=[maxp * page, maxp * page, 0], device=device,
                     bt=hole)
    long = paged_case(rng, b=1, hq=64, hkv=8, d=128, page=16, lens=[32768],
                      device=device)
    cr = paged_case(rng, b=4, hq=96, hkv=8, d=128, page=16,
                    lens=[1, 1000, 3000, 4096], device=device)
    wide = paged_case(rng, b=2, hq=8, hkv=2, d=512, page=8, lens=[33, 900],
                      device=device)
    out = []
    for what, args in ((f"split seams (6,64,128) L chunk {chunk} +-1", seam),
                       ("absent split/all-absent/empty rows (3,64,128)", gap),
                       ("one sequence (1,64,128) kv 8 L 32768", long),
                       ("command-r+ (4,96,128) kv 8 L 1..4096", cr),
                       ("wide heads (2,8,512) kv 2 L 33, 900", wide)):
        out.append((f"{what} f32", args))
        out.append((f"{what} bf16", tuple(
            x.to(torch.bfloat16) if x.is_floating_point() else x
            for x in args)))
    return out


def device_ms_by_kernel(fn, reps: int):
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us > 0:
            out[e.key] = us / 1e3 / reps
    return out


def check_serving_kernels(device: str, reps: int, seed: int = 0):
    """Hold the paged attention and the squared-error kernel against their
    plain versions at the serving and quality shapes; time both at the
    shapes that matter (Qwen3-32B decode over 1 to 4096 tokens in bf16;
    thirty f32 1080p planes), and the gather + SDPA yardstick."""
    rng = np.random.default_rng(seed)
    res = {"paged_attention": {"max_abs_err": 0.0},
           "mse": {"max_abs_err": 0.0}}
    qwen_lens = np.linspace(*QWEN3_LENS, QWEN3_DECODE["b"]).astype(np.int64)
    f32 = paged_case(rng, lens=qwen_lens, device=device, extra_pages=64,
                     **QWEN3_DECODE)
    bf = tuple(x.to(torch.bfloat16) if x.is_floating_point() else x
               for x in f32)
    phi = paged_case(rng, lens=[1, 700, 1600, 2048], device=device,
                     **PHI3_DECODE)
    small = paged_case(rng, b=4, hq=4, hkv=2, d=64, page=16, lens=[1, 16, 33,
                       47], device=device,
                       bt=[[0, -1, 2, 5], [1, 3, -1, -1], [2, 4, 0, -1],
                           [2, -1, 4, 5]])
    seams = split_seam_cases(rng, device)
    cases = (
        ("qwen3 (8,64,128) kv 8 L 1..4096 f32", f32),
        ("qwen3 (8,64,128) kv 8 L 1..4096 bf16", bf),
        ("phi3 (4,32,96) kv 32 L 1..2048 f32", phi),
        ("phi3 (4,32,96) kv 32 L 1..2048 bf16",
         tuple(x.to(torch.bfloat16) if x.is_floating_point() else x
               for x in phi)),
        ("ragged (4,4,64) kv 2 absent/shared pages f32", small),
        ("ragged (4,4,64) kv 2 absent/shared pages bf16",
         tuple(x.to(torch.bfloat16) if x.is_floating_point() else x
               for x in small)),
        *seams,
    )
    for what, args in cases:
        res["paged_attention"]["max_abs_err"] = max(
            res["paged_attention"]["max_abs_err"], _check_paged(what, *args))
    yard = gather_sdpa(*bf)
    p32 = ref.paged_decode_attention(*(x.float() if x.is_floating_point()
                                       else x for x in bf))
    res["sdpa_err"] = float((yard.float() - p32).abs().max())
    res["paged_attention"].update(
        ms=time_ms(lambda: ops.paged_decode_attention(*bf), reps),
        plain_ms=time_ms(lambda: ref.paged_decode_attention(*bf), reps),
        shape=[*bf[0].shape, f"kv {QWEN3_DECODE['hkv']}",
               f"L {int(qwen_lens[0])}..{int(qwen_lens[-1])}"],
        dtype="bf16")
    res["paged_attention"]["bound_ms"], res["paged_attention"]["bound_by"] = \
        paged_bound(*bf[:2], *bf[3:])
    res["paged_attention"]["library_ms"] = res["sdpa_ms"] = time_ms(
        lambda: gather_sdpa(*bf), reps)
    res["paged_attention_f32_ms"] = time_ms(
        lambda: ops.paged_decode_attention(*f32), reps)
    res["paged_attention_parts_ms"] = device_ms_by_kernel(
        lambda: ops.paged_decode_attention(*bf), reps)
    del f32, bf, phi, small, seams, cases

    res["mse"] = check_mse(device, reps, rng)
    return res


def exact_u8_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The true per-frame sum of squared differences of uint8 planes, in
    int64, rounded to f32 once: what the kernel must give bit for bit."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return (d * d).sum(dim=(1, 2), dtype=torch.int64).to(torch.float32)


def offset_planes(rng, shape, off_a, off_b, dtype, device):
    """Contiguous (N, H, W) views of ``dtype`` that start ``off_a`` and
    ``off_b`` values into two fresh buffers (the buffers themselves lie
    on 512-byte boundaries): planes and pointers off 16-byte alignment."""
    n = int(np.prod(shape))
    raw = rng.integers(0, 256, (2, n + 16))
    bufs = torch.from_numpy(raw.astype(np.uint8)).to(device)
    if dtype == torch.float32:
        bufs = bufs.to(torch.float32) * 0.37
    a = bufs[0][off_a:off_a + n].view(shape)
    b = bufs[1][off_b:off_b + n].view(shape)
    return a, b


def mse_cases(rng, device):
    """(label, a, b) for the squared-error kernel, and the timed pairs by
    name.  The timed shapes, the main path's, the ragged one, all 0
    against all 255, the seams of its load plan (planes of 16k + 1 and
    16k + 15 bytes, a and b at offsets that share 16, only 4, or no
    alignment), f32 off 16-byte alignment, and f32 NaN and infinities."""
    gen = torch.Generator(device).manual_seed(int(rng.integers(2 ** 31)))

    def noisy(shape):  # drawn on the device: the main path's is 1.1 GB
        a = torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.uint8)
        d = torch.randint(-9, 10, shape, generator=gen, device=device,
                          dtype=torch.int16)
        return a, (a.to(torch.int16) + d).clamp(0, 255).to(torch.uint8)

    u8 = noisy(MSE_1080P)
    f32 = tuple(x.to(torch.float32) for x in noisy(MSE_1080P))
    path = noisy(MSE_PATH)
    ragged = torch.from_numpy(rng.standard_normal((5, 17, 130),
                                                  dtype=np.float32)).to(device)
    cases = [
        ("(30,1080,1920) uint8", *u8),
        ("(30,1080,1920) f32", *f32),
        ("ragged (5,17,130) f32", ragged, ragged * 0.5 + 1.0),
        ("ragged (5,17,130) uint8", u8[0][:5, :17, :130].contiguous(),
         u8[1][:5, :17, :130].contiguous()),
        ("main path (90,1080,5760) uint8", *path),
        ("(30,1080,1920) uint8 all 0 vs all 255",
         torch.zeros(MSE_1080P, dtype=torch.uint8, device=device),
         torch.full(MSE_1080P, 255, dtype=torch.uint8, device=device)),
    ]
    for shape in ((4, 17, 129), (3, 31, 97)):  # 2193 = 16k+1, 3007 = 16k+15
        for off_a, off_b in MSE_OFFSETS:
            label = ",".join(map(str, shape))
            cases.append((f"({label}) uint8 at +{off_a}/+{off_b} bytes",
                          *offset_planes(rng, shape, off_a, off_b,
                                         torch.uint8, device)))
    for off_a, off_b in ((1, 3), (2, 2), (0, 1)):
        cases.append((f"(4,17,129) f32 at +{off_a}/+{off_b} values",
                      *offset_planes(rng, (4, 17, 129), off_a, off_b,
                                     torch.float32, device)))
    a = torch.from_numpy(rng.standard_normal((3, 17, 130),
                                             dtype=np.float32)).to(device)
    b = a * 0.5
    a[0, 3, 7] = float("nan")
    a[1, 9, 100] = float("inf")
    a[2, 0, 0], b[2, 0, 0] = float("inf"), float("inf")  # inf - inf: NaN
    cases.append(("(3,17,130) f32 NaN, inf, inf - inf", a, b))
    return cases, {"path": path, "u8": u8, "f32": f32}


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def check_mse(device: str, reps: int, rng):
    """Hold the squared-error kernel against its plain version on every
    case of ``mse_cases``: within rtol 1e-5 (NaN and infinities in the
    same places), uint8 equal bit for bit to the true sum rounded once
    (``exact_u8_sum``), and a second call giving the same bits.  Times
    uint8 at the main path's shape (the JSON line's figures) and at thirty
    1080p planes, and f32 at thirty 1080p planes; one warmed call must run
    one device operation, the kernel."""
    res = {"max_abs_err": 0.0}
    cases, timed = mse_cases(rng, device)
    for what, a, b in cases:
        k = ops.mse_sum(a, b)
        again = ops.mse_sum(a, b)
        p = ref.mse_sum(a, b)
        sync(device)
        same = _same_bits(k, again)
        places = torch.equal(torch.isnan(k), torch.isnan(p)) and torch.equal(
            torch.isinf(k) & (k > 0), torch.isinf(p) & (p > 0))
        fin = torch.isfinite(p)
        kf, pf = k[fin], p[fin]
        rel = float(((kf - pf).abs() / pf.abs().clamp(min=1e-30)).max()) \
            if kf.numel() else 0.0
        exact = a.dtype != torch.uint8 or _same_bits(k, exact_u8_sum(a, b))
        ok = same and places and rel <= 1e-5 and exact
        print(f"  mse          {what:44s} max rel {rel:.3g} (rtol 1e-5)"
              f"{', = exact sum' if a.dtype == torch.uint8 else ''}"
              f"{'' if same else ', two calls differ'}"
              f"{'' if places else ', NaN/inf in other places'}"
              f"{'' if exact else ', != exact sum'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mse {what}: kernel != plain (rel {rel},"
                                 f" repeat {same}, NaN/inf {places},"
                                 f" exact {exact})")
        if kf.numel():
            res["max_abs_err"] = max(res["max_abs_err"],
                                     float((kf - pf).abs().max()))
    del cases
    path, u8, f32 = timed["path"], timed["u8"], timed["f32"]
    res.update(
        ms=time_ms(lambda: ops.mse_sum(*path), reps),
        plain_ms=time_ms(lambda: ref.mse_sum(*path), reps),
        shape=list(MSE_PATH), dtype="uint8")
    res["bound_ms"], res["bound_by"] = mse_bound(path[0])
    res["also"] = {
        "uint8_1080p_ms": time_ms(lambda: ops.mse_sum(*u8), reps),
        "uint8_1080p_bound_ms": mse_bound(u8[0])[0],
        "f32_1080p_ms": time_ms(lambda: ops.mse_sum(*f32), reps),
        "f32_1080p_plain_ms": time_ms(lambda: ref.mse_sum(*f32), reps),
        "f32_1080p_bound_ms": mse_bound(f32[0])[0],
    }
    check_one_kernel_a_call(lambda: ops.mse_sum(*u8), "mse")
    return res


def psnr_of_read(whole: np.ndarray, clip: np.ndarray, device="cuda"):
    """``ops.psnr`` of the whole-clip read against its source, frames as
    (T, H, W*C) uint8 on the card, with the launch counts set to 0 just
    before it: it must agree with the plain version (rtol 1e-5) and with
    ``exact_mse`` of each frame.  Returns (psnr per frame, launches)."""
    t, h, w, c = clip.shape
    a = torch.from_numpy(whole.reshape(t, h, w * c)).to(device)
    b = torch.from_numpy(clip.reshape(t, h, w * c)).to(device)
    ops.reset_launch_counts()
    got = ops.psnr(a, b)
    m = ops.mse(a, b)
    sync(device)
    launches = ops.launch_counts()
    plain = ops.psnr_from_mse(ref._div(ref.mse_sum(a, b), float(h * w * c)))
    exact = torch.tensor([exact_mse(whole[i:i + 1], clip[i:i + 1])
                          for i in range(t)], dtype=torch.float32)
    for name, x, y in (("psnr vs plain", got, plain),
                       ("mse vs exact_mse", m.cpu(), exact)):
        rel = float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
        print(f"  {name} of the whole read: max rel {rel:.3g} (rtol 1e-5)")
        if rel > 1e-5:
            raise AssertionError(f"{name}: max rel {rel} > 1e-5")
    if launches != {"mse": 2}:
        raise AssertionError(f"psnr and mse of the read launched {launches},"
                             " expected mse 2")
    return got.cpu().numpy(), launches


# -- the serving path: the paged-KV engine at Qwen3-32B width -------------

SERVING_LAYERS = 16  # of Qwen3-32B's 64: the depth cut
SERVING_NEW = 32
SERVING_LENS = (1024, 768, 640, 896, 128, 300, 1000)
SHARED_PREFIX = (0, 3, 512)  # requests 0 and 3 share their first 512 tokens
TWIN_OF = 5  # submitted again, identical, after its twin finished
# Largest paged-vs-dense logit difference allowed at any step: above the
# sound kernel's 0.0844 at this configuration, below what the planted
# faults give (``check_limit_catches_faults``).
NEAR_TIE_LIMIT = 0.15


def serving_prompts(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SERVING_LENS]
    a, b, n = SHARED_PREFIX
    prompts[b][:n] = prompts[a][:n]
    if prompts[b][n] == prompts[a][n]:
        prompts[b][n] = (prompts[a][n] + 1) % vocab
    return prompts


def drive_serving(model, cfg, prompts):
    """Serve the prompts on the card: all but the twin at once, then the
    twin.  The launch counts are set to 0 just before and read just
    after.  Each decode round's logits (kept on the card) and wall time,
    and each prefill's, are recorded by wrapping the engine's methods."""
    eng = ServingEngine(cfg, model, page_size=16, num_pages=1024,
                        max_batch=8)
    rec = {"logits": {}, "round_s": [], "prefill_s": []}
    real_decode, real_round, real_prefill = (
        eng._decode, eng._decode_round, eng._prefill)

    def decode(*args):
        rids = [a.req.rid for a in eng.active]
        logits = real_decode(*args)
        for i, rid in enumerate(rids):
            rec["logits"].setdefault(rid, []).append(logits[i].clone())
        return logits

    def decode_round(done):
        batch = len(eng.active)
        t0 = time.perf_counter()
        real_round(done)  # ends in the argmax's copy to the host
        rec["round_s"].append((time.perf_counter() - t0, batch))

    def prefill(tokens):
        t0 = time.perf_counter()
        out = real_prefill(tokens)
        sync(model.device)
        rec["prefill_s"].append(time.perf_counter() - t0)
        return out

    eng._decode, eng._decode_round, eng._prefill = (decode, decode_round,
                                                    prefill)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=SERVING_NEW) for p in prompts]
    done = eng.run()
    rids.append(eng.submit(prompts[TWIN_OF], max_new=SERVING_NEW))
    done.update(eng.run())
    sync(model.device)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    rec["done"] = [done[r] for r in rids]
    rec["metrics"] = dict(eng.metrics)
    rec["pages_in_use"] = eng.pool.pages_in_use
    return rec


def dense_differences(model, prompts, rec, report=True):
    """Feed the dense greedy path (no kernel) each request's prompt and
    then the engine's own tokens, and hold each step's logits against the
    engine's paged ones.  Raises if an engine token is not the argmax of
    its paged logits.  A token that is not the dense argmax is a near
    tie, printed when ``report``: it cannot fail, since the token is the
    paged argmax and so the dense margin is at most twice the logit
    difference.  Returns the largest paged-vs-dense logit difference,
    its (request, step), and the near ties."""
    all_prompts = list(prompts) + [prompts[TWIN_OF]]
    worst, at, ties = 0.0, None, []
    for ri, (req, prompt) in enumerate(zip(rec["done"], all_prompts)):
        if req.prompt != prompt or len(req.out) != SERVING_NEW:
            raise AssertionError(f"request {ri}: wrong prompt or"
                                 f" {len(req.out)} tokens")
        paged = rec["logits"][req.rid]
        cache = lm.init_cache(model, 1, len(prompt) + SERVING_NEW)
        lm.prefill(model, torch.tensor([prompt[:-1]], device=model.device),
                   cache)
        cur = prompt[-1]
        for step, tok in enumerate(req.out):
            dense, cache = lm.decode_step(
                model, cache, torch.tensor([[cur]], device=model.device))
            dense = dense[0, 0].float()
            mine = paged[step].float()
            if tok != int(mine.argmax()):
                raise AssertionError(
                    f"request {ri} step {step}: engine token {tok} is not"
                    f" the argmax {int(mine.argmax())} of its logits")
            d = float((mine - dense).abs().max())
            if d > worst:
                worst, at = d, (ri, step)
            top = int(dense.argmax())
            if tok != top:
                margin = float(dense[top] - dense[tok])
                ties.append((ri, step, tok, top, margin, d))
                if report:
                    print(f"  near tie: request {ri} step {step}: engine"
                          f" {tok}, dense {top}, dense margin {margin:.4f},"
                          f" logit difference {d:.4f}; continuing"
                          " teacher-forced")
            cur = tok
        del cache
    return worst, at, ties


def check_serving(model, cfg, prompts, rec):
    """(a) every engine token is the argmax of its paged logits, and
    those are within ``NEAR_TIE_LIMIT`` of the dense greedy path's, fed
    the same tokens (``dense_differences``); (b) dedup as the page
    arithmetic says; (c) one paged-attention launch per layer and decode
    round; (d) the pool within its pages.  Returns the largest
    paged-vs-dense logit difference and the near ties."""
    reqs = rec["done"]
    all_prompts = list(prompts) + [prompts[TWIN_OF]]
    worst, at, ties = dense_differences(model, prompts, rec)
    if worst > NEAR_TIE_LIMIT:
        raise AssertionError(f"request {at[0]} step {at[1]}: paged and dense"
                             f" logits differ by {worst} > {NEAR_TIE_LIMIT}")
    ps = 16
    a, b, n = SHARED_PREFIX
    want = [0] * len(all_prompts)
    want[b] = min(n, len(prompts[a]) - 1) // ps
    want[-1] = (len(prompts[TWIN_OF]) - 1) // ps
    got = [r.dedup_pages for r in reqs]
    print(f"  dedup pages per request: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"dedup pages {got}, expected {want}")
    steps = rec["metrics"]["decode_steps"]
    want_l = {"paged_attention": steps * cfg.num_layers}
    print(f"  launches in the serving run: {rec['launches']} ({steps} decode"
          f" rounds x {cfg.num_layers} layers)")
    if rec["launches"] != want_l:
        raise AssertionError(f"serving launched {rec['launches']}, expected"
                             f" {want_l}")
    if not 0 < rec["pages_in_use"] <= 1024:
        raise AssertionError(f"pages in use {rec['pages_in_use']}")
    return worst, ties


# Planted faults: the paged attention's lengths off by one either way.
# The first is the engine passing seq_lens where it means new_len.
FAULTS = (("seq_lens for new_len", -1), ("new_len + 1", 1))


def check_limit_catches_faults(model, cfg, prompts):
    """Serve the prompts again once per planted fault, the wrapper's
    lengths shifted; each run's largest paged-vs-dense logit difference
    must exceed ``NEAR_TIE_LIMIT``, or the limit could not see such a
    fault.  Returns the readings."""
    real = ops.paged_decode_attention
    readings = {}
    try:
        for name, shift in FAULTS:
            ops.paged_decode_attention = (
                lambda q, k, v, bt, sl, _s=shift: real(q, k, v, bt, sl + _s))
            rec = drive_serving(model, cfg, prompts)
            worst, at, ties = dense_differences(model, prompts, rec,
                                                report=False)
            readings[name] = worst
            print(f"  planted fault {name}: largest logit difference"
                  f" {worst:.4f} at request {at[0]} step {at[1]},"
                  f" {len(ties)} tokens off the dense argmax")
            if worst <= NEAR_TIE_LIMIT:
                raise AssertionError(f"planted fault {name} gives {worst},"
                                     f" within the limit {NEAR_TIE_LIMIT}")
            del rec
    finally:
        ops.paged_decode_attention = real
    return readings


def serving_model(cfg=None, device="cuda"):
    """Qwen3-32B at full width, cut to ``SERVING_LAYERS`` layers, with
    weights drawn on ``device`` from seed 0."""
    if cfg is None:
        cfg = dataclasses.replace(get_config("qwen3-32b"),
                                  num_layers=SERVING_LAYERS)
    t0 = time.perf_counter()
    model = lm.init_model(cfg, device=device,
                          generator=torch.Generator(device).manual_seed(0))
    sync(device)
    n = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"  {cfg.name} at full width cut to {cfg.num_layers} layers:"
          f" {n / 1e9:.3f} B parameters, {gb:.2f} GB of weights, drawn in"
          f" {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind}", flush=True)

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall; nvcc per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes"
                      " spill loads")]
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln]
        print(f"ptxas {name}: {len(regs)} kernels, registers"
              f" {sorted(set(regs))}, lines with spills: {len(spills)}")

    for q, _lo, _hi, _rdt in TIERS:
        bad = delta_codec.quotient_mismatches(q)
        print(f"  quotient by q={q:g}: {bad} of the finite f32 residuals"
              " round otherwise than r / q")
        if bad:
            raise AssertionError(f"kernel quotient by {q} is not r / q")
    print("kernels vs plain versions on the card (exact):", flush=True)
    knum = check_kernels("cuda", (("1080p", GOP_1080P), ("ragged", RAGGED)),
                         reps=20)
    jnum = check_joint_kernels("cuda", reps=50)
    launch_floor_ms = jnum.pop("launch_floor_ms")
    knum.update(jnum)
    print("serving kernels vs plain versions on the card:", flush=True)
    snum = check_serving_kernels("cuda", reps=20)
    knum.update({k: snum[k] for k in SERVING_KERNELS})
    for name, r in knum.items():
        print(f"  {name:12s} at {r['shape']} {r['dtype']}: kernel"
              f" {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound"
              f" {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    w, hg = knum["warp"], knum["histogram"]
    print(f"  warp of a uint8 30-frame GOP to {tuple(w['gop_shape'][-2:])}:"
          f" {w['gop_ms']:.4f} ms, bound {w['gop_bound_ms']:.4f} ms; yardsticks:"
          f" F.grid_sample of the f32 frame on a precomputed grid"
          f" {w['library_ms']:.4f} ms (max|d| vs the kernel"
          f" {w['library_err']:.3g}), torch.bincount of precomputed bin keys"
          f" {hg['library_ms']:.4f} ms; launch_floor_ms (an empty kernel,"
          f" same harness) {launch_floor_ms:.4f} [{card}]")
    print("  paged_attention's kernels at that shape, device ms per call"
          " (torch.profiler): " + "; ".join(
              f"{k[:70]} {v:.4f}" for k, v in
              snum["paged_attention_parts_ms"].items()) + f" [{card}]")
    print(f"  yardstick: gather + scaled_dot_product_attention at the same"
          f" bf16 qwen3 shape {snum['sdpa_ms']:.4f} ms (max|d| vs plain"
          f" {snum['sdpa_err']:.3g}); paged_attention in f32"
          f" {snum['paged_attention_f32_ms']:.4f} ms [{card}]")
    m = knum["mse"]["also"]
    print(f"  mse at {list(MSE_1080P)}: uint8 {m['uint8_1080p_ms']:.4f} ms"
          f" (bound {m['uint8_1080p_bound_ms']:.4f}), f32"
          f" {m['f32_1080p_ms']:.4f} ms (bound {m['f32_1080p_bound_ms']:.4f},"
          f" plain {m['f32_1080p_plain_ms']:.4f}) [{card}]")

    print("main path: VSS write/read of a 1080p 90-frame clip", flush=True)
    clip = synthesize_road(90, width=1920, height=1080, seed=0)
    with tempfile.TemporaryDirectory() as d_gpu:
        gpu = drive_store(os.path.join(d_gpu, "vss"), clip, "cuda")
    check_launches(gpu, clip)
    with tempfile.TemporaryDirectory() as d_cpu:
        cpu = drive_store(os.path.join(d_cpu, "vss"), clip, "cpu")
    compare_runs(gpu, cpu, clip)
    psnr, psnr_launches = psnr_of_read(gpu["reads"]["whole clip as rgb"][0],
                                       clip)
    print(f"  psnr of the whole read vs source: {float(psnr.min()):.2f} to"
          f" {float(psnr.max()):.2f} dB over {len(psnr)} frames; launches"
          f" {psnr_launches}")
    n = clip.shape[0]
    print(f"  write 90 frames as hevc: {gpu['secs']['write']:.3f} s,"
          f" {n / gpu['secs']['write']:.1f} frames/s [{card}]")
    for name, _kw, _src, _want in reads_for(clip):
        frames = gpu["reads"][name][0]
        s = gpu["secs"][name]
        print(f"  read {name}: {s:.3f} s, {frames.shape[0] / s:.1f}"
              f" frames/s [{card}]")
    print(f"  transcode_gop tvc-hi -> tvc-med x1/2:"
          f" {gpu['secs']['transcode_gop']:.3f} s [{card}]")
    for name, spans in gpu["spans"].items():
        print(f"  spans of read {name}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in spans.items()))

    print("backends phase: the main path's clip and a second one (seed 1),"
          f" 6 GOPs a store, on local and {', '.join(BACKENDS)}", flush=True)
    videos = {"road": clip, "road1": synthesize_road(
        90, width=1920, height=1080, seed=1)}
    main_frames = {"whole clip": gpu["reads"]["whole clip as rgb"][0],
                   "t=(0.5, 1.7)": gpu["reads"]["t=(0.5, 1.7)"][0]}
    backend_launches = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d_b:
        bruns = drive_backends(d_b, videos, "cuda", main_frames)
    backends_s = time.perf_counter() - t0
    for spec, run in bruns.items():
        for name, secs in run["secs"].items():
            print(f"  {spec} {name}: {secs:.3f} s, launches"
                  f" {run['launches'][name]} [{card}]")
        print(f"  {spec}: ops.psnr of its whole read of road vs source")
        _p, bpsnr = psnr_of_read(run["frames"]["read road whole clip"], clip)
        run["launches"]["psnr of the whole read"] = bpsnr
        backend_launches.update({f"backends {spec} {k}": v
                                 for k, v in run["launches"].items()})
    print(f"  backends phase: {backends_s:.1f} s wall [{card}]")
    del videos, bruns

    print(f"joint path: two 1080p camera pairs of {JOINT_FRAMES} frames",
          flush=True)
    t0 = time.perf_counter()
    cams = joint_cameras()
    print(f"  synthesized in {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as d_gpu:
        jgpu = drive_joint(os.path.join(d_gpu, "vss"), cams, "cuda")
    with tempfile.TemporaryDirectory() as d_cpu:
        jcpu = drive_joint(os.path.join(d_cpu, "vss"), cams, "cpu")
    check_joint(jgpu, jcpu, cams)
    for name in JOINT_STEPS:
        print(f"  {name}: cuda {jgpu['secs'][name]:.3f} s, cpu"
              f" {jcpu['secs'][name]:.3f} s [{card}]")
    for pair in ("A", "B"):
        before, after = jgpu["bytes"][pair]
        print(f"  pair {pair} stored bytes: {before} before, {after} after"
              f" ({1 - after / before:.4f} saved)")
        for run, label in ((jgpu, "cuda"), (jcpu, "cpu")):
            split = run["split"][pair]
            total = run["secs"][f"compress pair {pair}"]
            print(f"  split of compress pair {pair} ({label}, {total:.3f} s): "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
                  + f", other {total - sum(split.values()):.3f} s [{card}]")

    print(f"serving path: {SERVING_LAYERS} layers of qwen3-32b, paged KV"
          f" pool, {len(SERVING_LENS) + 1} requests", flush=True)
    cfg, model = serving_model()
    prompts = serving_prompts(cfg.vocab_size)
    srec = drive_serving(model, cfg, prompts)
    worst, ties = check_serving(model, cfg, prompts, srec)
    print(f"  largest paged-vs-dense logit difference {worst:.4f} (limit"
          f" {NEAR_TIE_LIMIT}); {len(ties)} near ties, where the engine's"
          " token is not the dense argmax")
    for i, req in enumerate(srec["done"]):
        print(f"  request {i}: prompt {len(req.prompt)} tokens, dedup"
              f" {req.dedup_pages} pages, time to first token"
              f" {req.first_token_s - req.submitted_s:.3f} s, done after"
              f" {req.done_s - req.submitted_s:.3f} s [{card}]")
    print("  prefill s per prefilled request: " + ", ".join(
        f"{x:.4f}" for x in srec["prefill_s"]) + f" [{card}]")
    rounds = srec["round_s"]
    for batch in sorted({b for _t, b in rounds}, reverse=True):
        ts = [t for t, b in rounds if b == batch]
        print(f"  decode rounds at batch {batch}: {len(ts)}, median"
              f" {np.median(ts) * 1e3:.2f} ms ({batch / np.median(ts):.1f}"
              f" tokens/s) [{card}]")
    gen = sum(b for _t, b in rounds)
    secs = sum(t for t, _b in rounds)
    print(f"  decode: {gen} tokens in {len(rounds)} rounds, {secs:.3f} s of"
          f" rounds ({gen / secs:.1f} tokens/s); whole run"
          f" {srec['wall_s']:.3f} s; metrics {srec['metrics']},"
          f" pages in use {srec['pages_in_use']} [{card}]")
    serving_launches = srec["launches"]
    del srec
    check_limit_catches_faults(model, cfg, prompts)
    del model

    kernels = []
    paths = dict(gpu["launches"])
    paths.update({f"joint {k}": v for k, v in jgpu["launches"].items()})
    paths["psnr of the whole read"] = psnr_launches
    paths.update(backend_launches)
    paths["serving run"] = serving_launches
    for name, (source, replaces) in KERNELS.items():
        r = knum[name]
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **r.get("also", {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
