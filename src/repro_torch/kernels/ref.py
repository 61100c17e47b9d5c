"""Plain PyTorch versions of the port's kernels.

They define the semantics, mirror ``repro.kernels.ref`` line for line,
and run on whatever device their tensors are on: the CPU path of every
kernel wrapper, and the yardstick each CUDA kernel is held against on
the card.  ``jax.lax.scan`` becomes a Python loop over T.

Layouts are channel-planar: ``(T, C, H, W)`` for frame sequences and
``(C, H, W)`` for one frame.

The TVC codec (closed-loop DPCM):
  iframe  = frames[0]
  recon_0 = iframe
  r_t     = frames[t] - recon_{t-1}
  rq_t    = clip(round(r_t / q), lo, hi)            # quantized residual
  recon_t = clip(recon_{t-1} + rq_t * q, vmin, vmax)

``torch.round`` rounds half to even like ``jnp.round``.  The quotient
by q is taken by a same-device tensor, so it is a true IEEE division on
every device, as in ``repro.kernels.ref`` (a CUDA tensor divided by a
Python scalar is multiplied by the scalar's reciprocal instead).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def delta_encode(
    frames: torch.Tensor,  # (T, C, H, W)
    *,
    q: float,
    lo: int,
    hi: int,
    vmin: float,
    vmax: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (iframe (C,H,W) f32, residuals (T-1,C,H,W) int32)."""
    frames = frames.to(torch.float32)
    iframe = frames[0]
    resid = torch.empty((frames.shape[0] - 1, *frames.shape[1:]),
                        dtype=torch.int32, device=frames.device)
    recon = iframe
    for t in range(1, frames.shape[0]):
        r = frames[t] - recon
        rq = torch.clamp(torch.round(_div(r, q)), lo, hi)
        recon = torch.clamp(recon + rq * q, vmin, vmax)
        resid[t - 1] = rq.to(torch.int32)
    return iframe, resid


def delta_decode(
    iframe: torch.Tensor,  # (C, H, W)
    residuals: torch.Tensor,  # (T-1, C, H, W) int
    *,
    q: float,
    vmin: float,
    vmax: float,
) -> torch.Tensor:
    """Returns frames (T, C, H, W) f32 (recon chain; frame 0 == iframe)."""
    recon = iframe.to(torch.float32)
    out = torch.empty((residuals.shape[0] + 1, *recon.shape),
                      dtype=torch.float32, device=recon.device)
    out[0] = recon
    for t in range(residuals.shape[0]):
        recon = torch.clamp(recon + residuals[t].to(torch.float32) * q,
                            vmin, vmax)
        out[t + 1] = recon
    return out


def box_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean-pool the last two axes by ``factor`` (must divide H and W)."""
    if factor == 1:
        return x
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // factor, factor, w // factor, factor)
    # XLA lowers jnp's mean to a multiply by the f32 reciprocal of the
    # count; exact when factor is a power of two
    return x.sum(dim=(-3, -1)) * (1.0 / (factor * factor))


def transcode(
    iframe: torch.Tensor,
    residuals: torch.Tensor,
    *,
    q_in: float,
    q_out: float,
    factor: int,
    lo: int,
    hi: int,
    vmin: float,
    vmax: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """decode(q_in) -> box-downsample -> encode(q_out); returns
    (iframe_out (C,H/f,W/f) f32, residuals_out (T-1,C,H/f,W/f) int32)."""
    frames = delta_decode(iframe, residuals, q=q_in, vmin=vmin, vmax=vmax)
    small = box_downsample(frames, factor)
    return delta_encode(small, q=q_out, lo=lo, hi=hi, vmin=vmin, vmax=vmax)


# --------------------------------------------------------------------------
# homography warp (bilinear, zero fill outside)
# --------------------------------------------------------------------------

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as ``fmaf`` does, on any device.

    The product of two f32 values is exact in f64; the f64 sum and its
    exact error (TwoSum) give the exact result, and rounding the sum to
    odd before the one rounding to f32 keeps the double rounding from
    ever landing on the wrong side of an f32 tie (53 >= 24 + 2 bits)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, toward, s).to(torch.float32)


def to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> int32 conversion (truncating; NaN -> 0, out-of-range
    and infinite values saturate), as int64 so ``+ 1`` cannot overflow."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.trunc(x.to(torch.float64)).clamp(_I32_MIN, _I32_MAX).to(
        torch.int64)


def warp(
    img: torch.Tensor,  # (C, H, W) or (N, C, H, W)
    hmat_inv: torch.Tensor,  # (3, 3): maps dst (x, y, 1) -> src coords
    out_shape: Tuple[int, int] | None = None,
) -> torch.Tensor:
    """out[..., c, y, x] = bilinear(img[..., c], H^-1 @ [x, y, 1]), 0 where
    a corner falls outside the source; every frame of a leading N axis
    goes through the same homography.

    The arithmetic is ``repro.kernels.ref.warp``'s as XLA runs it on the
    CPU: each coordinate row of the 3x3 product is ``fma(m1, y, m0 * x)
    + m2`` (one fused multiply-add, then an add), and the bilinear tail
    has no fused operation."""
    h, w = img.shape[-2:]
    oh, ow = out_shape if out_shape is not None else (h, w)
    dev = img.device
    m = hmat_inv.to(device=dev, dtype=torch.float32)
    ys, xs = torch.meshgrid(
        torch.arange(oh, device=dev, dtype=torch.float32),
        torch.arange(ow, device=dev, dtype=torch.float32), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    sxyz = [fma_f32(m[r, 1], ys, m[r, 0] * xs) + m[r, 2] for r in range(3)]
    sx = sxyz[0] / sxyz[2]
    sy = sxyz[1] / sxyz[2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = to_int32_saturating(x0)
    y0i = to_int32_saturating(y0)

    flat = img.to(torch.float32).reshape(*img.shape[:-2], h * w)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        vals = flat.index_select(-1, idx)
        return torch.where(valid, vals, torch.zeros_like(vals))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx
    out = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    return out.reshape(*img.shape[:-2], oh, ow)


# --------------------------------------------------------------------------
# per-channel histogram fingerprints
# --------------------------------------------------------------------------

def histogram_scale(bins: int, vmax: float) -> float:
    """``bins / (vmax + 1)`` rounded to f32, as JAX rounds the weakly
    typed Python scalar it multiplies an f32 array by."""
    return float(np.float32(bins / (vmax + 1.0)))


def histogram(
    frames: torch.Tensor,  # (N, C, H, W), values in [0, vmax]
    *,
    bins: int,
    vmax: float = 255.0,
) -> torch.Tensor:
    """Returns (N, C, bins) int32 per-channel histograms; a value's bin is
    ``clip(int32(x * f32(bins / (vmax + 1))), 0, bins - 1)``."""
    n, c = frames.shape[:2]
    x = frames.to(torch.float32) * histogram_scale(bins, vmax)
    v = torch.nan_to_num(torch.trunc(x), nan=0.0)  # int32(NaN) is 0
    idx = torch.clamp(v, 0, bins - 1).to(torch.int64).reshape(n * c, -1)
    key = idx + torch.arange(n * c, device=frames.device)[:, None] * bins
    counts = torch.bincount(key.reshape(-1), minlength=n * c * bins)
    return counts.reshape(n, c, bins).to(torch.int32)


# --------------------------------------------------------------------------
# fused per-frame MSE (sum of squared error; mean taken by caller)
# --------------------------------------------------------------------------

def mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (N, H, W) -> (N,) f32 sums of squared differences."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).sum(dim=(1, 2))


# --------------------------------------------------------------------------
# paged decode attention (GOP-paged KV) — serving hot-spot
# --------------------------------------------------------------------------

def decode_scale(d: int) -> float:
    """``1 / sqrt(d)`` as the reference takes it: the square root in f32,
    then the quotient in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (P, page, Hkv, D)
    v_pages: torch.Tensor,  # (P, page, Hkv, D)
    block_table: torch.Tensor,  # (B, max_pages) int32, -1 = absent
    seq_lens: torch.Tensor,  # (B,) int32 — valid KV length per sequence
) -> torch.Tensor:
    """Single-token decode attention over block-table-paged KV, with the
    scale ``decode_scale(D)``.

    Returns (B, Hq, D) in q's dtype. Hq must be a multiple of Hkv (GQA).
    A row with no valid position is NaN, as the softmax over nothing but
    -inf gives.
    """
    b, hq, d = q.shape
    p, page, hkv, _ = k_pages.shape
    groups = hq // hkv
    scale = decode_scale(d)
    max_pages = block_table.shape[1]

    # Gather each sequence's KV: (B, max_pages*page, Hkv, D)
    safe_table = torch.clamp(block_table.long(), min=0)
    k = k_pages[safe_table].reshape(b, max_pages * page, hkv, d)
    v = v_pages[safe_table].reshape(b, max_pages * page, hkv, d)
    pos = torch.arange(max_pages * page, device=q.device)[None, :]  # (1, L)
    valid = (pos < seq_lens[:, None]) & (
        torch.repeat_interleave(block_table >= 0, page, dim=1)
    )

    qg = q.reshape(b, hkv, groups, d).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    logits = torch.einsum("bhgd,blhd->bhgl", qg, kf) * scale
    logits = torch.where(valid[:, None, None, :], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", probs, vf)
    return out.reshape(b, hq, d).to(q.dtype)
