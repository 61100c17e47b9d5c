"""What a camera pair stored jointly should hold and read back.

The benchmark's own statement of joint compression (the paper's §5.1,
Algorithm 1) for a pair of decoded GOPs f and g and a homography H that
maps g's pixel coordinates into f's:

- the column partition: x_f, g's left edge in f's coordinates (H at
  g's point (0, H/2)), and x_g, f's right edge in g's coordinates (H's
  inverse at f's point (W, H/2)), each rounded half to even;
- the unprojected merge: the overlap keeps f's own pixels;
- the three slices, f[:, :, :x_f], f[:, :, x_f:] and g[:, :, x_g:], each
  one TVC2 object in the pair's tier (``reference/tvc.py``);
- a read of f: its left and overlap slices side by side; a read of g:
  that composite warped through H into g's first x_g columns, then g's
  right slice.

The warp is the plain kernel's arithmetic: each coordinate row of the
3x3 product is one fused multiply-add then an add, in f32, the source
point a true division, the four taps weighted without a fused
operation and 0 outside the source; the host rounds the result half to
even and clips it to uint8.  It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vssbench.reference import tvc as ref_tvc

PARTS = ("left", "overlap", "right")
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def project(h: np.ndarray, x: float, y: float) -> Tuple[float, float]:
    """The point (x, y) through the 3x3 homography ``h``."""
    q = np.asarray(h, np.float64) @ np.array([x, y, 1.0])
    return q[0] / q[2], q[1] / q[2]


def partition_columns(h: np.ndarray, width: int, height: int
                      ) -> Optional[Tuple[int, int]]:
    """(x_f, x_g), or None where the pair has no overlap to cut."""
    mid = height / 2.0
    x_f = int(round(project(h, 0.0, mid)[0]))
    x_g = int(round(project(np.linalg.inv(np.asarray(h, np.float64)),
                            float(width), mid)[0]))
    if not (0 < x_f <= width and 0 < x_g <= width):
        return None
    return x_f, x_g


def slices(f: torch.Tensor, g: torch.Tensor, x_f: int, x_g: int
           ) -> Dict[str, torch.Tensor]:
    """The three (T, H, w, C) uint8 slices of the unprojected merge."""
    return {"left": f[:, :, :x_f], "overlap": f[:, :, x_f:],
            "right": g[:, :, x_g:]}


def encode(part: torch.Tensor, tier: ref_tvc.Tier, pool=None
           ) -> Tuple[bytes, torch.Tensor]:
    """A slice's TVC2 object and what a decoder reproduces from it."""
    part = part.contiguous()
    iframe, resid, recon = ref_tvc.encode(part, tier)
    return ref_tvc.blob(iframe, resid, tier, tuple(part.shape), pool), recon


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the exact sum in f64 (the product
    of two f32 values is exact there) with its error, rounded to odd
    before the one rounding to f32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, toward, s).to(torch.float32)


def _int32_saturating(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.trunc(x.to(torch.float64)).clamp(_I32_MIN, _I32_MAX).to(
        torch.int64)


def warp(frames: torch.Tensor, hmat_inv: np.ndarray,
         out_hw: Tuple[int, int]) -> torch.Tensor:
    """(T, H, W, C) uint8 frames sampled at ``hmat_inv`` @ (x, y, 1) of
    each output pixel, bilinear, rounded and clipped: (T, oh, ow, C)
    uint8."""
    t, h, w, c = frames.shape
    oh, ow = out_hw
    dev = frames.device
    m = torch.from_numpy(np.ascontiguousarray(hmat_inv, np.float32)).to(dev)
    ys, xs = torch.meshgrid(
        torch.arange(oh, device=dev, dtype=torch.float32),
        torch.arange(ow, device=dev, dtype=torch.float32), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    sx, sy, sz = [_fma_f32(m[r, 1], ys, m[r, 0] * xs) + m[r, 2]
                  for r in range(3)]
    sx, sy = sx / sz, sy / sz
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0i, y0i = _int32_saturating(x0), _int32_saturating(y0)
    flat = frames.permute(0, 3, 1, 2).to(torch.float32).reshape(t, c, h * w)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        vals = flat.index_select(-1, idx)
        return torch.where(valid, vals, torch.zeros_like(vals))

    out = (tap(y0i, x0i) * ((1 - fy) * (1 - fx))
           + tap(y0i, x0i + 1) * ((1 - fy) * fx)
           + tap(y0i + 1, x0i) * (fy * (1 - fx))
           + tap(y0i + 1, x0i + 1) * (fy * fx))
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.reshape(t, c, oh, ow).permute(0, 2, 3, 1).contiguous()


def side_b(composite: torch.Tensor, right: torch.Tensor, h: np.ndarray,
           x_g: int) -> torch.Tensor:
    """g as a read rebuilds it from f's composite and g's right slice."""
    g_over = warp(composite, h, (composite.shape[1], x_g))
    return torch.cat([g_over, right], dim=2)


def corner_error(h: np.ndarray, width: int, height: int,
                 shift: float) -> float:
    """The largest distance, in pixels, between a frame corner of g taken
    through ``h`` and the same corner moved right by ``shift`` (the
    pair's true, horizontal offset)."""
    worst = 0.0
    for x, y in ((0, 0), (width - 1, 0), (0, height - 1),
                 (width - 1, height - 1)):
        px, py = project(h, float(x), float(y))
        worst = max(worst, float(np.hypot(px - (x + shift), py - y)))
    return worst


def psnr_min(got: torch.Tensor, want: torch.Tensor,
             peak: float = 255.0) -> float:
    """The lowest per-frame PSNR of ``got`` against ``want``, dB."""
    d = got.to(torch.float64) - want.to(torch.float64)
    mse = (d * d).mean(dim=tuple(range(1, d.dim())))
    worst = float(mse.max().item())
    return math.inf if worst == 0 else 10 * math.log10(peak ** 2 / worst)

