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
