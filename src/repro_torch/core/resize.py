"""Resizing stored frames to a view's resolution, shared by the read
path (`store`) and joint compression's mixed resolutions (`joint`).

An integer box factor pools inside the ``vss.store.resample_box`` span:
on the card for a CUDA store (``kernels/box_mean.py``), on the host with
numpy otherwise; any other size is the bilinear resize on the store's
device."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.kernels import ops


def resample(frames: np.ndarray, resolution: Tuple[int, int], *,
             device: str = "cuda") -> np.ndarray:
    """Resize (T, H, W, C) uint8 frames to (width, height).

    An integer box factor pools on the card when ``device`` is CUDA
    (the frames go up, the pooled frames come down) and on the host with
    numpy, as the reference does, otherwise: the same bits either way.
    Any other size is a separable antialiased bilinear resize on
    ``device`` with the weights of ``jax.image.resize(..., "bilinear")``
    (`bilinear_weights`).  The sums run in another order than XLA's, so
    a value within float rounding of a .5 boundary may round the other
    way: the port agrees with the reference within 1 on uint8."""
    w, h = resolution
    t, ih, iw, c = frames.shape
    if (iw, ih) == (w, h):
        return frames
    if ih % h == 0 and iw % w == 0 and ih // h == iw // w:
        f = ih // h  # integer box downsample (matches the codec kernel)
        with _obs.span("vss.store.resample_box"):
            if torch.device(device).type == "cuda":
                x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
                return ops.box_mean(x, f).cpu().numpy()
            x = frames.astype(np.float32).reshape(t, h, f, w, f, c)
            x = x.mean((2, 4))
            return np.clip(np.round(x), 0, 255).astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    wy = bilinear_weights(ih, h, device)
    wx = bilinear_weights(iw, w, device)
    out = torch.einsum("thwc,hy,wx->tyxc", x.to(torch.float32), wy, wx)
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.cpu().numpy()


def bilinear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis of jax's antialiased
    bilinear resize (``jax._src.image.scale.compute_weight_mat`` with the
    triangle kernel, scale = out/in, translation 0): on downsampling the
    triangle widens by in/out, so every input pixel under an output
    pixel's footprint contributes."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(
        sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]
    ) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)
