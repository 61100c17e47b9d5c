"""What a view read should return, worked out from the written frames.

The benchmark's own statement of a read's semantics (``VSS.read`` in
``src/repro_torch/core/store.py``): the frames ``[f0, f1)`` of the
stored original, cut to the region, then resized.  An integer factor f
is the f x f box mean of uint8 values in float32, rounded half to even
and clipped, as ``store.resample`` does on the host.  Only integer
factors are used by the benchmark's traffic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def box_mean(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, H/f, W/f, C) uint8."""
    if factor == 1:
        return frames
    t, h, w, c = frames.shape
    x = frames.to(torch.float32).reshape(t, h // factor, factor,
                                         w // factor, factor, c)
    x = x.sum(dim=(2, 4)) / float(factor * factor)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def view(recon: torch.Tensor, f0: int, f1: int,
         resolution: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Frames [f0, f1) of the stored clip ``recon`` (T, H, W, C) uint8 at
    ``resolution`` (width, height), which must divide the frame."""
    x = recon[f0:f1]
    if resolution is None:
        return x
    w, h = resolution
    factor = x.shape[2] // w
    if factor * w != x.shape[2] or factor * h != x.shape[1]:
        raise ValueError(f"resolution {resolution} is not an integer"
                         f" factor of {tuple(x.shape[1:3])}")
    return box_mean(x, factor)
