"""Public kernel entry points of the port.

Responsibilities:
  * layout conversion: user-facing video is interleaved (T, H, W, C)
    uint8; kernels are channel-planar (T, C, H, W) f32,
  * dispatch by the device of the input tensor: a CUDA tensor goes to
    the hand-written kernel, a CPU tensor to its plain version in
    ``ref.py``, any other device raises.

There is no (8, 128) padding as in ``repro.kernels.ops``: the CUDA
kernels mask their own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401
from repro_torch.kernels.delta_codec import delta_decode, delta_encode  # noqa: F401
from repro_torch.kernels.transcode import transcode  # noqa: F401


def to_planar(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> contiguous (T, C, H, W) f32."""
    return torch.movedim(frames, -1, 1).to(torch.float32).contiguous()


def from_planar(frames: torch.Tensor, dtype=None) -> torch.Tensor:
    """(T, C, H, W) -> (T, H, W, C)."""
    out = torch.movedim(frames, 1, -1)
    return out.to(dtype) if dtype is not None else out
