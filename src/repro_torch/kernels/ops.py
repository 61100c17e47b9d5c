"""Public kernel entry points of the port.

Responsibilities:
  * layout conversion: user-facing video is interleaved (T, H, W, C)
    uint8; kernels are channel-planar (T, C, H, W) f32,
  * dispatch by the device of the input tensor: a CUDA tensor goes to
    the hand-written kernel, a CPU tensor to its plain version in
    ``ref.py``, any other device raises.

There is no (8, 128) padding as in ``repro.kernels.ops``: the CUDA
kernels mask their own ragged edges.  Nor is there the reference's
12 MiB cut-off from the warp kernel to its oracle: the card's warp
gathers through L2 at any size.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (  # noqa: F401
    launch_counts,
    plain_counts,
    reset_launch_counts,
    reset_plain_counts,
)
from repro_torch.kernels.box_mean import box_mean  # noqa: F401
from repro_torch.kernels.delta_codec import delta_decode, delta_encode  # noqa: F401
from repro_torch.kernels.histogram import histogram  # noqa: F401
from repro_torch.kernels.mse import mse_sum  # noqa: F401
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_decode_attention,
)
from repro_torch.kernels.transcode import transcode  # noqa: F401
from repro_torch.kernels.warp import hmat_f32, warp  # noqa: F401


def to_planar(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> contiguous (T, C, H, W) f32."""
    return torch.movedim(frames, -1, 1).to(torch.float32).contiguous()


def from_planar(frames: torch.Tensor, dtype=None) -> torch.Tensor:
    """(T, C, H, W) -> (T, H, W, C)."""
    out = torch.movedim(frames, 1, -1)
    return out.to(dtype) if dtype is not None else out


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-frame mean squared error for (N, H, W) planes."""
    n = a.shape[-2] * a.shape[-1]
    return ref._div(mse_sum(a, b), float(n))


def psnr_from_mse(mse_val: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    m = torch.clamp(torch.as_tensor(mse_val, dtype=torch.float32), min=1e-12)
    return 10.0 * torch.log10(
        torch.tensor(peak * peak, dtype=torch.float32, device=m.device) / m)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """Per-frame PSNR for (N, H, W) planes (∞ capped at ~480 dB)."""
    return psnr_from_mse(mse(a, b), peak=peak)
