"""Wrapper for the homography-warp CUDA kernel (``csrc/warp.cu``).

Port of ``repro.kernels.warp.warp_pallas``: bilinear resampling through
a 3x3 inverse homography, zero outside the source.  A CUDA tensor
launches the kernel on the current stream, a CPU tensor runs the plain
``ref.warp``, any other device raises; there is no fallback from one to
the other.

Unlike the TPU wrapper there is no (8, 128) padding and no size
cut-off to the oracle: the kernel masks its own ragged edge and gathers
the source through L2 whatever its size.  It takes a leading frame
axis, so a whole GOP goes through one homography in one launch, and it
reads uint8 frames as they are stored (uint8 -> f32 is exact).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
SRC_DTYPES = (torch.uint8, torch.float32)
MAX_FRAMES = 65535  # the kernel's grid.z


def _lib():
    lib = _build.load("warp")
    if lib.vss_warp.argtypes is None:
        lib.vss_warp.argtypes = [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P]
        lib.vss_warp.restype = _I
    return lib


def hmat_f32(hmat_inv) -> np.ndarray:
    """The 3x3 homography as a contiguous f32 host array (a float64 one is
    rounded to nearest, as ``jnp.asarray(h, jnp.float32)`` rounds it)."""
    if isinstance(hmat_inv, torch.Tensor):
        hmat_inv = hmat_inv.detach().cpu().numpy()
    m = np.ascontiguousarray(hmat_inv, dtype=np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"homography must be 3x3, got {m.shape}")
    return m


def warp(
    img: torch.Tensor,  # (C, H, W) or (N, C, H, W), f32 or uint8
    hmat_inv,  # (3, 3): maps destination (x, y, 1) to source coordinates
    *,
    out_shape: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Returns the warped (…, C, oh, ow) f32 frames; every frame of a
    leading N axis goes through the same homography."""
    if img.dim() not in (3, 4):
        raise ValueError(
            f"img must be (C,H,W) or (N,C,H,W), got {tuple(img.shape)}")
    m = hmat_f32(hmat_inv)
    h, w = img.shape[-2:]
    oh, ow = out_shape if out_shape is not None else (h, w)
    if on_cpu(img):
        _build.count_plain("warp")
        return ref.warp(img, torch.from_numpy(m), (oh, ow))
    check_cuda(img, "img", SRC_DTYPES, img.dim())
    frames = img if img.dim() == 4 else img[None]
    n, c = frames.shape[:2]
    if n > MAX_FRAMES:
        raise ValueError(f"{n} frames in one warp; the kernel takes"
                         f" at most {MAX_FRAMES}")
    out = torch.empty((*img.shape[:-2], oh, ow), dtype=torch.float32,
                      device=img.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_warp(
            img.data_ptr(), img.element_size(), out.data_ptr(), n, c, h, w,
            oh, ow, m.ctypes.data, stream)
    _build.count_launch("warp")
    _build.check(lib, err, "warp")
    return out
