"""Wrapper for the integer box-mean CUDA kernel (``csrc/box_mean.cu``).

Replaces no TPU kernel: the reference pools a view read at a fraction
of the stored size on the host with numpy (``repro.core.store.resample``),
as a CPU store of the port still does (``core/resize.py``).  (T, H, W, C)
uint8 frames with H and W divisible by f become (T, H/f, W/f, C) uint8:
each value is its f x f block's sum, exact in f32, divided by f*f (an
IEEE division), rounded half to even and clipped to 0..255 -- the bits
of numpy's ``astype(float32)``, ``mean`` over the two block axes,
``round``, ``clip`` and cast.

A CUDA tensor launches the kernel on the current stream, a CPU tensor
runs the plain ``box_mean_plain``, any other device raises; there is no
fallback from one to the other.  The kernel takes contiguous frames at
any offset: rows that do not lie on its load and store widths take its
scalar path.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
# 255 * f**2 < 2**24, so the f32 block sum is exact (csrc/box_mean.cu
# kMaxFactor)
MAX_FACTOR = 256


def _lib():
    lib = _build.load("box_mean")
    if lib.vss_box_mean.argtypes is None:
        lib.vss_box_mean.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]
        lib.vss_box_mean.restype = _I
    return lib


def _check(frames: torch.Tensor, factor: int) -> int:
    if frames.dim() != 4:
        raise ValueError(f"frames must be (T,H,W,C), got {tuple(frames.shape)}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"frames: dtype {frames.dtype}, the box mean takes"
                        " uint8")
    factor = operator.index(factor)
    if not 1 <= factor <= MAX_FACTOR:
        raise ValueError(f"factor {factor} outside 1..{MAX_FACTOR}")
    _t, h, w, _c = frames.shape
    if h % factor or w % factor:
        raise ValueError(f"factor {factor} does not divide {h}x{w}")
    return factor


def box_mean_plain(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device."""
    t, h, w, c = frames.shape
    x = frames.to(torch.float32).reshape(t, h // factor, factor,
                                         w // factor, factor, c)
    x = ref._div(x.sum(dim=(2, 4)), float(factor * factor))
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def box_mean(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, H/factor, W/factor, C) uint8."""
    factor = _check(frames, factor)
    if on_cpu(frames):
        _build.count_plain("box_mean")
        return box_mean_plain(frames, factor)
    check_cuda(frames, "frames", (torch.uint8,), 4)
    t, h, w, c = frames.shape
    out = torch.empty((t, h // factor, w // factor, c), dtype=torch.uint8,
                      device=frames.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_box_mean(frames.data_ptr(), out.data_ptr(), t, h, w, c,
                               factor, stream)
    _build.count_launch("box_mean")
    _build.check(lib, err, "box_mean")
    return out
