"""Wrapper for the per-frame squared-error CUDA kernel (``csrc/mse.cu``).

Port of ``repro.kernels.mse.mse_sum_pallas``: (N, H, W) planes a and b
to the (N,) f32 sums of (a - b)^2.  A CUDA tensor launches the kernel on
the current stream, a CPU tensor runs the plain ``ref.mse_sum``, any
other device raises; there is no fallback from one to the other.  The
kernel reads uint8 or f32 planes as they are (both of one type) and
needs no (8, 128) padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
SRC_DTYPES = (torch.uint8, torch.float32)
MAX_FRAMES = 65535  # the kernel's grid.y


def _lib():
    lib = _build.load("mse")
    if lib.vss_mse_sum.argtypes is None:
        lib.vss_mse_sum.argtypes = [
            _P, _P, _I, _P, _P, _I, ctypes.c_longlong, _P]
        lib.vss_mse_sum.restype = _I
        lib.vss_mse_partials.argtypes = [_I, ctypes.c_longlong]
        lib.vss_mse_partials.restype = ctypes.c_longlong
    return lib


def mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (N, H, W) -> (N,) f32 sums of squared differences."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be (N,H,W) of one shape, got"
                         f" {tuple(a.shape)} and {tuple(b.shape)}")
    if on_cpu(a):
        _build.count_plain("mse")
        return ref.mse_sum(a, b)
    check_cuda(a, "a", SRC_DTYPES, 3)
    check_cuda(b, "b", (a.dtype,), 3)
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    n, h, w = a.shape
    if n > MAX_FRAMES:
        raise ValueError(f"{n} frames in one call; the kernel takes at most"
                         f" {MAX_FRAMES}")
    out = torch.zeros((n,), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or h * w == 0:
        return out
    lib = _lib()
    partial = torch.empty((lib.vss_mse_partials(n, h * w),),
                          dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_mse_sum(a.data_ptr(), b.data_ptr(), a.element_size(),
                              partial.data_ptr(), out.data_ptr(), n, h * w,
                              stream)
    _build.count_launch("mse")
    _build.check(lib, err, "mse")
    return out
