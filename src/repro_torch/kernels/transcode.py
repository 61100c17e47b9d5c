"""Wrapper for the fused transcode CUDA kernel (``csrc/transcode.cu``).

Port of ``repro.kernels.transcode.transcode_pallas``: decode(q_in) →
f×f box mean → encode(q_out) in one pass, without writing the
full-rate frames to device memory.  A CUDA tensor launches the kernel,
a CPU tensor runs the plain ``ref.transcode``, any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import RESID_DTYPES, check_cuda, inv, on_cpu

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _lib():
    lib = _build.load("transcode")
    if lib.vss_transcode.argtypes is None:
        lib.vss_transcode.argtypes = [
            _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _F, _F, _F, _F, _F, _F, _F, _F, _P]
        lib.vss_transcode.restype = _I
        lib.vss_transcode_max_unrolled.argtypes = []
        lib.vss_transcode_max_unrolled.restype = _I
    return lib


def transcode(
    iframe: torch.Tensor,  # (C, H, W) f32
    residuals: torch.Tensor,  # (T-1, C, H, W) int8 / int16
    *,
    q_in: float,
    q_out: float,
    factor: int,
    lo: int,
    hi: int,
    vmin: float,
    vmax: float,
    resid_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (iframe_out (C,H/f,W/f) f32, residuals_out
    (T-1,C,H/f,W/f) resid_dtype), ``resid_dtype`` being the output tier's
    residual type.  ``factor`` must divide H and W; any such factor
    works."""
    if resid_dtype not in RESID_DTYPES:
        raise TypeError(f"residual dtype {resid_dtype} not in {RESID_DTYPES}")
    c, h, w = iframe.shape
    if factor < 1 or h % factor or w % factor:
        raise ValueError(f"factor {factor} must divide ({h},{w})")
    if on_cpu(iframe):
        if residuals.device != iframe.device:
            raise ValueError("iframe and residuals lie on different devices")
        _build.count_plain("transcode")
        io, ro = ref.transcode(
            iframe, residuals, q_in=q_in, q_out=q_out, factor=factor,
            lo=lo, hi=hi, vmin=vmin, vmax=vmax)
        return io, ro.to(resid_dtype)
    check_cuda(iframe, "iframe", (torch.float32,), 3)
    check_cuda(residuals, "residuals", RESID_DTYPES, 4)
    if residuals.device != iframe.device:
        raise ValueError("iframe and residuals lie on different devices")
    if tuple(residuals.shape[1:]) != (c, h, w):
        raise ValueError(
            f"residuals {tuple(residuals.shape)} do not match iframe"
            f" {(c, h, w)}")
    lib = _lib()
    tm1 = residuals.shape[0]
    oh, ow = h // factor, w // factor
    io = torch.empty((c, oh, ow), dtype=torch.float32, device=iframe.device)
    ro = torch.empty((tm1, c, oh, ow), dtype=resid_dtype, device=iframe.device)
    if io.numel() == 0:
        return io, ro
    # past the unrolled factors the f*f input recon states would spill out
    # of registers; the kernel keeps them in this plane instead
    state = (torch.empty_like(iframe)
             if factor > lib.vss_transcode_max_unrolled() else None)
    with torch.cuda.device(iframe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_transcode(
            iframe.data_ptr(), residuals.data_ptr(), residuals.element_size(),
            None if state is None else state.data_ptr(),
            io.data_ptr(), ro.data_ptr(), ro.element_size(),
            c, oh, ow, tm1, factor, inv(factor * factor), q_in, q_out,
            inv(q_out), lo, hi, vmin, vmax, stream)
    _build.count_launch("transcode")
    _build.check(lib, err, "transcode")
    return io, ro
