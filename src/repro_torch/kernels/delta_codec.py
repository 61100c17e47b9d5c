"""Wrappers for the TVC delta-codec CUDA kernels (``csrc/delta_codec.cu``).

Port of ``repro.kernels.delta_codec`` (``delta_encode_pallas`` and
``delta_decode_pallas``).  The device of the input decides: a CUDA
tensor launches the hand-written kernel on the current stream, a CPU
tensor runs the plain version in ``ref.py``, and any other device
raises.  There is no fallback from one to the other.

Unlike the TPU kernels, these read and write residuals in the tier's
own integer type (int8 / int16), so the codec hands its payload to the
card without a widening copy.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# the residual types of the codec's tiers (tvc-ll int16, the rest int8)
RESID_DTYPES = (torch.int8, torch.int16)

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _lib():
    lib = _build.load("delta_codec")
    if lib.vss_delta_encode.argtypes is None:
        lib.vss_delta_encode.argtypes = [
            _P, _P, _P, _I, ctypes.c_longlong, _I, _F, _F, _F, _F, _F, _F, _P]
        lib.vss_delta_encode.restype = _I
        lib.vss_delta_decode.argtypes = [
            _P, _P, _I, _P, ctypes.c_longlong, _I, _F, _F, _F, _P]
        lib.vss_delta_decode.restype = _I
        lib.vss_quotient_mismatches.argtypes = [_F, _F, _P, _P]
        lib.vss_quotient_mismatches.restype = _I
    return lib


def check_cuda(x: torch.Tensor, what: str, dtypes, ndim: int) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of a kernel dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {dtypes}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous tensor")


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel);
    raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def inv(q: float) -> float:
    """1/q rounded to f32, the multiplier the Pallas kernels use."""
    return float(np.float32(1.0 / q))


def delta_encode(
    frames: torch.Tensor,  # (T, C, H, W) f32
    *,
    q: float,
    lo: int,
    hi: int,
    vmin: float,
    vmax: float,
    resid_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (iframe (C,H,W) f32, residuals (T-1,C,H,W) resid_dtype),
    ``resid_dtype`` being the tier's residual type."""
    if resid_dtype not in RESID_DTYPES:
        raise TypeError(f"residual dtype {resid_dtype} not in {RESID_DTYPES}")
    if on_cpu(frames):
        iframe, resid = ref.delta_encode(
            frames, q=q, lo=lo, hi=hi, vmin=vmin, vmax=vmax)
        return iframe, resid.to(resid_dtype)
    check_cuda(frames, "frames", (torch.float32,), 4)
    t, c, h, w = frames.shape
    if t < 1:
        raise ValueError("delta_encode needs at least one frame")
    iframe = torch.empty((c, h, w), dtype=torch.float32, device=frames.device)
    resid = torch.empty((t - 1, c, h, w), dtype=resid_dtype,
                        device=frames.device)
    n = c * h * w
    if n == 0:
        return iframe, resid
    lib = _lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_delta_encode(
            frames.data_ptr(), iframe.data_ptr(), resid.data_ptr(),
            resid.element_size(), n, t, q, inv(q), lo, hi, vmin, vmax, stream)
    _build.count_launch("delta_encode")
    _build.check(lib, err, "delta_encode")
    return iframe, resid


def delta_decode(
    iframe: torch.Tensor,  # (C, H, W) f32
    residuals: torch.Tensor,  # (T-1, C, H, W) int8 / int16
    *,
    q: float,
    vmin: float,
    vmax: float,
) -> torch.Tensor:
    """Returns frames (T, C, H, W) f32 (recon chain; frame 0 == iframe)."""
    if on_cpu(iframe):
        if residuals.device != iframe.device:
            raise ValueError("iframe and residuals lie on different devices")
        return ref.delta_decode(iframe, residuals, q=q, vmin=vmin, vmax=vmax)
    check_cuda(iframe, "iframe", (torch.float32,), 3)
    check_cuda(residuals, "residuals", RESID_DTYPES, 4)
    if residuals.device != iframe.device:
        raise ValueError("iframe and residuals lie on different devices")
    if tuple(residuals.shape[1:]) != tuple(iframe.shape):
        raise ValueError(
            f"residuals {tuple(residuals.shape)} do not match iframe"
            f" {tuple(iframe.shape)}")
    tm1 = residuals.shape[0]
    out = torch.empty((tm1 + 1, *iframe.shape), dtype=torch.float32,
                      device=iframe.device)
    n = iframe.numel()
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(iframe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_delta_decode(
            iframe.data_ptr(), residuals.data_ptr(), residuals.element_size(),
            out.data_ptr(), n, tm1, q, vmin, vmax, stream)
    _build.count_launch("delta_decode")
    _build.check(lib, err, "delta_decode")
    return out


def quotient_mismatches(q: float, device: torch.device | str = "cuda") -> int:
    """How many finite f32 residuals r the CUDA kernels quantize other
    than the plain versions do: rint of their division-free quotient
    (``csrc/tvc_math.cuh``) against rint(r / q), over all 2^32 bit
    patterns.  A check of the kernels' arithmetic, run on the card; it
    launches no codec kernel and counts no launch."""
    out = torch.zeros(1, dtype=torch.int64, device=device)
    check_cuda(out, "mismatch counter", (torch.int64,), 1)
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_quotient_mismatches(q, inv(q), out.data_ptr(), stream)
    _build.check(lib, err, "quotient check")
    return int(out.item())
