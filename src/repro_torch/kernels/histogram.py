"""Wrapper for the histogram CUDA kernel (``csrc/histogram.cu``).

Port of ``repro.kernels.histogram.histogram_pallas``: per-(frame,
channel) histograms of (N, C, H, W) values.  A CUDA tensor launches the
kernel on the current stream, a CPU tensor runs the plain
``ref.histogram``, any other device raises; there is no fallback from
one to the other.  The kernel reads uint8 frames as they are stored, or
f32, and needs no (8, 128) padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
SRC_DTYPES = (torch.uint8, torch.float32)
MAX_PLANES = 65535  # the kernel's grid.y


def _lib():
    lib = _build.load("histogram")
    if lib.vss_histogram.argtypes is None:
        lib.vss_histogram.argtypes = [
            _P, _I, _P, _I, ctypes.c_longlong, _I, ctypes.c_float, _P]
        lib.vss_histogram.restype = _I
        lib.vss_histogram_max_bins.argtypes = []
        lib.vss_histogram_max_bins.restype = _I
    return lib


def histogram(
    frames: torch.Tensor,  # (N, C, H, W), f32 or uint8
    *,
    bins: int = 16,
    vmax: float = 255.0,
) -> torch.Tensor:
    """Returns (N, C, bins) int32 per-channel histograms."""
    if frames.dim() != 4:
        raise ValueError(f"frames must be (N,C,H,W), got {tuple(frames.shape)}")
    if bins < 1:
        raise ValueError(f"bins must be positive, got {bins}")
    if on_cpu(frames):
        _build.count_plain("histogram")
        return ref.histogram(frames, bins=bins, vmax=vmax)
    check_cuda(frames, "frames", SRC_DTYPES, 4)
    n, c, h, w = frames.shape
    if n * c > MAX_PLANES:
        raise ValueError(f"{n * c} planes in one histogram; the kernel takes"
                         f" at most {MAX_PLANES}")
    lib = _lib()
    if bins > lib.vss_histogram_max_bins():
        raise ValueError(f"bins={bins} above the kernel's"
                         f" {lib.vss_histogram_max_bins()}")
    out = torch.zeros((n, c, bins), dtype=torch.int32, device=frames.device)
    if frames.numel() == 0:
        return out
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_histogram(
            frames.data_ptr(), frames.element_size(), out.data_ptr(), n * c,
            h * w, bins, ref.histogram_scale(bins, vmax), stream)
    _build.count_launch("histogram")
    _build.check(lib, err, "histogram")
    return out
