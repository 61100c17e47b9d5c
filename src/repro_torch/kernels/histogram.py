"""Wrapper for the histogram CUDA kernel (``csrc/histogram.cu``).

Port of ``repro.kernels.histogram.histogram_pallas``: per-(frame,
channel) histograms of (N, C, H, W) values.  A CUDA tensor launches the
kernel on the current stream, a CPU tensor runs the plain
``ref.histogram``, any other device raises; there is no fallback from
one to the other.  The kernel reads uint8 frames as they are stored, or
f32, and needs no (8, 128) padding.

A call is one kernel on the device, with no zeroing launch: the
kernel's blocks add their counts into an output that is already zero,
because the previous call's kernel on the same stream zeroed it, and
the kernel zeroes the buffer, sized to its own request, that the next
call will take as its output (``csrc/histogram.cu``).  Two calls zero
their output with a launch of their own: the first on a stream, and
one that needs more room than the previous call there left.  A buffer
is handed on only once its kernel was launched, so a call that raises
leaves no unzeroed output behind; a call under CUDA-graph capture
raises, since each replay would add into the same captured output.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, Tuple

import numpy as np
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
            _P, _I, _P, _P, ctypes.c_longlong, _I, ctypes.c_longlong, _I,
            ctypes.c_float, _I, _P]
        lib.vss_histogram.restype = _I
        lib.vss_histogram_max_bins.argtypes = []
        lib.vss_histogram_max_bins.restype = _I
    return lib


def max_bins() -> int:
    """The most bins the kernel takes (builds and loads it)."""
    return _lib().vss_histogram_max_bins()


@functools.lru_cache(maxsize=None)
def byte_bins(bins: int, vmax: float) -> np.ndarray:
    """The bin of each byte value 0..255, by the kernel's f32 arithmetic:
    ``clip(int32(f32(v) * f32(bins / (vmax + 1))), 0, bins - 1)``."""
    x = np.arange(256, dtype=np.float32) * np.float32(
        ref.histogram_scale(bins, vmax))
    return np.clip(np.trunc(x), 0, bins - 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def byte_shift(bins: int, vmax: float) -> int:
    """The shift s with ``bin(v) == v >> s`` for every byte v, or -1
    where there is none (the kernel then bins by the f32 arithmetic)."""
    want = byte_bins(bins, vmax)
    v = np.arange(256)
    return next((s for s in range(9) if np.array_equal(v >> s, want)), -1)


MIN_BUFFER = 1024  # int32s of the smallest buffer handed on

# (device index, stream handle) -> the int32 buffer, zeroed by the last
# kernel launched on that stream, that the next call takes as its output
_zeroed: Dict[Tuple[int, int], torch.Tensor] = {}
_zeroed_lock = threading.Lock()


def _launch_zeroed(device: torch.device, stream: int, n: int,
                   launch: Callable[[torch.Tensor, torch.Tensor], int]
                   ) -> Tuple[torch.Tensor, int]:
    """Runs ``launch(out, nxt)`` and returns ``(out, its error code)``.

    ``out`` (at least ``n`` int32 zeros) is the buffer the previous
    call's kernel on this (device, stream) zeroed where it is big
    enough, and a new zeroed one otherwise.  ``nxt`` is a new buffer of
    ``max(n, MIN_BUFFER)`` int32s that the launched kernel zeroes; it is
    held for the next call only when ``launch`` returns 0, so a launch
    that raises or fails leaves nothing unzeroed behind.  The lock is
    held through the launch, so kernels run in the order the buffers
    are handed on."""
    key = (device.index, stream)
    with _zeroed_lock:
        out = _zeroed.pop(key, None)
        if out is None or out.numel() < n:
            out = torch.zeros(max(n, MIN_BUFFER), dtype=torch.int32,
                              device=device)
        nxt = torch.empty(max(n, MIN_BUFFER), dtype=torch.int32,
                          device=device)
        err = launch(out, nxt)
        if err == 0:
            _zeroed[key] = nxt
    return out, err


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
    if bins > max_bins():
        raise ValueError(f"bins={bins} above the kernel's {max_bins()}")
    if frames.numel() == 0:
        return torch.zeros((n, c, bins), dtype=torch.int32,
                           device=frames.device)
    scale = ref.histogram_scale(bins, vmax)
    shift = byte_shift(bins, float(vmax)) if frames.dtype == torch.uint8 else -1
    size = n * c * bins
    with torch.cuda.device(frames.device):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("histogram cannot be captured in a CUDA graph:"
                               " each replay would add into one output")
        stream = torch.cuda.current_stream().cuda_stream
        out, err = _launch_zeroed(
            frames.device, stream, size,
            lambda out, nxt: lib.vss_histogram(
                frames.data_ptr(), frames.element_size(), out.data_ptr(),
                nxt.data_ptr(), nxt.numel(), n * c, h * w, bins, scale,
                shift, stream))
    _build.count_launch("histogram")
    _build.check(lib, err, "histogram")
    return out[:size].view(n, c, bins)
