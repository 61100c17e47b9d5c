"""Wrapper for the per-frame squared-error CUDA kernel (``csrc/mse.cu``).

Port of ``repro.kernels.mse.mse_sum_pallas``: (N, H, W) planes a and b
to the (N,) f32 sums of (a - b)^2.  A CUDA tensor launches the kernel on
the current stream, a CPU tensor runs the plain ``ref.mse_sum``, any
other device raises; there is no fallback from one to the other.  The
kernel reads contiguous uint8 or f32 planes where they lie (both of one
type, at any offset) and needs no (8, 128) padding.

A call is one kernel and writes every ``out[n]``, so ``out`` is
``torch.empty``: each frame is summed by one cluster of blocks, which
adds its blocks' sums through distributed shared memory.  uint8 planes
are summed exactly in integers and rounded to f32 once, so the result
is the correctly rounded true sum; f32 planes are summed in f32.
``plan`` lays the launch out from shapes, pointers and the SM count
alone (no host sync): the load width from how a and b lie against each
other mod 16, the blocks of a frame's cluster, and the vectors each
block takes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SRC_DTYPES = (torch.uint8, torch.float32)
MAX_FRAMES = 65535  # the kernel's grid.y
THREADS = 512  # csrc/mse.cu kThreads
MAX_CLUSTER = 8  # the portable cluster size, csrc/mse.cu kMaxCluster
# uint8 values a thread's uint32 may sum before it moves to the uint64:
# 65536 * 255**2 < 2**32 (csrc/mse.cu kCapValues)
CAP_VALUES = 65536
# vectors of each width a thread loads from each input in one loop step
# (csrc/mse.cu unroll_of)
UNROLL = {16: 4, 4: 16, 1: 16}
WAVES = 2  # blocks the plan aims at, per SM


class Plan(NamedTuple):
    vec: int  # bytes a load takes: 16, 4 or 1
    unroll: int  # loads of vec bytes per input in one step of a thread
    cluster: int  # blocks a frame, one cluster: 1, 2, 4 or 8
    chunk: int  # vectors each block of a frame takes (the last: fewer)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def plan(n: int, plane: int, esize: int, ptr_a: int, ptr_b: int,
         n_sm: int) -> Plan:
    """The launch for ``n`` planes of ``plane`` values of ``esize`` bytes
    at addresses ``ptr_a`` and ``ptr_b`` on ``n_sm`` SMs.  Loads are 16
    bytes where a and b lie at one offset mod 16, else 4 where mod 4,
    else single bytes; each frame gets the fewest blocks (a power of two
    up to ``MAX_CLUSTER``) that fill the card ``WAVES`` times over, and
    no more than it has steps of vectors.  A pure function of host ints."""
    if ptr_a % esize or ptr_b % esize:
        raise ValueError(f"a at {ptr_a:#x} or b at {ptr_b:#x} is not aligned"
                         f" to its {esize}-byte values")
    rel = (ptr_a - ptr_b) % 16
    vec = 16 if rel == 0 else 4 if rel % 4 == 0 else 1
    nvec = plane * esize // vec
    step = THREADS * UNROLL[vec]
    cluster = min(MAX_CLUSTER, _pow2_at_least(-(-WAVES * n_sm // n)),
                  _pow2_at_least(-(-nvec // step)))
    return Plan(vec, UNROLL[vec], cluster, max(1, -(-nvec // cluster)))


def _lib():
    lib = _build.load("mse")
    if lib.vss_mse_sum.argtypes is None:
        lib.vss_mse_sum.argtypes = [
            _P, _P, _I, _P, _I, _L, _I, _I, _I, _L, _P]
        lib.vss_mse_sum.restype = _I
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
    if n == 0 or h * w == 0:
        return torch.zeros((n,), dtype=torch.float32, device=a.device)
    p = plan(n, h * w, a.element_size(), a.data_ptr(), b.data_ptr(),
             _build.sm_count(a.device.index))
    lib = _lib()
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vss_mse_sum(a.data_ptr(), b.data_ptr(), a.element_size(),
                              out.data_ptr(), n, h * w, p.vec, p.unroll,
                              p.cluster, p.chunk, stream)
    _build.count_launch("mse")
    _build.check(lib, err, "mse")
    return out
