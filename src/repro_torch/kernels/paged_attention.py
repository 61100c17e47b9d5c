"""Wrapper for the paged decode-attention CUDA kernel
(``csrc/paged_attention.cu``).

Port of ``repro.kernels.paged_attention.paged_decode_attention_pallas``:
one-token GQA attention over KV rows that live in a page pool, walked
through each sequence's block table.  A CUDA tensor launches the kernel
on the current stream, a CPU tensor runs the plain
``ref.paged_decode_attention``, any other device raises; there is no
fallback from one to the other.

The kernel reads the pages where they lie and copies nothing: the
wrapper takes contiguous tensors only (the serving engine passes
``pool.k[layer]``, a contiguous view of its pool), q and the pages of one
dtype, bf16 or f32, and head widths of whole 16-byte vectors (every
configured head is), and raises on anything else rather than copying or
converting it.  A row with no valid position is NaN, as in ``ref.py``.

The kernel is split-KV: each (KV head, sequence) walks its positions in
``n_split`` ranges of ``chunk`` positions on separate blocks, which
write partial softmax states to an f32 workspace that this wrapper
allocates; a second launch folds them in split order.  The split is
planned from shapes alone (``plan_splits``): the wrapper never reads
``seq_lens`` on the host, so a call queues its launches without waiting
on the device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.delta_codec import check_cuda, on_cpu

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = (torch.bfloat16, torch.float32)
MAX_BATCH = 65535  # the kernel's grid.y
MAX_SPLITS = 65535  # the kernel's grid.z
TILE = 32  # positions; every tile of the kernel divides it
WAVES = 8  # blocks the split aims at, per SM, before empty ones return


def plan_splits(b: int, hkv: int, max_len: int, n_sm: int) -> tuple:
    """``(n_split, chunk)`` for ``b`` sequences of ``hkv`` KV heads over at
    most ``max_len`` (``maxp * page``) positions on ``n_sm`` SMs: enough
    splits that the (KV head, sequence, split) blocks fill the card
    ``WAVES`` times over, each a ``chunk`` of whole tiles (a multiple of
    ``TILE``), and ``n_split * chunk >= max_len``.
    A pure function of host-known ints."""
    want = max(1, -(-WAVES * n_sm // (b * hkv)))
    chunk = max(-(-max_len // want), -(-max_len // MAX_SPLITS), 1)
    chunk = -(-chunk // TILE) * TILE
    return max(1, -(-max_len // chunk)), chunk


def _lib():
    lib = _build.load("paged_attention")
    if lib.vss_paged_attention.argtypes is None:
        lib.vss_paged_attention.argtypes = [
            _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _I, _I, _I, ctypes.c_float, _P]
        lib.vss_paged_attention.restype = _I
    return lib


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (P, page, Hkv, D)
    v_pages: torch.Tensor,  # (P, page, Hkv, D)
    block_table: torch.Tensor,  # (B, maxp) int32, -1 = absent
    seq_lens: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Returns (B, Hq, D) in q's dtype, with the scale
    ``ref.decode_scale(D)``."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B,Hq,D) and pages (P,page,Hkv,D), got"
                         f" {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, hq, d = q.shape
    _p, page, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k_pages.shape)} and"
                         f" v {tuple(v_pages.shape)} do not fit (GQA needs"
                         " Hq a multiple of Hkv)")
    if block_table.dim() != 2 or block_table.shape[0] != b or tuple(
            seq_lens.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} and seq_lens"
                         f" {tuple(seq_lens.shape)} do not fit batch {b}")
    if on_cpu(q):
        _build.count_plain("paged_attention")
        return ref.paged_decode_attention(
            q, k_pages, v_pages, block_table, seq_lens)
    check_cuda(q, "q", DTYPES, 3)
    check_cuda(k_pages, "k_pages", (q.dtype,), 4)
    check_cuda(v_pages, "v_pages", (q.dtype,), 4)
    check_cuda(block_table, "block_table", (torch.int32,), 2)
    check_cuda(seq_lens, "seq_lens", (torch.int32,), 1)
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    maxp = block_table.shape[1]
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} above the kernel's {MAX_BATCH}")
    vec = 16 // q.element_size()  # the kernel loads K/V rows as 16 bytes
    if d % vec or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"the kernel reads K/V rows as 16-byte vectors: D={d}"
                         f" must be a multiple of {vec} and the pages"
                         " 16-byte aligned")
    g = hq // hkv
    lib = _lib()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if maxp == 0 or page == 0:
        return out.zero_()  # ref.py's sum over no position at all
    n_split, chunk = plan_splits(b, hkv, maxp * page,
                                 _build.sm_count(q.device.index))
    # per (sequence, query head, split): running max, sum, then D sums
    n = b * hq * n_split
    ws = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    m_ws, l_ws, acc_ws = ws[:n], ws[n:2 * n], ws[2 * n:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # two kernels (split, combine), one launch of this kernel's count
        err = lib.vss_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            q.element_size(), block_table.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), m_ws.data_ptr(), l_ws.data_ptr(),
            acc_ws.data_ptr(), b, hkv, g, d, page, maxp, n_split, chunk,
            ref.decode_scale(d), stream)
    _build.count_launch("paged_attention")
    _build.check(lib, err, "paged_attention")
    return out
