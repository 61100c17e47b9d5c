"""Int8 error-feedback gradient compression.

Each gradient plus its carried error is quantised to int8 by its
absolute maximum and dequantised; the difference is the new error, so
the quantisation is unbiased over time.  The reference applies it to
the gradients before the optimiser, where its sharded step crosses pods;
on one device it is the same value transform.  ``torch.round`` rounds
half to even, as ``jnp.round``, so q, the dequantised gradient and the
error are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten
from repro_torch.utils import div_once

F32 = torch.float32


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = div_once(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress_grads(grads, error):
    """Quantize grads+error to int8 and back; returns (grads', error')."""

    def one(g, e):
        gf = g.to(F32) + e
        q, scale = _q8(gf)
        deq = q.to(F32) * scale
        return deq.to(g.dtype), gf - deq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
