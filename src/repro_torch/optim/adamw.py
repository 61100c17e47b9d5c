"""AdamW with decoupled weight decay, f32 state, global-norm clipping.

Functional over nested dicts of tensors: the state is {"m", "v",
"count"}, m and v f32 in the parameters' layout, count an int32 scalar.
Every update is elementwise and in f32, one PyTorch operation for each
of the reference's (``repro/optim/adamw.py``), each rounding once, in
its order.  A parameter keeps its dtype: an f32 master is updated in
f32, a bf16 one computed in f32 and rounded back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of their f32 squares."""
    total = None
    for g in leaves(tree):
        sq = (g.to(F32) ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled by min(1, max_norm / norm), in their dtypes; norm);
    ``norm`` is ``global_norm(grads)`` unless given (a caller holding
    only blocks of the gradients passes the norm of the whole)."""
    if norm is None:
        norm = global_norm(grads)
    limit = torch.tensor(max_norm, dtype=F32, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, dict]:
    """One AdamW step. Returns (new_params, new_state)."""
    count = state["count"] + 1
    cf = count.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                       device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                       device=cf.device), cf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        gf = g.to(F32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mh = m2 / b1c
        vh = v2 / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * step).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"]))]
    return (unflatten(params, [o[0] for o in out]),
            {"m": unflatten(params, [o[1] for o in out]),
             "v": unflatten(params, [o[2] for o in out]), "count": count})
