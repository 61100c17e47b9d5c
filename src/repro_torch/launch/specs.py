"""Meta-tensor stand-ins and DTensor placements for every step input.

Port of ``repro.launch.specs``.  ``batch_specs`` builds the batch of a
shape cell and ``cache_specs`` the decode cache as meta tensors (no
allocation); ``*_shardings`` map each tree (parameters, the train state,
a batch, a cache) to DTensor placements on a mesh, one tuple per leaf
(``models.sharding.spec_placements``); ``sharded_bytes`` is the
analytic bytes per device; ``distribute_state`` lays a full state out on
a mesh and ``full_state`` gathers it back.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.sharding import (
    ShardCtx,
    is_dtensor,
    param_shardings,
    shard_count,
)
from repro_torch.tree import tree_map


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": _meta((b, 1), torch.int32)}
    if shape.kind in ("train", "prefill"):
        front = (b, cfg.num_frontend_tokens, cfg.frontend_dim)
        if cfg.family == "audio":
            batch["frames"] = _meta(front, torch.float32)
        if cfg.family == "vlm":
            batch["patches"] = _meta(front, torch.float32)
    return batch


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                kv_int8: bool = False):
    """The port's decode cache of ``cfg`` on the meta device: {"layers":
    one dict per layer, "pos"}."""
    return M.init_cache(M.init_model(cfg, device="meta"), batch, max_len,
                        kv_int8=kv_int8)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def batch_shardings(batch_tree, mesh):
    ctx = ShardCtx(mesh)
    return tree_map(lambda leaf: ctx.placements(leaf.shape, (ctx.dp,)),
                    batch_tree)


_CACHE_RULES = (
    # (name, rank) -> spec builder; dp = ("pod","data") or "data"
    ("pos_abs", 2, lambda dp: (dp, None)),
    ("pos", 1, lambda dp: (dp,)),
    ("kscale", 3, lambda dp: (dp, "model", None)),
    ("vscale", 3, lambda dp: (dp, "model", None)),
    ("k", 4, lambda dp: (dp, "model", None, None)),  # KV len → SP over model
    ("v", 4, lambda dp: (dp, "model", None, None)),
    ("xk", 4, lambda dp: (dp, None, "model", None)),
    ("xv", 4, lambda dp: (dp, None, "model", None)),
    ("conv", 3, lambda dp: (dp, None, "model")),
    ("h", 2, lambda dp: (dp, "model")),
    ("C", 4, lambda dp: (dp, None, None, None)),
    ("n", 3, lambda dp: (dp, None, None)),
    ("m", 2, lambda dp: (dp, None)),
    ("c", 2, lambda dp: (dp, "model")),
)


def cache_spec(name: str, rank: int, dp) -> Tuple:
    """The rule spec of one (unstacked) cache entry."""
    for n, r, f in _CACHE_RULES:
        if name == n and rank == r:
            return f(dp)
    return (dp,) + (None,) * (rank - 1) if rank else ()


def cache_shardings(cache_tree, mesh):
    """Placements of the port's cache ({"layers": [...], "pos"}); each
    layer's entries by the reference's rules for an unstacked layer."""
    ctx = ShardCtx(mesh)

    def one(name, leaf):
        return ctx.placements(leaf.shape,
                              cache_spec(name, leaf.dim(), ctx.dp))

    return {"layers": [{k: one(k, v) for k, v in c.items()}
                       for c in cache_tree["layers"]],
            "pos": one("pos", cache_tree["pos"])}


def state_shardings(state_tree, mesh):
    """Placements of the train state {params, opt{m,v,count[,master]},
    ef?, step}."""
    p_sh = param_shardings(state_tree["params"], mesh)
    scalar = ShardCtx(mesh).placements((), ())
    out = {"params": p_sh, "step": scalar,
           "opt": {"m": p_sh, "v": p_sh, "count": scalar}}
    if "master" in state_tree["opt"]:
        out["opt"]["master"] = p_sh
    if "ef" in state_tree:
        out["ef"] = p_sh
    return out


# ---------------------------------------------------------------------------
# analytic per-device bytes, layout and gathering
# ---------------------------------------------------------------------------

def _flat(tree):
    """Leaves in order, through dicts and lists (a cache holds a list)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _flat(x)
    else:
        yield tree


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, list):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def sharded_bytes(tree, shardings, mesh) -> int:
    """Σ leaf bytes / (product of mesh-dim sizes its placements shard)."""
    total = 0
    for leaf, pl in zip(_flat(tree), _flat(shardings)):
        n = leaf.numel() * leaf.element_size()
        total += n // shard_count(mesh, pl)
    return total


def distribute(tree, shardings, mesh):
    """Each full tensor of ``tree`` laid out by its placements.  A tensor
    must be on the mesh's device (or on "meta", which stays shape-only):
    one elsewhere raises rather than be copied there."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        if t.device.type not in (mesh.device_type, "meta"):
            raise ValueError(f"a tensor on {t.device.type!r} given to a mesh"
                             f" on {mesh.device_type!r}")
        return distribute_tensor(t, mesh, pl)

    return _map(one, tree, shardings)


def distribute_state(state, mesh):
    """A full train state laid out per ``state_shardings``."""
    return distribute(state, state_shardings(state, mesh), mesh)


def full_state(state):
    """The inverse of ``distribute_state``: every DTensor gathered to its
    full value (``full_tensor``); plain tensors as they are."""
    return _map(lambda t: t.full_tensor() if is_dtensor(t) else t, state)
