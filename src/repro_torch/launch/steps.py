"""The three step programs: train_step, prefill_step, decode_step.

Port of ``repro.launch.steps``.  ``train_step`` is the reference's full
step: microbatched gradient accumulation in f32, optional int8
error-feedback gradient compression, global-norm clip, cosine LR with
warmup, AdamW.  ``prefill_step``/``decode_step`` fill the decode cache /
serve one token against it.

The train state is the reference's pytree, key for key: {"params",
"opt": {"m", "v", "count"[, "master"]}, "step"[, "ef"]}, parameters in
the reference's layout (groups stacked on a leading axis), f32 masters,
int32 ``count`` and ``step``, and with ``bf16_params`` every f32 leaf of
the live ``params`` in bf16 (the f32 master in ``opt``).  So a checkpoint
(``train.checkpoint.tree_to_frames`` of the state) has the reference's
bytes, and either package restores the other's.

The step runs the model with the live parameters through
``models.model.loss_fn``: an f32 master is cast to bf16 where the
reference casts it (``bind_reference``), so autograd gives f32
gradients for the masters, exactly the reference's; a bf16 live leaf
gets its bf16 gradient.

Each ``make_*`` takes ``ctx``, a ``models.sharding.ShardCtx``.  None (the
default) is the single-device program of today.  With a mesh the state
is laid out by ``launch.specs.distribute_state``, every microbatch is
laid out over the data axes as it is taken, the model runs on DTensors
(``models.model``), and under ``shard_grad_accum`` each microbatch's f32
gradient sum is redistributed to its parameter's placements (the
reference's constraint on its accumulation carry).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardCtx, param_shardings
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_decompress_grads,
    cosine_schedule,
    init_error_feedback,
)
from repro_torch.tree import leaf_paths, leaves, tree_map, unflatten
from repro_torch.utils import div_once

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    adamw: AdamWConfig = AdamWConfig()
    total_steps: int = 10_000
    warmup_steps: int = 100
    num_microbatches: int = 1
    compress_grads: bool = False  # int8 EF on the gradients
    # redistribute the gradient-accumulation carry to the parameters'
    # placements after every microbatch (a no-op without a mesh)
    shard_grad_accum: bool = False
    # live params in bf16, the f32 master inside the optimizer state
    # (AdamW still updates the f32 master)
    bf16_params: bool = False


def _bf16_live(tree):
    """Every f32 leaf rounded to bf16 (the reference's live params)."""
    return tree_map(lambda p: p.to(M.COMPUTE_DTYPE) if p.dtype == F32
                    else p, tree)


def init_train_state(seed: Union[int, torch.Generator], cfg: ArchConfig,
                     hyper: TrainHyper, *, device="cuda") -> Dict:
    """The state of step 0: f32 masters drawn by ``models.model.
    init_model`` from ``seed`` (an int seeds a generator on ``device``),
    zero AdamW moments, step 0.  On ``"meta"`` only the shapes and
    dtypes are made (the reference's ``abstract_train_state``)."""
    dev = M.resolve_device(device)
    gen = seed
    if isinstance(seed, int) and dev.type != "meta":
        gen = torch.Generator(dev).manual_seed(seed)
    model = M.init_model(cfg, device=dev, generator=None if dev.type ==
                         "meta" else gen, dtype=F32)
    params = M.reference_params(model)
    del model
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if hyper.bf16_params:
        state["opt"]["master"] = params
        state["params"] = _bf16_live(params)
    if hyper.compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


def abstract_train_state(cfg: ArchConfig, hyper: TrainHyper) -> Dict:
    """The train state's shapes and dtypes as meta tensors (no
    allocation)."""
    return init_train_state(0, cfg, hyper, device="meta")


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor; a bf16 leaf (numpy's extension dtype
    named ``bfloat16``) through its bits."""
    a = np.array(a, order="C")  # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference_state(state_np: Mapping[str, Any], cfg: ArchConfig,
                         hyper: TrainHyper, device="cuda") -> Dict:
    """The port's train state holding the reference's: ``state_np`` is
    the reference's ``init_train_state`` output (or a later state) as
    numpy arrays.  Keys, shapes and dtypes must be those of the port's
    state for ``cfg`` and ``hyper``."""
    dev = M.resolve_device(device)
    like = init_train_state(0, cfg, hyper, device="meta")
    got = dict(leaf_paths(state_np))
    want = dict(leaf_paths(like))
    if set(got) != set(want):
        raise ValueError(f"reference state has leaves {sorted(got)}, the"
                         f" port expects {sorted(want)}")
    out = []
    for path, t in leaf_paths(like):
        x = _from_numpy(np.asarray(got[path]))
        if tuple(x.shape) != tuple(t.shape) or x.dtype != t.dtype:
            raise ValueError(f"{path}: reference {x.dtype}"
                             f" {tuple(x.shape)}, port {t.dtype}"
                             f" {tuple(t.shape)}")
        out.append(x.to(dev))
    return unflatten(like, out)


def _split_microbatches(batch: Dict, n: int) -> Dict:
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def make_grad_step(cfg: ArchConfig, hyper: TrainHyper,
                   ctx: Optional[ShardCtx] = None):
    """Returns grad_step(params, batch) -> (loss, grads): the train step's
    first half.  The batch holds tokens and labels (B, S) [+ frames |
    patches], tensors or numpy, moved to the parameters' device (and on a
    mesh each microbatch laid out over the data axes).  With microbatches
    the gradients are summed in f32 from zeros and divided by their
    count, as is the loss; else each has its leaf's dtype."""
    skeleton = M.init_model(cfg, device="meta")
    mesh = None if ctx is None else ctx.mesh

    def loss_and_grads(params, mb):
        if mesh is not None:
            mb = {k: ctx.distribute(v, (ctx.dp,)) for k, v in mb.items()}
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss = M.loss_fn(unflatten(params, live), cfg, mb, skeleton=skeleton,
                         ctx=ctx)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return loss.detach(), unflatten(params, grads)

    def grad_step(params, batch):
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        n = hyper.num_microbatches
        if n == 1:
            return loss_and_grads(params, batch)
        micro = _split_microbatches(batch, n)
        if mesh is not None:
            return _accumulate_on_mesh(params, micro, n)
        loss_sum = torch.zeros((), dtype=F32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=dev), params)
        for i in range(n):
            loss, g = loss_and_grads(params,
                                     {k: v[i] for k, v in micro.items()})
            for acc, gi in zip(leaves(grads), leaves(g)):
                acc.add_(gi)  # f32 + f32(g), one rounding
            del g
            loss_sum = loss_sum + loss
        return div_once(loss_sum, n), tree_map(lambda g: div_once(g, n),
                                               grads)

    def _accumulate_on_mesh(params, micro, n):
        """The same sums on DTensors (a new sum each microbatch: a
        DTensor's in-place add keeps its placements only if the
        gradient's match), constrained under ``shard_grad_accum``."""
        place = param_shardings(params, mesh)
        loss_sum = ctx.const(torch.zeros((), dtype=F32,
                                         device=leaves(params)[0].device))
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
        for i in range(n):
            loss, g = loss_and_grads(params,
                                     {k: v[i] for k, v in micro.items()})
            grads = tree_map(lambda acc, gi: acc + gi, grads, g)
            if hyper.shard_grad_accum:
                grads = tree_map(
                    lambda acc, pl: acc if tuple(acc.placements) == pl
                    else acc.redistribute(mesh, pl), grads, place)
            del g
            loss_sum = loss_sum + loss
        return div_once(loss_sum, n), tree_map(lambda g: div_once(g, n),
                                               grads)

    return grad_step


def apply_grads(state: Dict, loss: torch.Tensor, grads,
                hyper: TrainHyper, ctx: Optional[ShardCtx] = None
                ) -> Tuple[Dict, Dict]:
    """The train step's second half: int8 EF compression if
    ``compress_grads``, clip by global norm, the cosine LR, AdamW (on the
    f32 master under ``bf16_params``, the live params rounded from it).
    Returns (a new state, metrics: loss, grad_norm, lr_scale as device
    scalars).  On a mesh every gradient is laid out as its parameter,
    the norm (and the compression's per-tensor scale) taken over the
    DTensors, and the elementwise rest run on each device's blocks
    (``_apply_on_blocks``)."""
    if ctx is not None and ctx.mesh is not None:
        return _apply_on_blocks(state, loss, grads, hyper, ctx.mesh)
    return _apply(state, loss, grads, hyper)


def _apply_on_blocks(state, loss, grads, hyper, mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.optim import global_norm

    place = param_shardings(state["params"], mesh)
    grads = tree_map(lambda g, pl: g if tuple(g.placements) == pl
                     else g.redistribute(mesh, pl), grads, place)
    ef = None
    if hyper.compress_grads:
        grads, ef = compress_decompress_grads(grads, state["ef"])
    norm = global_norm(grads)
    local = tree_map(lambda t: t.to_local(), state)
    if ef is not None:
        local["ef"] = tree_map(lambda t: t.to_local(), ef)
    new, met = _apply(local, loss, tree_map(lambda g: g.to_local(), grads),
                      hyper, norm=norm.to_local(), compressed=True)

    def back(t, like):
        return DTensor.from_local(t, mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    state_like = dict(state, ef=ef) if ef is not None else state
    new = {k: (tree_map(back, new[k], state_like[k]) if k != "ef" or ef is
               None else ef) for k in new}
    met = {"loss": loss, "grad_norm": norm,
           "lr_scale": back(met["lr_scale"], norm)}
    return new, met


def _apply(state, loss, grads, hyper, norm=None, compressed=False):
    new_state = dict(state)
    if hyper.compress_grads and not compressed:
        grads, new_state["ef"] = compress_decompress_grads(grads, state["ef"])
    grads, gnorm = clip_by_global_norm(grads, hyper.adamw.clip_norm, norm)
    lr_scale = cosine_schedule(state["step"], hyper.total_steps,
                               hyper.warmup_steps)
    if hyper.bf16_params:
        opt = dict(state["opt"])
        master = opt.pop("master")
        new_master, new_opt = adamw_update(master, grads, opt, hyper.adamw,
                                           lr_scale)
        new_opt["master"] = new_master
        new_params = _bf16_live(new_master)
    else:
        new_params, new_opt = adamw_update(state["params"], grads,
                                           state["opt"], hyper.adamw,
                                           lr_scale)
    new_state["params"] = new_params
    new_state["opt"] = new_opt
    new_state["step"] = state["step"] + 1
    metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
    return new_state, metrics


def make_train_step(cfg: ArchConfig, hyper: TrainHyper,
                    ctx: Optional[ShardCtx] = None):
    """Returns train_step(state, batch) -> (state, metrics): ``grad_step``
    then ``apply_grads``.  The state is not changed in place."""
    grad_step = make_grad_step(cfg, hyper, ctx)

    def train_step(state, batch):
        loss, grads = grad_step(state["params"], batch)
        return apply_grads(state, loss, grads, hyper, ctx)

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx: Optional[ShardCtx] = None):
    """prefill_step(model, batch, cache) -> (last logits, cache); on a
    mesh the model's parameters, the batch and the cache are DTensors
    (``models.model.model_from_params``, ``launch.specs``)."""

    def prefill_step(model, batch, cache):
        extra = {k: batch[k] for k in M.FRONTEND_INPUTS if k in batch}
        return M.prefill(model, batch["tokens"], cache, ctx=ctx, **extra)

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: Optional[ShardCtx] = None):
    """decode_step(model, cache, tokens) -> (logits, cache)."""

    def decode_step(model, cache, tokens):
        return M.decode_step(model, cache, tokens, ctx=ctx)

    return decode_step
