"""Sharding rules for the (pod, data, model) production mesh.

Port of ``repro.models.sharding`` onto ``torch.distributed``: a
``DeviceMesh`` in place of the JAX mesh and DTensor placements in place
of ``PartitionSpec``s.  The rules are the reference's, path by path:

  * data parallelism over ("pod", "data") — batch dim of activations,
  * FSDP over "data" — the d_model axis of every weight matrix,
  * tensor parallelism over "model" — heads / FFN-hidden / expert axes,
  * expert parallelism — MoE expert axis over "model",
  * sequence parallelism — decode-time KV length over "model".

Every rule is guarded by divisibility: a dim that does not divide by its
mesh axis stays unsharded (``ShardCtx._fit``).  A spec is a tuple with
one entry per tensor dim: None, a mesh axis name, or a tuple of names in
mesh order, which shards that dim over those mesh dims major to minor
(``placements``).

``ShardCtx()`` (no mesh) is the single-device program: ``cs`` and
``const`` return their argument, so the model runs today's ops.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Tuple

import torch

from repro_torch.tree import leaf_paths, tree_map, unflatten


def _dtensor():
    """DTensor's module, imported where a mesh is used (the package
    imports without ``torch.distributed`` being initialised)."""
    import torch.distributed.tensor as dt

    return dt


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "placements")


@dataclasses.dataclass
class ShardCtx:
    """Threads the mesh through model code; no-ops when mesh is None.

    Optimization flags (all False = the reference's baseline):
      bf16_weights — cast f32 master weights to bf16 before use, on the
        sharded representation (``models.model.cast_weights``): a DTensor
        cast is local, so the gathers that follow move bf16.
      constrain_scanned_params — redistribute each group's parameters to
        their rule placements inside the group loop.
      sp_carry — activations between layer groups sharded over "model"
        on the sequence axis.
      remat_policy — "none" (recompute every group in the backward) or
        "save_tp" (keep the outputs the reference tags ``tp_block_out``).
    """

    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh or None
    bf16_weights: bool = False
    constrain_scanned_params: bool = False
    sp_carry: bool = False
    remat_policy: str = "none"

    def __post_init__(self):
        if self.mesh is not None and not _is_mesh(self.mesh):
            raise TypeError(f"mesh must be a DeviceMesh, not"
                            f" {type(self.mesh).__name__}")
        if self.remat_policy not in ("none", "save_tp"):
            raise ValueError(f"unknown remat policy {self.remat_policy!r}")

    @property
    def act_seq(self):
        """Sharding of the sequence axis for boundary activations."""
        return "model" if self.sp_carry else None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    @property
    def dp(self):
        if self.mesh is not None and "pod" in self.axis_names:
            return ("pod", "data")
        return "data"

    def axis_size(self, name: str) -> int:
        if self.mesh is None or name not in self.axis_names:
            return 1
        return int(self.mesh.shape[self.axis_names.index(name)])

    @property
    def dp_size(self) -> int:
        return self.axis_size("pod") * self.axis_size("data")

    def _fit(self, dim: int, s):
        """Drop axes that do not divide the dimension."""
        if s is None:
            return None
        axes = s if isinstance(s, tuple) else (s,)
        total = 1
        for a in axes:
            total *= self.axis_size(a)
        if total <= 1 or dim % total != 0:
            return None
        return s

    def fit(self, shape, spec) -> Tuple:
        """``spec`` padded or cut to ``shape``'s rank, every entry
        fitted."""
        spec = tuple(spec)[: len(shape)]
        spec = spec + (None,) * (len(shape) - len(spec))
        return tuple(self._fit(d, s) for d, s in zip(shape, spec))

    def placements(self, shape, spec) -> Tuple:
        """The DTensor placements of ``spec`` fitted to ``shape`` (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return spec_placements(self.mesh, self.fit(shape, spec))

    def cs(self, x, *spec):
        """The reference's ``with_sharding_constraint``: a DTensor is
        redistributed to ``spec``'s placements, and so is its gradient
        in the backward (as JAX constrains the cotangent) before it goes
        back to ``x``'s own; anything else (no mesh) is returned as it
        is."""
        if self.mesh is None or not is_dtensor(x):
            return x
        want = self.placements(x.shape, spec)
        if not x.requires_grad:
            return x if tuple(x.placements) == want \
                else x.redistribute(self.mesh, want)
        return _Constrain.apply(x, want)

    def const(self, t: torch.Tensor):
        """A tensor the model makes (positions, masks, zeros) on the mesh,
        replicated; itself without a mesh."""
        if self.mesh is None:
            return t
        dt = _dtensor()
        return dt.DTensor.from_local(
            t, self.mesh, [dt.Replicate()] * self.mesh.ndim, run_check=False)

    def local_map(self, fn, xs, in_specs, out_layouts):
        """``fn`` on each device's own block: every DTensor of ``xs`` laid
        out by its spec in ``in_specs``, ``fn`` called on the local
        tensors, and its outputs (a tuple) given back as DTensors with
        the placements in ``out_layouts`` (``placements`` of each
        output's global shape, or with ``Partial`` where the local
        outputs are partial sums).  ``fn(*xs)`` without a mesh.

        Gradients: an input replicated over a mesh dim whose outputs are
        split over it (sharded or partial) gets a partial-sum gradient
        there (each device's block contributes its part), which DTensor
        then reduces; elsewhere the gradient has the input's layout."""
        if self.mesh is None:
            return fn(*xs)
        dt = _dtensor()
        split = [any(not lay[i].is_replicate() for lay in out_layouts)
                 for i in range(self.mesh.ndim)]
        local = []
        for x, sp in zip(xs, in_specs):
            if not is_dtensor(x):
                local.append(x)
                continue
            pl = (self.placements(x.shape, sp) if not _is_placements(sp)
                  else tuple(sp))
            x = x.redistribute(self.mesh, pl)
            grad = [dt.Partial() if p.is_replicate() and split[i] else p
                    for i, p in enumerate(pl)]
            local.append(x.to_local(grad_placements=grad))
        return tuple(dt.DTensor.from_local(o, self.mesh, pl,
                                           run_check=False)
                     for o, pl in zip(fn(*local), out_layouts))

    def contract(self, eq: str, a, b, a_spec, b_spec, op=None):
        """``torch.einsum(eq, a, b)`` (or ``op(a, b)``, the same
        product) with its layout chosen, not propagated: each operand
        laid out by its spec (a letter sharded in one operand is sharded
        alike in the other), the product run on every device's blocks,
        the output sharded where its letters are and a partial sum over
        the axes of sharded contracted letters.  The plain op without a
        mesh."""
        op = op or (lambda x, y: torch.einsum(eq, x, y))
        if self.mesh is None:
            return op(a, b)
        ins, out = eq.split("->")
        la, lb = ins.split(",")
        axis_of = {}
        for letters, t, spec in ((la, a, a_spec), (lb, b, b_spec)):
            for letter, sp in zip(letters, self.fit(t.shape, spec)):
                if sp is not None:
                    axis_of.setdefault(letter, sp)
        dt = _dtensor()
        lay = list(spec_placements(self.mesh,
                                   tuple(axis_of.get(c) for c in out)))
        names = self.axis_names
        for letter, sp in axis_of.items():
            if letter not in out:
                for a_name in (sp if isinstance(sp, tuple) else (sp,)):
                    lay[names.index(a_name)] = dt.Partial()
        return self.local_map(
            lambda x, y: (op(x, y),), (a, b),
            (tuple(axis_of.get(c) for c in la),
             tuple(axis_of.get(c) for c in lb)), [tuple(lay)])[0]

    def mm(self, x, w, x_spec, w_spec):
        """``x @ w`` (x (..., K), w (K, N)) as ``contract`` lays it out:
        ``x_spec`` names x's dims, ``w_spec`` w's two."""
        lead = "abcdefgh"[: x.dim() - 1]
        return self.contract(f"{lead}k,kn->{lead}n", x, w, x_spec, w_spec,
                             op=lambda a, b: a @ b)

    def rowwise(self, fn, x, *params):
        """``fn(x, *params)`` of an op on x's last dim alone (a norm, rope,
        an activation): each device applies it to its own block of x, the
        ``params`` (vectors over that dim, positions) replicated; the
        output is laid out as x (a partial sum reduced first, the last dim
        gathered if it was split).  ``params`` given as (tensor, spec)
        pairs are laid out by their spec instead."""
        if self.mesh is None or not is_dtensor(x):
            return fn(x, *(p[0] if isinstance(p, tuple) else p
                           for p in params))
        dt = _dtensor()
        last = x.dim() - 1
        pl = tuple(dt.Replicate() if p.is_partial() or (
            p.is_shard() and p.dim == last) else p for p in x.placements)
        ts = [p[0] if isinstance(p, tuple) else p for p in params]
        sps = [p[1] if isinstance(p, tuple) else () for p in params]
        return self.local_map(lambda *a: (fn(*a),), (x, *ts), (pl, *sps),
                              [pl])[0]

    def alike(self, fn, *xs):
        """``fn(*xs)`` for tensors of one shape whose op mixes nothing
        across the dims they are split over (a scan along an unsplit
        dim): each device applies ``fn`` to its own blocks, every input
        laid out as the first (a partial sum reduced), the output too."""
        if self.mesh is None or not is_dtensor(xs[0]):
            return fn(*xs)
        dt = _dtensor()
        pl = tuple(dt.Replicate() if p.is_partial() else p
                   for p in xs[0].placements)
        return self.local_map(lambda *a: (fn(*a),), xs, [pl] * len(xs),
                              [pl])[0]

    def spec_of(self, x) -> Tuple:
        """The fitted spec that a DTensor's placements stand for."""
        return placements_spec(self.mesh, x.placements, x.dim())

    def per_shard(self, fn, *xs):
        """``fn`` on each data shard's own rows: ``local_map`` with every
        input and output laid out with dim 0 (the same rows in all of
        them) over the data axes."""
        if self.mesh is None:
            return fn(*xs)
        lay = self.placements(xs[0].shape, (self.dp,))
        return self.local_map(fn, xs, [(self.dp,)] * len(xs), [lay] * 8)

    def coordinate(self, name: str) -> int:
        """This process's index along mesh axis ``name`` (0 without)."""
        if self.mesh is None or name not in self.axis_names:
            return 0
        return int(self.mesh.get_local_rank(name))

    def distribute(self, t: torch.Tensor, spec):
        """A full tensor laid out on the mesh by ``spec`` (fitted to its
        shape); itself without a mesh."""
        if self.mesh is None:
            return t
        return _dtensor().distribute_tensor(
            t, self.mesh, self.placements(t.shape, spec))



class _Constrain(torch.autograd.Function):
    """``ShardCtx.cs`` on a DTensor that needs a gradient."""

    @staticmethod
    def forward(ctx, x, want):
        src = tuple(x.placements)
        ctx.want = want
        # the gradient of a partial sum is the same on every chip
        ctx.back = tuple(_dtensor().Replicate() if p.is_partial() else p
                         for p in src)
        return x.redistribute(x.device_mesh, want) if src != want \
            else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        for pl in (ctx.want, ctx.back):
            if tuple(g.placements) != pl:
                g = g.redistribute(mesh, pl)
        return g, None


def _is_placements(sp) -> bool:
    return bool(sp) and not isinstance(sp[0], (str, tuple, type(None)))


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x.to(dtype)``; a DTensor's cast is made on its local block (the
    values are the same; DTensor's own rule costs a layout search per
    shape)."""
    if not is_dtensor(x) or x.dtype == dtype or any(
            p.is_partial() for p in x.placements):
        return x.to(dtype)
    dt = _dtensor()
    return dt.DTensor.from_local(x.to_local().to(dtype), x.device_mesh,
                                 x.placements, run_check=False,
                                 shape=x.shape, stride=x.stride())


def _is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def spec_placements(mesh, spec: Tuple) -> Tuple:
    """Fitted spec → one placement per mesh dim.  A mesh dim named in the
    spec shards the tensor dim that names it; a tuple of names shards one
    tensor dim over those mesh dims, which must come in mesh order (the
    reference's major-to-minor order, DTensor's order for two ``Shard``
    of one dim); every other mesh dim replicates."""
    dt = _dtensor()
    names = tuple(mesh.mesh_dim_names)
    out = [dt.Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order"
                             f" {names}")
        for i in idx:
            out[i] = dt.Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter shardings by path-name rules
# ---------------------------------------------------------------------------

_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / unembedding: vocab over model (TP), d_model over data (FSDP)
    (r"embed", ("model", "data")),
    (r"lm_head", ("data", "model")),
    (r"patch_proj", ("data", "model")),
    # attention
    (r"wq$", ("data", "model", None)),
    (r"wk$", ("data", "model", None)),
    (r"wv$", ("data", "model", None)),
    (r"wo$", ("model", None, "data")),
    (r"q_norm|k_norm", (None,)),
    # dense mlp
    (r"wi$|wg$", ("data", "model")),
    (r"wd$", ("model", "data")),
    # MoE
    (r"router", ("data", None)),
    (r"we_in$|we_gate$", ("model", "data", None)),  # (E, D, F)
    (r"we_out$", ("model", None, "data")),  # (E, F, D)
    # recurrent blocks: recurrent width over model
    (r"rg_in$|rg_gate$", ("data", "model")),
    (r"rg_out$", ("model", "data")),
    (r"rg_a$|rg_input_gate$|rg_rec_gate$|conv_w$|conv_b$", (None,)),
    (r"lstm_(q|k|v|i|f|o|z)$", ("data", "model")),
    (r"lstm_up$", ("data", "model")),
    (r"lstm_down$", ("model", "data")),
    # norms / biases / scalars: replicated
    (r"norm|scale|bias|gamma|beta", (None,)),
)


def spec_for(path: str, shape: Tuple[int, ...], stacked: bool) -> Tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            out = spec
            break
    else:
        out = (None,) * len(shape)
    if stacked:
        out = (None,) + tuple(out)
    # pad/trim to rank
    out = tuple(out)[: len(shape)]
    out = out + (None,) * (len(shape) - len(out))
    return out


def constrain_group_params(named, ctx: ShardCtx):
    """One group's parameters, given as (name, tensor) pairs with the
    group axis already taken off, each redistributed to its rule
    placements under ``constrain_scanned_params`` (as they are
    otherwise); the tensors, in order."""
    if not ctx.constrain_scanned_params or ctx.mesh is None:
        return [t for _, t in named]
    return [ctx.cs(t, *spec_for(name, tuple(t.shape), False))
            for name, t in named]


def param_specs(params, *, stacked_prefixes=("groups",)):
    """Spec tree matching ``params`` (path-name rules)."""
    return unflatten(params, [
        spec_for(path, tuple(leaf.shape),
                 any(path.startswith(p) for p in stacked_prefixes))
        for path, leaf in leaf_paths(params)])


def param_shardings(params, mesh, **kw):
    """Placements tree matching ``params``: each leaf's spec fitted to its
    shape on ``mesh`` and turned into DTensor placements."""
    ctx = ShardCtx(mesh)
    specs = param_specs(params, **kw)
    return tree_map(lambda leaf, spec: ctx.placements(leaf.shape, spec),
                    params, specs)


def fitted_specs(params, mesh, **kw):
    """The fitted spec tree (the reference's ``NamedSharding.spec``s)."""
    ctx = ShardCtx(mesh)
    specs = param_specs(params, **kw)
    return tree_map(lambda leaf, spec: ctx.fit(leaf.shape, spec),
                    params, specs)


def placements_spec(mesh, placements, ndim: int) -> Tuple:
    """The fitted spec that ``placements`` stand for (inverse of
    ``spec_placements``)."""
    names = tuple(mesh.mesh_dim_names)
    per_dim = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if pl.is_shard():
            per_dim[pl.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def shard_count(mesh, placements) -> int:
    """How many pieces a tensor with ``placements`` is cut into."""
    n = 1
    for size, pl in zip(mesh.shape, placements):
        if pl.is_shard():
            n *= int(size)
    return n

