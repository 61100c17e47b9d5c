"""The causal LM of the ten assigned architectures, in PyTorch.

Port of ``repro.models.model``: one ``CausalLM`` covering every family
through ``ArchConfig.pattern``, whose layer types are

  attn    global self-attention + (gated) MLP            (dense archs)
  local   windowed self-attention + MLP                  (recurrentgemma)
  moe     global self-attention + MoE FFN                (deepseek, llama4)
  rglru   RG-LRU temporal mix + MLP                      (recurrentgemma)
  mlstm   xLSTM matrix-memory block (self-contained)     (xlstm)
  slstm   xLSTM scalar-memory block (self-contained)     (xlstm)
  xattn   gated cross-attention to image tokens + MLP    (llama-3.2-vision)
  dec     causal self-attn + cross-attn to audio + MLP   (whisper decoder)
  enc     bidirectional self-attn + MLP                  (whisper encoder)
  dense0  layer-0 dense override in an MoE stack         (deepseek)

The reference stacks its layers into groups and runs them with
``lax.scan``; here the model holds one ``Layer`` per layer (head, the
groups' layers in order, tail) and Python loops over them.  Three entry
points, as in the reference:

  ``forward``      parallel pass → (logits (B, S, V) bf16, MoE aux)
  ``prefill``      parallel pass that also fills the decode cache
  ``decode_step``  one token against the cache (dense KV, ring, states)

``forward`` and ``prefill`` run without autograd; ``parallel`` is the
same parallel pass with it, and ``loss_fn`` the training loss over it.

The audio and vision families take their frontend inputs (``frames``,
``patches``) by keyword.  Weights live in bf16; norm scales, the
cross-attention gates, ``rg_a`` and the sLSTM's recurrent weights in f32,
the numbers of the reference's f32 masters as it uses them (a trainer's
f32 masters are drawn with ``init_model(..., dtype=torch.float32)``).
``from_reference_params`` carries the reference's parameter dict across;
``reference_shapes`` gives the reference's key layout of a port model,
``reference_params`` its parameters in that layout, and
``bind_reference`` runs a model with the values of such a tree.
The decode cache is updated in place (the reference returns a new one):
a dense cache at full width is large.

Every entry point takes ``ctx``, a ``models.sharding.ShardCtx``.  With
None (the default) it runs today's single-device ops.  With a ctx whose
mesh is set, the parameters, batch and cache are DTensors on that mesh
(``launch.specs``): the reference's sharding constraints are placed
where it places them, each layer group is recomputed in the backward
(``torch.utils.checkpoint``; the reference remats its group scan), a
cache is updated by whole-tensor ops instead of in place, and the
parameters may be cast to bf16 first (``cast_weights``).  A ctx without
a mesh runs plain tensors with the recompute, which gives the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import resolve_device
from repro_torch.models import recurrent as R
from repro_torch.models.sharding import (
    ShardCtx,
    constrain_group_params,
    is_dtensor,
)
from repro_torch.models.sharding import cast as to_dtype
from repro_torch.tree import leaf_paths, tree_map, unflatten
from repro_torch.utils import div_once

COMPUTE_DTYPE = torch.bfloat16
MAX_DECODER_POS = 32_768  # learned-pos archs (whisper) decode up to here
# layer types that open with self-attention, and those of them whose
# decode state is a dense K/V of max_len positions
SELF_ATTN_TYPES = ("attn", "local", "moe", "enc", "dense0", "dec")
KV_TYPES = ("attn", "moe", "dense0", "dec")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    head: Tuple[str, ...]  # leading layers outside the groups (dense0)
    pattern: Tuple[str, ...]  # the repeated group pattern
    n_groups: int
    tail: Tuple[str, ...]  # remainder layers after the groups


def layer_plan(cfg: ArchConfig) -> LayerPlan:
    head: Tuple[str, ...] = ()
    n = cfg.num_layers
    if cfg.first_dense_ff:
        head = ("dense0",)
        n -= 1
    p = len(cfg.pattern)
    n_groups = n // p
    tail = tuple(cfg.pattern[: n - n_groups * p])
    return LayerPlan(head, tuple(cfg.pattern), n_groups, tail)


def layer_types(plan: LayerPlan) -> List[str]:
    """Every layer's type in order: head, the groups, tail."""
    return [*plan.head, *(plan.pattern * plan.n_groups), *plan.tail]


def _attn_cfg(cfg: ArchConfig, *, window=None, causal=True, use_rope=None):
    return L.AttnCfg(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.hd,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        window=window,
        causal=causal,
        use_rope=cfg.use_rope if use_rope is None else use_rope,
        norm_type=cfg.norm_type,
    )


def _moe_cfg(cfg: ArchConfig) -> L.MoECfg:
    m = cfg.moe
    return L.MoECfg(num_experts=m.num_experts, top_k=m.top_k,
                    d_expert=m.d_expert, num_shared=m.num_shared,
                    capacity_factor=m.capacity_factor)


def _mlstm_cfg(cfg: ArchConfig) -> R.MLstmCfg:
    return R.MLstmCfg(d_model=cfg.d_model, num_heads=cfg.mlstm_heads)


def _slstm_cfg(cfg: ArchConfig) -> R.SLstmCfg:
    return R.SLstmCfg(d_model=cfg.d_model, num_heads=cfg.mlstm_heads)


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------

def _normal(shape, std, *, generator, device,
            dtype=COMPUTE_DTYPE) -> torch.nn.Parameter:
    """N(0, std²) drawn in f32 and rounded to ``dtype`` (shape only on
    meta)."""
    if torch.device(device).type == "meta":
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t = (t.normal_(generator=generator) * std).to(dtype)
    return torch.nn.Parameter(t, requires_grad=False)


def _gate(device) -> torch.nn.Parameter:
    """A cross-attention gate: an f32 scalar, zero at init."""
    return torch.nn.Parameter(torch.zeros((), dtype=torch.float32,
                                          device=device), requires_grad=False)


class Layer(torch.nn.Module):
    """One layer of type ``typ``; its submodules and parameters carry the
    names of the reference's keys (``ln1``, ``attn``, ``ln2``, ``mlp``,
    ``moe``, ``rec``, ``lstm``, ``lnx``, ``xattn``, ``xgate``,
    ``mgate``)."""

    def __init__(self, typ: str, cfg: ArchConfig, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.typ = typ
        d, nt = cfg.d_model, cfg.norm_type
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = L.Norm(d, nt, device=device)
        if typ in SELF_ATTN_TYPES:
            self.attn = L.Attention(_attn_cfg(cfg), **kw)
        elif typ == "rglru":
            self.rec = R.RGLRU(d, cfg.rnn_width or d, **kw)
        elif typ == "mlstm":
            self.lstm = R.MLstm(_mlstm_cfg(cfg), **kw)
        elif typ == "slstm":
            self.lstm = R.SLstm(_slstm_cfg(cfg), **kw)
        elif typ == "xattn":
            self.xattn = L.Attention(_attn_cfg(cfg, use_rope=False), **kw)
            self.xgate = _gate(device)
            self.mgate = _gate(device)
        else:
            raise ValueError(f"unknown layer type {typ!r}")
        if typ == "dec":
            self.lnx = L.Norm(d, nt, device=device)
            self.xattn = L.Attention(_attn_cfg(cfg, use_rope=False), **kw)
        if typ in ("mlstm", "slstm"):
            return  # self-contained blocks: no second norm, no MLP
        self.ln2 = L.Norm(d, nt, device=device)
        if typ == "moe":
            self.moe = L.MoE(d, _moe_cfg(cfg), **kw)
        else:
            ff = cfg.first_dense_ff if typ == "dense0" else cfg.d_ff
            self.mlp = L.MLP(d, ff, cfg.gated_mlp, **kw)


class Encoder(torch.nn.Module):
    """The whisper encoder: ``enc`` layers over the projected frames, its
    own learned ``pos_embed`` (T_frames, D) and final ``norm``."""

    def __init__(self, cfg: ArchConfig, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.layers = torch.nn.ModuleList(
            Layer("enc", cfg, **kw) for _ in range(cfg.encoder_layers))
        self.pos_embed = _normal((cfg.num_frontend_tokens, cfg.d_model),
                                 0.02, **kw)
        self.norm = L.Norm(cfg.d_model, cfg.norm_type, device=device)


class CausalLM(torch.nn.Module):
    """embed (V, D) bf16; for the audio family a learned ``pos_embed``
    (MAX_DECODER_POS, D) and an ``encoder``; for a frontend
    ``frontend_proj`` (frontend_dim, D); one ``Layer`` per layer; final
    norm and, unless tied, lm_head (D, V) bf16.  With ``dtype`` f32 the
    bf16 tensors are f32 instead: a trainer's unrounded masters.

    Calling the module runs the parallel pass with autograd on (a
    trainer's); ``forward`` below runs it without."""

    def __init__(self, cfg: ArchConfig, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = _normal((cfg.vocab_size, cfg.d_model), 0.02, **kw)
        self.pos_embed: Optional[torch.nn.Parameter] = None
        if not cfg.use_rope and cfg.family == "audio":
            self.pos_embed = _normal((MAX_DECODER_POS, cfg.d_model), 0.02,
                                     **kw)
        self.frontend_proj: Optional[torch.nn.Parameter] = None
        if cfg.frontend is not None:
            self.frontend_proj = L.weight(
                (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim, **kw)
        self.encoder: Optional[Encoder] = None
        if cfg.encoder_layers:
            self.encoder = Encoder(cfg, **kw)
        self.layers = torch.nn.ModuleList(
            Layer(typ, cfg, **kw) for typ in layer_types(self.plan))
        self.final_norm = L.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.lm_head: Optional[torch.nn.Parameter] = None
        if not cfg.tie_embeddings:
            self.lm_head = L.weight((cfg.d_model, cfg.vocab_size),
                                    cfg.d_model, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, *, frames=None, patches=None,
                ctx: Optional[ShardCtx] = None):
        return parallel(self, tokens, frames=frames, patches=patches,
                        ctx=ctx)


def init_model(cfg: ArchConfig, *, device="cuda",
               generator: Optional[torch.Generator] = None,
               dtype=COMPUTE_DTYPE) -> CausalLM:
    """Random weights drawn on ``device`` from ``generator`` (a fresh one
    seeded 0 when None), in the reference's distribution: embed and the
    learned positions N(0, 0.02²), projections N(0, 1/fan_in), norm
    scales, gates, conv biases and sLSTM recurrent weights 0, ``rg_a``
    log(expm1(U(0.3, 0.8))).  Each draw is made in f32 and rounded to
    ``dtype`` (bf16: the weights as the reference uses them; f32: its
    masters, from which the bf16 model rounds).  On ``"meta"`` only the
    shapes are made."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        return CausalLM(cfg, generator=generator, device=dev, dtype=dtype)


def init_model_abstract(cfg: ArchConfig) -> Dict[str, Any]:
    """Shape-only init (no allocation): the reference's parameter tree of
    f32 masters as meta tensors."""
    return reference_params(init_model(cfg, device="meta",
                                       dtype=torch.float32))


# ---------------------------------------------------------------------------
# the reference's parameter layout
# ---------------------------------------------------------------------------

def _layer_key(plan: LayerPlan, li: int) -> Tuple[str, Optional[int]]:
    """(key in the reference's params, index in its stacked axis)."""
    if li < len(plan.head):
        return f"head_{li}_{plan.head[li]}", None
    li -= len(plan.head)
    n_body = plan.n_groups * len(plan.pattern)
    if li < n_body:
        g, i = divmod(li, len(plan.pattern))
        return f"{i}_{plan.pattern[i]}", g
    i = li - n_body
    return f"tail_{i}_{plan.tail[i]}", None


def _module_tree(m: torch.nn.Module) -> Dict[str, Any]:
    """A module's parameters and submodules as the reference's nested
    dict (the attribute names are the reference's keys)."""
    out: Dict[str, Any] = {k: v for k, v in m._parameters.items()
                           if v is not None}
    out.update({k: _module_tree(c) for k, c in m._modules.items()})
    return out


def _stacked(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Layer trees of one group key → one tree with lists for leaves (the
    reference's stacked leading axis)."""
    return tree_map(lambda *ts: list(ts), *trees)


def _reference_tree(model: CausalLM) -> Dict[str, Any]:
    """The reference's parameter tree of ``model``, with the port's
    tensors for leaves (a list of them where the reference stacks)."""
    tree: Dict[str, Any] = {"embed": model.embed}
    if model.pos_embed is not None:
        tree["pos_embed"] = model.pos_embed
    if model.frontend_proj is not None:
        tree["frontend_proj"] = model.frontend_proj
    if model.encoder is not None:
        enc = model.encoder
        tree["encoder"] = {
            "groups": {"0_enc": _stacked([_module_tree(x)
                                          for x in enc.layers])},
            "pos_embed": enc.pos_embed,
            "norm": _module_tree(enc.norm),
        }
    groups: Dict[str, List] = {}
    for li, layer in enumerate(model.layers):
        key, g = _layer_key(model.plan, li)
        if g is None:
            tree[key] = _module_tree(layer)
        else:
            groups.setdefault(key, []).append(_module_tree(layer))
    if groups:
        tree["groups"] = {k: _stacked(v) for k, v in groups.items()}
    tree["final_norm"] = _module_tree(model.final_norm)
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    return tree


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, list):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def reference_shapes(model: CausalLM) -> Dict[str, Any]:
    """The reference's parameter layout of ``model``: the same nested
    keys, with each leaf's shape (groups stacked on a leading axis)."""
    return tree_map(_shape, _reference_tree(model))


def reference_params(model: CausalLM) -> Dict[str, Any]:
    """The reference's parameter tree of ``model`` as new tensors of the
    parameters' dtypes (groups stacked on a leading axis)."""
    return tree_map(lambda leaf: torch.stack([t.detach() for t in leaf])
                    if isinstance(leaf, list) else leaf.detach().clone(),
                    _reference_tree(model))


def _reference_names(model: CausalLM) -> Dict[str, Any]:
    """The reference's parameter tree with the names of ``model``'s
    parameters for leaves (a list of them where the reference stacks)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return tree_map(lambda leaf: [names[id(t)] for t in leaf]
                    if isinstance(leaf, list) else names[id(leaf)],
                    _reference_tree(model))


def bind_reference(model: CausalLM, params: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """{name of a parameter of ``model``: its value} from ``params``, a
    tree of tensors in the reference's layout, for
    ``torch.func.functional_call``.  A stacked leaf is split along its
    group axis by one ``unbind`` (whose gradient is one stack); an f32
    leaf is cast to the parameter's dtype, as the reference casts its
    masters at use (bf16 weights, f32 norm scales and gates); a bf16 leaf
    (a trainer's bf16 live parameters) is used as it is.  Autograd
    reaches the leaves of ``params`` through the casts."""
    names = _reference_names(model)
    _same_keys(params, names)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}

    def cast(name, value):
        return to_dtype(value, dtypes[name]) if value.dtype == \
            torch.float32 else value

    out: Dict[str, torch.Tensor] = {}
    for (path, name), (_p, value) in zip(leaf_paths(names),
                                          leaf_paths(params)):
        if isinstance(name, list):
            if value.shape[0] != len(name):
                raise ValueError(f"{path}: {value.shape[0]} stacked layers,"
                                 f" the model has {len(name)}")
            out.update((n, cast(n, v)) for n, v in zip(name,
                                                       _unstack(value)))
        else:
            out[name] = cast(name, value)
    return out


def _unstack(value: torch.Tensor):
    """A stacked leaf split along its group axis; a DTensor sharded on
    that axis (the reference's rules shard the encoder's stacked leaves
    as unstacked ones) is gathered along it first."""
    if is_dtensor(value) and any(pl.is_shard(0) for pl in value.placements):
        from torch.distributed.tensor import Replicate

        value = value.redistribute(value.device_mesh, [
            Replicate() if pl.is_shard(0) else pl for pl in value.placements])
    return value.unbind(0)


def model_from_params(cfg: ArchConfig, params: Mapping[str, Any]
                      ) -> CausalLM:
    """A ``CausalLM`` of ``cfg`` whose parameters are ``params`` (the
    reference's tree, e.g. DTensors laid out by ``launch.specs``), cast
    and unstacked by ``bind_reference``; no copy.  For ``prefill`` and
    ``decode_step`` on a mesh."""
    model = init_model(cfg, device="meta")
    for name, value in bind_reference(model, params).items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[attr] = value.detach()
    return model


def cast_weights(params: Mapping[str, Any], ctx: Optional[ShardCtx]):
    """Under ``ctx.bf16_weights``, every f32 leaf but the norms, scales,
    biases, gates and ``rg_a`` cast to bf16 (the reference's rule), on
    the sharded representation: a DTensor's cast is local, so the gathers
    that follow move bf16.  Otherwise ``params`` as they are."""
    if ctx is None or not ctx.bf16_weights:
        return params

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if leaf.dtype != torch.float32 or "norm" in name or name in (
                "scale", "bias", "xgate", "mgate", "rg_a"):
            return leaf
        return to_dtype(leaf, COMPUTE_DTYPE)

    return unflatten(params, [one(p, v) for p, v in leaf_paths(params)])


def _same_keys(ref, port, path=()) -> None:
    if isinstance(port, Mapping):
        if not isinstance(ref, Mapping) or set(ref) != set(port):
            got = sorted(ref) if isinstance(ref, Mapping) else type(ref)
            raise ValueError(
                f"reference params have keys {got} at"
                f" {'/'.join(path) or 'the root'}, the port expects"
                f" {sorted(port)}")
        for k in port:
            _same_keys(ref[k], port[k], path + (k,))


def from_reference_params(params_np: Mapping[str, Any], cfg: ArchConfig,
                          device="cuda") -> CausalLM:
    """A port model holding the reference's weights: ``params_np`` is the
    reference's nested dict of (numpy) arrays, stacked groups unstacked
    along their leading axis.  Each value is rounded to its parameter's
    dtype: bf16 as the reference casts at use, f32 where it uses the
    master uncast."""
    dev = resolve_device(device)
    model = init_model(cfg, device="meta").to_empty(device=dev)
    tree = _reference_tree(model)
    _same_keys(params_np, tree)

    def load(path, leaf, ref):
        a = np.asarray(ref, dtype=np.float32)
        if a.shape != _shape(leaf):
            raise ValueError(f"{path}: reference shape {a.shape}, port"
                             f" {_shape(leaf)}")
        for t, x in (zip(leaf, a) if isinstance(leaf, list)
                     else ((leaf, a),)):
            t.copy_(torch.from_numpy(np.array(x, dtype=np.float32)))

    def walk(t, r, path=""):
        if isinstance(t, Mapping):
            for k in t:
                walk(t[k], r[k], f"{path}/{k}" if path else k)
        else:
            load(path, t, r)

    with torch.no_grad():
        walk(tree, params_np)
    return model


# ---------------------------------------------------------------------------
# parallel (forward / prefill) pass
# ---------------------------------------------------------------------------

def _embed_tokens(model: CausalLM, tokens: torch.Tensor,
                  ctx: ShardCtx = L.NO_MESH) -> torch.Tensor:
    tokens = tokens.to(device=model.device, dtype=torch.long)
    if ctx.mesh is None:
        return model.embed[tokens]
    # vocab-parallel lookup: each device looks up the rows of its vocab
    # shard (the table gathered over "data") and the shards' rows are
    # summed (a partial sum over "model")
    v = model.embed.shape[0]
    v_ax = ctx.fit((v,), ("model",))[0]
    first = ctx.coordinate("model") * (v // ctx.axis_size("model")) \
        if v_ax else 0

    def look(table, ids):
        if v_ax is None:
            return (table[ids],)
        ids = ids - first
        inside = (ids >= 0) & (ids < table.shape[0])
        rows = table[torch.clamp(ids, 0, table.shape[0] - 1)]
        return (rows * inside[..., None].to(rows.dtype),)

    lay = list(ctx.placements(tuple(tokens.shape) + (model.embed.shape[1],),
                              (ctx.dp,)))
    if v_ax is not None:
        from torch.distributed.tensor import Partial

        lay[ctx.axis_names.index(v_ax)] = Partial()
    x, = ctx.local_map(look, (model.embed, tokens), ((v_ax, None),
                                                      (ctx.dp,)),
                       [tuple(lay)])
    return ctx.cs(x, ctx.dp, None, None)


def unembed(model: CausalLM, x: torch.Tensor,
            ctx: ShardCtx = L.NO_MESH) -> torch.Tensor:
    x = L.apply_norm(model.final_norm, x, ctx)
    w = (model.embed.to(x.dtype).T if model.cfg.tie_embeddings
         else model.lm_head.to(x.dtype))
    logits = ctx.mm(x, w, (ctx.dp, None, None), (None, "model"))
    return ctx.cs(logits, ctx.dp, None, "model")


def _frontend(model: CausalLM, x: torch.Tensor,
              ctx: ShardCtx = L.NO_MESH) -> torch.Tensor:
    x = x.to(device=model.device, dtype=COMPUTE_DTYPE)
    return ctx.mm(x, model.frontend_proj.to(COMPUTE_DTYPE),
                  (ctx.dp, None, None), (None, None))


def _encode_audio(model: CausalLM, frames: torch.Tensor,
                  ctx: ShardCtx = L.NO_MESH, remat: bool = False
                  ) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, T, frontend_dim);
    with ``remat`` each layer is recomputed in the backward."""
    enc = model.encoder
    x = _frontend(model, frames, ctx)
    t = x.shape[1]
    x = x + enc.pos_embed[:t].to(x.dtype)[None]
    x = ctx.cs(x, ctx.dp, None, None)
    positions = ctx.const(torch.arange(t, device=x.device))
    for layer in enc.layers:
        x, _ = _run_group([layer], x, 0.0, model.cfg, positions, None, ctx,
                          remat, ctx.dp, None)
    return L.apply_norm(enc.norm, x, ctx)


def _memory_for(model: CausalLM, frames, patches,
                ctx: ShardCtx = L.NO_MESH, remat: bool = False):
    """Cross-attention memory from the (stubbed) modality frontend."""
    family = model.cfg.family
    need = {"audio": ("frames", frames), "vlm": ("patches", patches)}
    if family in need:
        name, value = need[family]
        if value is None:
            raise ValueError(f"the {family} family needs {name!r}")
        if family == "audio":
            return _encode_audio(model, value, ctx, remat)
        return ctx.cs(_frontend(model, value, ctx), ctx.dp, None, None)
    return None


def _cross_kv(p: L.Attention, memory: torch.Tensor,
              ctx: ShardCtx = L.NO_MESH):
    kv_ax = L.heads_of(ctx, p.wq.shape[1], p.wk.shape[1])[1]
    k = L.head_proj(memory, p.wk, ctx, kv_ax)
    v = L.head_proj(memory, p.wv, ctx, kv_ax)
    return (ctx.cs(k, ctx.dp, None, "model", None),
            ctx.cs(v, ctx.dp, None, "model", None))


def _cross_attention(p: L.Attention, x, memory, cfg: ArchConfig,
                     ctx: ShardCtx = L.NO_MESH):
    """Cross-attention: queries from x, keys/values from memory."""
    q_ax = L.heads_of(ctx, p.wq.shape[1], p.wk.shape[1])[0]
    q = ctx.cs(L.head_proj(x, p.wq, ctx, q_ax), ctx.dp, None, "model", None)
    k, v = _cross_kv(p, memory.to(x.dtype), ctx)
    if cfg.qk_norm:
        q = ctx.rowwise(L.rmsnorm, q, p.q_norm)
        k = ctx.rowwise(L.rmsnorm, k, p.k_norm)
    return L.attn_out(p, L.attention(q, k, v, causal=False, ctx=ctx), ctx)


def _quantize_kv(x: torch.Tensor):
    """(…, Hkv, hd) → (int8 values, (…, Hkv) bf16 scales); rounds half to
    even, as the reference's ``jnp.round``."""
    xf = x.to(torch.float32)
    s = torch.clamp(xf.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(COMPUTE_DTYPE)


def _fill_kv(c: Dict, typ: str, k, v, ctx: ShardCtx = L.NO_MESH) -> None:
    """Write a prefill's K/V (B, S, Hkv, hd) into one layer's cache (on a
    mesh: a new tensor for each entry, ``_fill_kv_mesh``)."""
    if ctx.mesh is not None:
        return _fill_kv_mesh(c, typ, k, v, ctx)
    s = k.shape[1]
    if typ == "local":  # the last min(S, w) positions into slots pos % w
        w = c["k"].shape[1]
        take = min(s, w)
        tpos = torch.arange(s - take, s, device=k.device)
        slots = tpos % w
        c["k"][:, slots] = k[:, s - take:]
        c["v"][:, slots] = v[:, s - take:]
        c["pos_abs"][:, slots] = tpos.to(torch.int32)
        return
    if s > c["k"].shape[1]:
        raise ValueError(f"a prefill of {s} tokens does not fit a cache of"
                         f" {c['k'].shape[1]} positions")
    if "kscale" in c:  # int8 KV view
        k, c["kscale"][:, :s] = _quantize_kv(k)
        v, c["vscale"][:, :s] = _quantize_kv(v)
    c["k"][:, :s] = k
    c["v"][:, :s] = v


def _prefix(new, old, s: int, ctx: ShardCtx):
    """``old`` with its first ``s`` positions (dim 1) replaced by ``new``,
    laid out as ``old``."""
    if s < old.shape[1]:
        new = torch.cat([new.to(old.dtype), old[:, s:]], dim=1)
    return ctx.cs(new.to(old.dtype), *ctx.spec_of(old))


def _fill_kv_mesh(c: Dict, typ: str, k, v, ctx: ShardCtx) -> None:
    s = k.shape[1]
    if typ == "local":  # the ring: slot j holds the last position ≡ j
        w = c["k"].shape[1]
        take = min(s, w)
        if take < w:  # positions 0..S-1 in slots 0..S-1
            c["k"] = _prefix(k, c["k"], s, ctx)
            c["v"] = _prefix(v, c["v"], s, ctx)
            pos = ctx.const(torch.arange(s, dtype=torch.int32,
                                         device=k.device))
            c["pos_abs"] = _prefix(pos[None].expand(k.shape[0], s),
                                   c["pos_abs"], s, ctx)
            return
        j = torch.arange(w, device=k.device)
        tpos = (s - w) + (j - (s - w)) % w  # the position slot j holds
        idx = ctx.const(tpos)
        c["k"] = _prefix(k[:, idx], c["k"], w, ctx)
        c["v"] = _prefix(v[:, idx], c["v"], w, ctx)
        c["pos_abs"] = _prefix(
            idx.to(torch.int32)[None].expand(k.shape[0], w), c["pos_abs"],
            w, ctx)
        return
    if s > c["k"].shape[1]:
        raise ValueError(f"a prefill of {s} tokens does not fit a cache of"
                         f" {c['k'].shape[1]} positions")
    if "kscale" in c:  # int8 KV view
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        c["kscale"] = _prefix(ks, c["kscale"], s, ctx)
        c["vscale"] = _prefix(vs, c["vscale"], s, ctx)
    c["k"] = _prefix(k, c["k"], s, ctx)
    c["v"] = _prefix(v, c["v"], s, ctx)


def _layer(p: Layer, x, cfg: ArchConfig, positions, memory,
           c: Optional[Dict] = None, ctx: ShardCtx = L.NO_MESH):
    """The parallel pass of one layer.  With its cache ``c`` (prefill) it
    also fills the layer's decode state in place.  Returns (x, MoE aux)."""
    typ = p.typ
    if typ in SELF_ATTN_TYPES:
        window = cfg.local_window if typ == "local" else None
        acfg = _attn_cfg(cfg, window=window, causal=(typ != "enc"))
        h = L.apply_norm(p.ln1, x, ctx)
        q, k, v = L.attn_qkv(p.attn, h, acfg, positions, ctx)
        o = L.attention(q, k, v, causal=acfg.causal, window=window, ctx=ctx)
        x = x + L.attn_out(p.attn, o, ctx)
        if c is not None:
            _fill_kv(c, typ, k, v, ctx)
        if typ == "dec":
            h = L.apply_norm(p.lnx, x, ctx)
            x = x + _cross_attention(p.xattn, h, memory, cfg, ctx)
            if c is not None:
                c["xk"], c["xv"] = _cross_kv(p.xattn, memory.to(x.dtype),
                                             ctx)
        h = L.apply_norm(p.ln2, x, ctx)
        if typ == "moe":
            y, aux = L.moe_block(p.moe, h, _moe_cfg(cfg), cfg.act, ctx)
            return x + y, aux
        return x + L.mlp_block(p.mlp, h, cfg.act, ctx), 0.0
    h = L.apply_norm(p.ln1, x, ctx)
    if typ == "xattn":
        if c is not None:
            c["xk"], c["xv"] = _cross_kv(p.xattn, memory.to(x.dtype), ctx)
        o = _cross_attention(p.xattn, h, memory, cfg, ctx)
        x = x + torch.tanh(p.xgate).to(x.dtype) * o
        h = L.apply_norm(p.ln2, x, ctx)
        m = L.mlp_block(p.mlp, h, cfg.act, ctx)
        return x + torch.tanh(p.mgate).to(x.dtype) * m, 0.0
    if typ == "rglru":
        if c is None:
            o = R.rglru_block(p.rec, h, ctx)
        else:
            o, state = R.rglru_block_prefill(p.rec, h, ctx)
            c.update(state)
        x = x + o
        h = L.apply_norm(p.ln2, x, ctx)
        return x + L.mlp_block(p.mlp, h, cfg.act, ctx), 0.0
    if typ == "mlstm":
        if c is None:
            return x + R.mlstm_block(p.lstm, h, _mlstm_cfg(cfg), ctx), 0.0
        o, state = R.mlstm_block_prefill(p.lstm, h, _mlstm_cfg(cfg), ctx)
    else:  # slstm
        o, state = R.slstm_block_prefill(p.lstm, h, _slstm_cfg(cfg), ctx)
    if c is not None:
        c.update(state)
    return x + o, 0.0


def _start(model: CausalLM, tokens, frames, patches,
           ctx: ShardCtx = L.NO_MESH, remat: bool = False):
    """Embedded tokens (+ learned positions), the positions and the
    cross-attention memory of a parallel pass."""
    x = _embed_tokens(model, tokens, ctx)
    s = x.shape[1]
    if model.pos_embed is not None:
        x = x + model.pos_embed[:s].to(x.dtype)[None]
    positions = ctx.const(torch.arange(s, device=x.device))
    return x, positions, _memory_for(model, frames, patches, ctx, remat)


def _remat_context(ctx: ShardCtx):
    """The recompute's context_fn: under ``save_tp`` the ops made inside
    ``layers.tp_block_out`` are kept, every other one recomputed."""
    if ctx.remat_policy != "save_tp":
        return torch_checkpoint.noop_context_fn
    CP = torch_checkpoint.CheckpointPolicy

    def policy(_ctx, _op, *args, **kwargs):
        return CP.MUST_SAVE if L.in_tp_block_out() else CP.PREFER_RECOMPUTE

    return lambda: torch_checkpoint.create_selective_checkpoint_contexts(
        policy)


def _run_group(layers, x, aux, cfg: ArchConfig, positions, memory,
               ctx: ShardCtx, remat: bool, *carry_spec):
    """One layer group (the reference's scan body): its layers in order,
    the MoE aux summed, the carry laid out as ``carry_spec``.  With
    ``remat`` the group is recomputed in the backward: its parameters
    pass into the checkpointed function and are bound there again, so
    the recompute sees the values the forward saw (the caller may have
    bound them with ``functional_call``, which has returned by the time
    the backward runs)."""
    def run(x, aux, *values):
        with _bound_slots(slots, values):
            for layer in layers:
                x, a = _layer(layer, x, cfg, positions, memory, ctx=ctx)
                aux = aux + a
        return ctx.cs(x, *carry_spec), aux

    slots = [(mod, name) for layer in layers for mod in layer.modules()
             for name, t in mod._parameters.items() if t is not None]
    values = constrain_group_params(
        [(name, mod._parameters[name]) for mod, name in slots], ctx)
    if not remat:
        return run(x, aux, *values)
    return torch_checkpoint.checkpoint(
        run, x, aux, *values, use_reentrant=False,
        context_fn=_remat_context(ctx))


@contextlib.contextmanager
def _bound_slots(slots, values):
    old = [mod._parameters[name] for mod, name in slots]
    for (mod, name), v in zip(slots, values):
        mod._parameters[name] = v
    try:
        yield
    finally:
        for (mod, name), v in zip(slots, old):
            mod._parameters[name] = v


def parallel(model: CausalLM, tokens: torch.Tensor, *, frames=None,
             patches=None, ctx: Optional[ShardCtx] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel pass with autograd on (a trainer's).  tokens (B, S) [+
    frames (B, T, frontend_dim) for audio | patches (B, T, frontend_dim)
    for vision].  Returns (logits (B, S, V) bf16, the MoE aux summed over
    layers, an f32 scalar).  With a ``ctx`` each layer group (and each
    encoder layer) is recomputed in the backward, as the reference's
    remat'd scans are."""
    remat = ctx is not None
    ctx = ctx or L.NO_MESH
    x, positions, memory = _start(model, tokens, frames, patches, ctx, remat)
    aux = ctx.const(torch.zeros((), dtype=torch.float32, device=x.device))
    plan = model.plan
    layers = list(model.layers)
    nh, p = len(plan.head), len(plan.pattern)
    nb = nh + plan.n_groups * p
    for layer in layers[:nh]:
        x, a = _layer(layer, x, model.cfg, positions, memory, ctx=ctx)
        aux = aux + a
    for g0 in range(nh, nb, p):
        x, aux = _run_group(layers[g0:g0 + p], x, aux, model.cfg, positions,
                            memory, ctx, remat, ctx.dp, ctx.act_seq, None)
    for layer in layers[nb:]:
        x, a = _layer(layer, x, model.cfg, positions, memory, ctx=ctx)
        aux = aux + a
    return unembed(model, x, ctx), aux


@torch.no_grad()
def forward(model: CausalLM, tokens: torch.Tensor, *, frames=None,
            patches=None, ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``parallel`` without autograd (serving and evaluation)."""
    return parallel(model, tokens, frames=frames, patches=patches, ctx=ctx)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

MOE_AUX_WEIGHT = 0.01
FRONTEND_INPUTS = ("frames", "patches")


def loss_fn(model_or_params, cfg: ArchConfig, batch: Mapping[str, Any], *,
            skeleton: Optional[CausalLM] = None,
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Causal-LM cross entropy (labels < 0 are masked) + MoE aux, with
    autograd on: ``MOE_AUX_WEIGHT · aux / n_moe`` over the layers of type
    ``moe``; the logsumexp in f32.  ``batch`` holds tensors: tokens and
    labels (B, S) [+ frames | patches].

    ``model_or_params`` is a ``CausalLM`` (its parameters get the
    gradients) or the reference's parameter tree of tensors (its leaves
    get them, through ``bind_reference``'s casts), which is then run in
    ``skeleton``, a ``CausalLM`` of ``cfg`` whose own values are unused
    (made on the meta device when None); ``cast_weights`` first under
    ``ctx.bf16_weights``.  ``ctx`` as ``parallel``."""
    extra = {k: batch[k] for k in FRONTEND_INPUTS if k in batch}
    if isinstance(model_or_params, CausalLM):
        logits, aux = model_or_params(batch["tokens"], ctx=ctx, **extra)
    else:
        model = skeleton or init_model(cfg, device="meta")
        params = cast_weights(model_or_params, ctx)
        logits, aux = torch.func.functional_call(
            model, bind_reference(model, params), (batch["tokens"],),
            dict(extra, ctx=ctx))
    labels = batch["labels"]
    if not isinstance(labels, torch.Tensor):
        labels = torch.as_tensor(labels)
    labels = labels.to(device=logits.device, dtype=torch.long)
    mask = (labels >= 0).to(torch.float32)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold_ids = torch.clamp(labels, min=0)
    if ctx is None or ctx.mesh is None:
        gold = torch.gather(lf, -1, gold_ids[..., None])[..., 0]
    else:  # a select over the vocab that stays vocab-sharded (exact)
        vocab = ctx.const(torch.arange(lf.shape[-1], device=lf.device))
        gold = torch.where(vocab == gold_ids[..., None], lf,
                           torch.zeros((), dtype=lf.dtype,
                                       device=lf.device)).sum(-1)
    nll = (lse - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    n_moe = sum(1 for t in cfg.layer_types() if t == "moe")
    if n_moe:
        loss = loss + div_once(MOE_AUX_WEIGHT * aux, n_moe)
    return loss


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

def _layer_cache(typ: str, cfg: ArchConfig, batch: int, max_len: int,
                 kv_int8: bool, dev) -> Dict[str, torch.Tensor]:
    """Zeros (ring positions -1, stabilisers -1e30) of one layer's state."""
    hkv, hd = cfg.num_kv_heads, cfg.hd

    def zeros(shape, dtype=COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if typ in KV_TYPES:
        shape = (batch, max_len, hkv, hd)
        kv_dt = torch.int8 if kv_int8 else COMPUTE_DTYPE
        c = {"k": zeros(shape, kv_dt), "v": zeros(shape, kv_dt)}
        if kv_int8:  # §4 multi-representation view: int8 KV + scales
            c["kscale"] = zeros((batch, max_len, hkv))
            c["vscale"] = zeros((batch, max_len, hkv))
        if typ == "dec":  # cross-KV from the encoder output
            t = cfg.num_frontend_tokens
            c["xk"] = zeros((batch, t, hkv, hd))
            c["xv"] = zeros((batch, t, hkv, hd))
        return c
    if typ == "local":
        w = min(cfg.local_window, max_len)
        return {"k": zeros((batch, w, hkv, hd)),
                "v": zeros((batch, w, hkv, hd)),
                "pos_abs": torch.full((batch, w), -1, dtype=torch.int32,
                                      device=dev)}
    if typ == "xattn":
        t = cfg.num_frontend_tokens
        return {"xk": zeros((batch, t, hkv, hd)),
                "xv": zeros((batch, t, hkv, hd))}
    if typ == "rglru":
        return R.rglru_init_state(batch, cfg.rnn_width or cfg.d_model,
                                  device=dev)
    if typ == "mlstm":
        return R.mlstm_init_state(batch, _mlstm_cfg(cfg), device=dev)
    if typ == "slstm":
        return R.slstm_init_state(batch, _slstm_cfg(cfg), device=dev)
    raise ValueError(f"unknown layer type {typ!r}")


def init_cache(model: CausalLM, batch: int, max_len: int,
               kv_int8: bool = False) -> Dict[str, Any]:
    """Per layer its decode state: a dense K/V (B, max_len, Hkv, hd) bf16
    for ``attn``/``moe``/``dense0``/``dec`` (int8 with bf16 per-position
    scales ``kscale``/``vscale`` (B, max_len, Hkv) under ``kv_int8``), a
    ring of min(local_window, max_len) slots with their absolute
    positions ``pos_abs`` for ``local``, cross-KV ``xk``/``xv`` (B,
    T_frontend, Hkv, hd) for ``xattn`` and ``dec``, the recurrent states
    of ``rglru``/``mlstm``/``slstm``; and ``pos`` (B,) int32: the tokens
    held."""
    dev = model.device
    return {
        "layers": [_layer_cache(layer.typ, model.cfg, batch, max_len,
                                kv_int8, dev) for layer in model.layers],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _decode_attention(q, k, v, valid_mask=None, k_scale=None, v_scale=None):
    """q: (B,1,Hq,hd) bf16; k/v: (B,L,Hkv,hd) bf16 or int8; valid_mask:
    (B,L) or None (every position).

    Scores and the weighted sum take the stored values with f32
    accumulation (the products of bf16 or int8 values are exact in f32);
    the probabilities are rounded to bf16 before the second product, as
    in the reference.  An int8 view's scores are rescaled by ``k_scale``
    (B, L, Hkv) per position and its probabilities by ``v_scale`` before
    that rounding.  Returns (B,1,Hq,hd) f32."""
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = float(1.0 / np.sqrt(hd))
    qg = q.reshape(b, hkv, g, hd)
    s = torch.einsum("bhgd,blhd->bhgl", qg.to(torch.float32),
                     k.to(torch.float32))
    if k_scale is not None:
        s = s * k_scale.to(torch.float32).permute(0, 2, 1)[:, :, None]
    s = s * scale
    if valid_mask is not None:
        s = torch.where(valid_mask[:, None, None, :], s,
                        torch.tensor(L.NEG_INF, dtype=s.dtype,
                                     device=s.device))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None]
    o = torch.einsum("bhgl,blhd->bhgd", p.to(COMPUTE_DTYPE).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(b, 1, hq, hd)


def _decode_attention_on(ctx: ShardCtx, q, k, v, valid_mask=None,
                         k_scale=None, v_scale=None):
    """``_decode_attention`` on a mesh, the cache laid out by its rules:
    over its heads (cross-KV), each device attends its own heads; over
    its positions (the self-attention cache, sequence-parallel), each
    device scores its own positions and the softmax is combined across
    them (``_decode_split``); else each data shard attends its rows."""
    if ctx.mesh is None:
        return _decode_attention(q, k, v, valid_mask, k_scale, v_scale)
    kspec = ctx.spec_of(k)
    dp = kspec[0]
    opt = [(t, sp) for t, sp in ((valid_mask, kspec[:2]),
                                  (k_scale, kspec[:3]), (v_scale, kspec[:3]))
           if t is not None]
    names = [n for n, t in (("valid_mask", valid_mask), ("k_scale", k_scale),
                            ("v_scale", v_scale)) if t is not None]
    if kspec[1] is not None:
        return _decode_split(ctx, q, k, v, valid_mask, k_scale, v_scale,
                             kspec)
    q_ax, kv_ax, pick = L.heads_of(ctx, q.shape[2], k.shape[2],
                                   kspec[2] or "model")
    if kspec[2] is None:
        q_ax = pick = None
    q_spec = (dp, None, q_ax, None)

    def fn(q, k, v, *rest):
        if pick is not None:
            idx = torch.tensor(pick, device=k.device)
            k, v = k[:, :, idx], v[:, :, idx]
        return (_decode_attention(q, k, v, **dict(zip(names, rest))),)

    return ctx.local_map(fn, (q, k, v, *[t for t, _ in opt]),
                         (q_spec, kspec, kspec, *[sp for _, sp in opt]),
                         [ctx.placements(q.shape, q_spec)])[0]


def _decode_split(ctx: ShardCtx, q, k, v, valid, k_scale, v_scale, kspec):
    """Decode attention over a cache whose positions are split over the
    mesh axis ``kspec[1]``: each device scores its own positions (and
    their max and sum of exponentials), the max and sum are combined
    across the axis, then each device weights its own values by the
    global softmax (rounded to bf16, as ``_decode_attention``) and the
    partial sums are added across the axis."""
    from torch.distributed.tensor import DTensor, Partial

    dp, ax = kspec[0], kspec[1]
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = float(1.0 / np.sqrt(hd))
    has_ks, has_vs = k_scale is not None, v_scale is not None

    def scores(q, k, valid, *ks):
        s = torch.einsum("bhgd,blhd->bhgl",
                         q.reshape(q.shape[0], hkv, g, hd).to(torch.float32),
                         k.to(torch.float32))
        if ks:
            s = s * ks[0].to(torch.float32).permute(0, 2, 1)[:, :, None]
        s = torch.where(valid[:, None, None, :], s * scale,
                        torch.tensor(L.NEG_INF, dtype=s.dtype,
                                     device=s.device))
        mx = s.amax(-1)
        return s, mx[None], torch.exp(s - mx[..., None]).sum(-1)[None]

    stat = (b, hkv, g)
    s, mx, sm = ctx.local_map(
        scores, (q, k, valid) + ((k_scale,) if has_ks else ()),
        ((dp, None, None, None), kspec, kspec[:2]) + ((kspec[:3],)
                                                       if has_ks else ()),
        [ctx.placements((b, hkv, g, k.shape[1]), (dp, None, None, ax)),
         ctx.placements((ctx.axis_size(ax),) + stat, (ax, dp)),
         ctx.placements((ctx.axis_size(ax),) + stat, (ax, dp))])
    m = ctx.cs(mx.amax(0), dp)
    total = ctx.cs((sm * torch.exp(mx - m[None])).sum(0), dp)

    def weigh(s, m, total, v, *vs):
        p = torch.exp(s - m[..., None]) / total[..., None]
        if vs:
            p = p * vs[0].to(torch.float32).permute(0, 2, 1)[:, :, None]
        o = torch.einsum("bhgl,blhd->bhgd",
                         p.to(COMPUTE_DTYPE).to(torch.float32),
                         v.to(torch.float32))
        return (o.reshape(o.shape[0], 1, hq, hd),)

    part = list(ctx.placements((b, 1, hq, hd), (dp,)))
    part[ctx.axis_names.index(ax)] = Partial()
    o, = ctx.local_map(
        weigh, (s, m, total, v) + ((v_scale,) if has_vs else ()),
        ((dp, None, None, ax), (dp,), (dp,), kspec)
        + ((kspec[:3],) if has_vs else ()), [tuple(part)])
    assert isinstance(o, DTensor)
    return ctx.cs(o, dp)


def _step_attn_common(p: L.Attention, h, cfg: ArchConfig, pos,
                      ctx: ShardCtx = L.NO_MESH):
    """Project + rope the single new token. h: (B,1,D) → q,k,v (B,1,·,hd)."""
    q, k, v = L.qkv_proj(p, h, ctx)
    if cfg.qk_norm:
        q = ctx.rowwise(L.rmsnorm, q, p.q_norm)
        k = ctx.rowwise(L.rmsnorm, k, p.k_norm)
    if cfg.use_rope:
        q = L.rope(q, pos[:, None], cfg.rope_theta, ctx)
        k = L.rope(k, pos[:, None], cfg.rope_theta, ctx)
    return q, k, v


def _step_cross(p: L.Attention, h, c: Dict, ctx: ShardCtx = L.NO_MESH):
    """The new token's cross-attention over the cached cross-KV; the
    query takes no qk-norm, as in the reference's step."""
    q_ax = L.heads_of(ctx, p.wq.shape[1], p.wk.shape[1])[0]
    qx = L.head_proj(h, p.wq, ctx, q_ax)
    o = _decode_attention_on(ctx, qx, c["xk"], c["xv"])
    return L.attn_out(p, o.to(h.dtype), ctx)


def _put_rows(c: Dict, name: str, slot, value, ctx: ShardCtx) -> None:
    """Row b of ``c[name]`` at position ``slot[b]`` (dim 1) set to
    ``value[b]``: in place without a mesh; on one, a new tensor of the
    same layout by one whole-tensor select (a DTensor takes no indexed
    write)."""
    buf = c[name]
    if ctx.mesh is None:
        buf[torch.arange(buf.shape[0], device=buf.device), slot] = value
        return
    at = (ctx.const(torch.arange(buf.shape[1], device=buf.device))[None, :]
          == slot[:, None])  # (B, L)
    at = at.reshape(*at.shape, *([1] * (buf.dim() - 2)))
    value = value.to(buf.dtype).reshape(buf.shape[0], 1, *buf.shape[2:])
    c[name] = ctx.cs(torch.where(at, value, buf), *ctx.spec_of(buf))


def _step_layer(p: Layer, c: Dict, x, cfg: ArchConfig, pos,
                ctx: ShardCtx = L.NO_MESH):
    """One-token update of one layer, its state ``c`` updated in place.
    x: (B,1,D); pos: (B,) int32."""
    typ = p.typ
    lpos = pos.long()
    h = L.apply_norm(p.ln1, x, ctx)
    if typ in KV_TYPES or typ == "local":
        q, k, v = _step_attn_common(p.attn, h, cfg, pos, ctx)
        k, v = k[:, 0], v[:, 0]
        if typ == "local":
            slot = lpos % c["k"].shape[1]
            _put_rows(c, "k", slot, k, ctx)
            _put_rows(c, "v", slot, v, ctx)
            _put_rows(c, "pos_abs", slot, pos, ctx)
            pa = c["pos_abs"]
            valid = (pa >= 0) & (pa <= pos[:, None]) & (
                pa > pos[:, None] - cfg.local_window)
        else:
            if "kscale" in c:  # int8 KV view
                k, ks = _quantize_kv(k)
                v, vs = _quantize_kv(v)
                _put_rows(c, "kscale", lpos, ks, ctx)
                _put_rows(c, "vscale", lpos, vs, ctx)
            _put_rows(c, "k", lpos, k, ctx)
            _put_rows(c, "v", lpos, v, ctx)
            valid = (ctx.const(torch.arange(c["k"].shape[1],
                                            device=x.device))[None, :]
                     <= pos[:, None])
        o = _decode_attention_on(ctx, q, c["k"], c["v"], valid,
                                 c.get("kscale"), c.get("vscale"))
        x = x + L.attn_out(p.attn, o.to(x.dtype), ctx)
        if typ == "dec":
            x = x + _step_cross(p.xattn, L.apply_norm(p.lnx, x, ctx), c, ctx)
        h = L.apply_norm(p.ln2, x, ctx)
        if typ == "moe":  # over the step's B tokens: capacity at least 8
            return x + L.moe_block(p.moe, h, _moe_cfg(cfg), cfg.act, ctx)[0]
        return x + L.mlp_block(p.mlp, h, cfg.act, ctx)
    if typ == "xattn":
        x = x + torch.tanh(p.xgate).to(x.dtype) * _step_cross(p.xattn, h, c,
                                                              ctx)
        h = L.apply_norm(p.ln2, x, ctx)
        m = L.mlp_block(p.mlp, h, cfg.act, ctx)
        return x + torch.tanh(p.mgate).to(x.dtype) * m
    if typ == "rglru":
        state, o = R.rglru_block_step(p.rec, c, h[:, 0], ctx)
        c.update(state)
        x = x + o[:, None]
        h = L.apply_norm(p.ln2, x, ctx)
        return x + L.mlp_block(p.mlp, h, cfg.act, ctx)
    if typ == "mlstm":
        state, o = R.mlstm_block_step(p.lstm, c, h[:, 0], _mlstm_cfg(cfg),
                                      ctx)
    else:  # slstm
        state, o = R.slstm_block_step(p.lstm, c, h[:, 0], _slstm_cfg(cfg),
                                      ctx)
    c.update(state)
    return x + o[:, None]


@torch.no_grad()
def decode_step(model: CausalLM, cache: Dict, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), cache),
    the cache updated in place (pos + 1)."""
    ctx = ctx or L.NO_MESH
    pos = cache["pos"]
    x = _embed_tokens(model, tokens, ctx)
    if model.pos_embed is not None:
        x = x + model.pos_embed[pos.long()][:, None].to(x.dtype)
    for layer, c in zip(model.layers, cache["layers"]):
        x = _step_layer(layer, c, x, model.cfg, pos, ctx)
    cache["pos"] = pos + 1
    return unembed(model, x, ctx), cache


# ---------------------------------------------------------------------------
# prefill: parallel pass that also fills the decode cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(model: CausalLM, tokens: torch.Tensor, cache: Dict, *,
            frames=None, patches=None, ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Parallel prefill of ``tokens`` (B, S) [+ the frontend input, as
    ``forward``]; fills the cache in place and returns the last token's
    logits (B, 1, V) and the cache (pos = S)."""
    ctx = ctx or L.NO_MESH
    x, positions, memory = _start(model, tokens, frames, patches, ctx)
    for layer, c in zip(model.layers, cache["layers"]):
        x, _ = _layer(layer, x, model.cfg, positions, memory, c, ctx)
        x = ctx.cs(x, ctx.dp, None, None)
    b, s = x.shape[:2]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    cache["pos"] = ctx.cs(ctx.const(pos), ctx.dp)
    return unembed(model, x[:, -1:], ctx), cache
