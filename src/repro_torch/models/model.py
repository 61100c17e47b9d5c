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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.tree import leaf_paths, tree_map
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

    def forward(self, tokens: torch.Tensor, *, frames=None, patches=None):
        return parallel(self, tokens, frames=frames, patches=patches)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without a card raises (no
    entry point falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the model runs on 'cuda' by default;"
            " pass device='cpu' to run on the CPU")
    return dev


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
        return value.to(dtypes[name]) if value.dtype == torch.float32 \
            else value

    out: Dict[str, torch.Tensor] = {}
    for (path, name), (_p, value) in zip(leaf_paths(names),
                                          leaf_paths(params)):
        if isinstance(name, list):
            if value.shape[0] != len(name):
                raise ValueError(f"{path}: {value.shape[0]} stacked layers,"
                                 f" the model has {len(name)}")
            out.update((n, cast(n, v)) for n, v in zip(name, value.unbind(0)))
        else:
            out[name] = cast(name, value)
    return out


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

def _embed_tokens(model: CausalLM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.to(device=model.device, dtype=torch.long)]


def unembed(model: CausalLM, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(model.final_norm, x)
    w = (model.embed.to(x.dtype).T if model.cfg.tie_embeddings
         else model.lm_head.to(x.dtype))
    return x @ w


def _frontend(model: CausalLM, x: torch.Tensor) -> torch.Tensor:
    x = x.to(device=model.device, dtype=COMPUTE_DTYPE)
    return x @ model.frontend_proj.to(COMPUTE_DTYPE)


def _encode_audio(model: CausalLM, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, T, frontend_dim)."""
    enc = model.encoder
    x = _frontend(model, frames)
    t = x.shape[1]
    x = x + enc.pos_embed[:t].to(x.dtype)[None]
    positions = torch.arange(t, device=x.device)
    for layer in enc.layers:
        x, _ = _layer(layer, x, model.cfg, positions, None)
    return L.apply_norm(enc.norm, x)


def _memory_for(model: CausalLM, frames, patches):
    """Cross-attention memory from the (stubbed) modality frontend."""
    family = model.cfg.family
    need = {"audio": ("frames", frames), "vlm": ("patches", patches)}
    if family in need:
        name, value = need[family]
        if value is None:
            raise ValueError(f"the {family} family needs {name!r}")
        return (_encode_audio(model, value) if family == "audio"
                else _frontend(model, value))
    return None


def _cross_kv(p: L.Attention, memory: torch.Tensor):
    dt = memory.dtype
    return (torch.einsum("btd,dhk->bthk", memory, p.wk.to(dt)),
            torch.einsum("btd,dhk->bthk", memory, p.wv.to(dt)))


def _cross_attention(p: L.Attention, x, memory, cfg: ArchConfig):
    """Cross-attention: queries from x, keys/values from memory."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k, v = _cross_kv(p, memory.to(x.dtype))
    if cfg.qk_norm:
        q = L.rmsnorm(q, p.q_norm)
        k = L.rmsnorm(k, p.k_norm)
    return L.attn_out(p, L.attention(q, k, v, causal=False))


def _quantize_kv(x: torch.Tensor):
    """(…, Hkv, hd) → (int8 values, (…, Hkv) bf16 scales); rounds half to
    even, as the reference's ``jnp.round``."""
    xf = x.to(torch.float32)
    s = torch.clamp(xf.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(COMPUTE_DTYPE)


def _fill_kv(c: Dict, typ: str, k, v) -> None:
    """Write a prefill's K/V (B, S, Hkv, hd) into one layer's cache."""
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


def _layer(p: Layer, x, cfg: ArchConfig, positions, memory,
           c: Optional[Dict] = None):
    """The parallel pass of one layer.  With its cache ``c`` (prefill) it
    also fills the layer's decode state in place.  Returns (x, MoE aux)."""
    typ = p.typ
    if typ in SELF_ATTN_TYPES:
        window = cfg.local_window if typ == "local" else None
        acfg = _attn_cfg(cfg, window=window, causal=(typ != "enc"))
        h = L.apply_norm(p.ln1, x)
        q, k, v = L.attn_qkv(p.attn, h, acfg, positions)
        o = L.attention(q, k, v, causal=acfg.causal, window=window)
        x = x + L.attn_out(p.attn, o)
        if c is not None:
            _fill_kv(c, typ, k, v)
        if typ == "dec":
            h = L.apply_norm(p.lnx, x)
            x = x + _cross_attention(p.xattn, h, memory, cfg)
            if c is not None:
                c["xk"], c["xv"] = _cross_kv(p.xattn, memory.to(x.dtype))
        h = L.apply_norm(p.ln2, x)
        if typ == "moe":
            y, aux = L.moe_block(p.moe, h, _moe_cfg(cfg), cfg.act)
            return x + y, aux
        return x + L.mlp_block(p.mlp, h, cfg.act), 0.0
    h = L.apply_norm(p.ln1, x)
    if typ == "xattn":
        if c is not None:
            c["xk"], c["xv"] = _cross_kv(p.xattn, memory.to(x.dtype))
        o = _cross_attention(p.xattn, h, memory, cfg)
        x = x + torch.tanh(p.xgate).to(x.dtype) * o
        h = L.apply_norm(p.ln2, x)
        m = L.mlp_block(p.mlp, h, cfg.act)
        return x + torch.tanh(p.mgate).to(x.dtype) * m, 0.0
    if typ == "rglru":
        if c is None:
            o = R.rglru_block(p.rec, h)
        else:
            o, state = R.rglru_block_prefill(p.rec, h)
            c.update(state)
        x = x + o
        h = L.apply_norm(p.ln2, x)
        return x + L.mlp_block(p.mlp, h, cfg.act), 0.0
    if typ == "mlstm":
        if c is None:
            return x + R.mlstm_block(p.lstm, h, _mlstm_cfg(cfg)), 0.0
        o, state = R.mlstm_block_prefill(p.lstm, h, _mlstm_cfg(cfg))
    else:  # slstm
        o, state = R.slstm_block_prefill(p.lstm, h, _slstm_cfg(cfg))
    if c is not None:
        c.update(state)
    return x + o, 0.0


def _start(model: CausalLM, tokens, frames, patches):
    """Embedded tokens (+ learned positions), the positions and the
    cross-attention memory of a parallel pass."""
    x = _embed_tokens(model, tokens)
    s = x.shape[1]
    if model.pos_embed is not None:
        x = x + model.pos_embed[:s].to(x.dtype)[None]
    positions = torch.arange(s, device=x.device)
    return x, positions, _memory_for(model, frames, patches)


def parallel(model: CausalLM, tokens: torch.Tensor, *, frames=None,
             patches=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel pass with autograd on (a trainer's).  tokens (B, S) [+
    frames (B, T, frontend_dim) for audio | patches (B, T, frontend_dim)
    for vision].  Returns (logits (B, S, V) bf16, the MoE aux summed over
    layers, an f32 scalar)."""
    x, positions, memory = _start(model, tokens, frames, patches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, a = _layer(layer, x, model.cfg, positions, memory)
        aux = aux + a
    return unembed(model, x), aux


@torch.no_grad()
def forward(model: CausalLM, tokens: torch.Tensor, *, frames=None,
            patches=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``parallel`` without autograd (serving and evaluation)."""
    return parallel(model, tokens, frames=frames, patches=patches)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

MOE_AUX_WEIGHT = 0.01
FRONTEND_INPUTS = ("frames", "patches")


def loss_fn(model_or_params, cfg: ArchConfig, batch: Mapping[str, Any], *,
            skeleton: Optional[CausalLM] = None) -> torch.Tensor:
    """Causal-LM cross entropy (labels < 0 are masked) + MoE aux, with
    autograd on: ``MOE_AUX_WEIGHT · aux / n_moe`` over the layers of type
    ``moe``; the logsumexp in f32.  ``batch`` holds tensors: tokens and
    labels (B, S) [+ frames | patches].

    ``model_or_params`` is a ``CausalLM`` (its parameters get the
    gradients) or the reference's parameter tree of tensors (its leaves
    get them, through ``bind_reference``'s casts), which is then run in
    ``skeleton``, a ``CausalLM`` of ``cfg`` whose own values are unused
    (made on the meta device when None)."""
    extra = {k: batch[k] for k in FRONTEND_INPUTS if k in batch}
    if isinstance(model_or_params, CausalLM):
        logits, aux = model_or_params(batch["tokens"], **extra)
    else:
        model = skeleton or init_model(cfg, device="meta")
        logits, aux = torch.func.functional_call(
            model, bind_reference(model, model_or_params),
            (batch["tokens"],), extra)
    labels = torch.as_tensor(batch["labels"]).to(device=logits.device,
                                                 dtype=torch.long)
    mask = (labels >= 0).to(torch.float32)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
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


def _step_attn_common(p: L.Attention, h, cfg: ArchConfig, pos):
    """Project + rope the single new token. h: (B,1,D) → q,k,v (B,1,·,hd)."""
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, p.wv.to(dt))
    if cfg.qk_norm:
        q = L.rmsnorm(q, p.q_norm)
        k = L.rmsnorm(k, p.k_norm)
    if cfg.use_rope:
        q = L.rope(q, pos[:, None], cfg.rope_theta)
        k = L.rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def _step_cross(p: L.Attention, h, c: Dict):
    """The new token's cross-attention over the cached cross-KV; the
    query takes no qk-norm, as in the reference's step."""
    qx = torch.einsum("bsd,dhk->bshk", h, p.wq.to(h.dtype))
    return L.attn_out(p, _decode_attention(qx, c["xk"], c["xv"]).to(h.dtype))


def _step_layer(p: Layer, c: Dict, x, cfg: ArchConfig, pos):
    """One-token update of one layer, its state ``c`` updated in place.
    x: (B,1,D); pos: (B,) int32."""
    typ = p.typ
    bidx = torch.arange(x.shape[0], device=x.device)
    lpos = pos.long()
    h = L.apply_norm(p.ln1, x)
    if typ in KV_TYPES or typ == "local":
        q, k, v = _step_attn_common(p.attn, h, cfg, pos)
        k, v = k[:, 0], v[:, 0]
        if typ == "local":
            slot = lpos % c["k"].shape[1]
            c["k"][bidx, slot] = k
            c["v"][bidx, slot] = v
            c["pos_abs"][bidx, slot] = pos
            pa = c["pos_abs"]
            valid = (pa >= 0) & (pa <= pos[:, None]) & (
                pa > pos[:, None] - cfg.local_window)
        else:
            if "kscale" in c:  # int8 KV view
                k, c["kscale"][bidx, lpos] = _quantize_kv(k)
                v, c["vscale"][bidx, lpos] = _quantize_kv(v)
            c["k"][bidx, lpos] = k
            c["v"][bidx, lpos] = v
            valid = (torch.arange(c["k"].shape[1], device=x.device)[None, :]
                     <= pos[:, None])
        o = _decode_attention(q, c["k"], c["v"], valid, c.get("kscale"),
                              c.get("vscale"))
        x = x + L.attn_out(p.attn, o.to(x.dtype))
        if typ == "dec":
            x = x + _step_cross(p.xattn, L.apply_norm(p.lnx, x), c)
        h = L.apply_norm(p.ln2, x)
        if typ == "moe":  # over the step's B tokens: capacity at least 8
            return x + L.moe_block(p.moe, h, _moe_cfg(cfg), cfg.act)[0]
        return x + L.mlp_block(p.mlp, h, cfg.act)
    if typ == "xattn":
        x = x + torch.tanh(p.xgate).to(x.dtype) * _step_cross(p.xattn, h, c)
        h = L.apply_norm(p.ln2, x)
        m = L.mlp_block(p.mlp, h, cfg.act)
        return x + torch.tanh(p.mgate).to(x.dtype) * m
    if typ == "rglru":
        state, o = R.rglru_block_step(p.rec, c, h[:, 0])
        c.update(state)
        x = x + o[:, None]
        h = L.apply_norm(p.ln2, x)
        return x + L.mlp_block(p.mlp, h, cfg.act)
    if typ == "mlstm":
        state, o = R.mlstm_block_step(p.lstm, c, h[:, 0], _mlstm_cfg(cfg))
    else:  # slstm
        state, o = R.slstm_block_step(p.lstm, c, h[:, 0], _slstm_cfg(cfg))
    c.update(state)
    return x + o[:, None]


@torch.no_grad()
def decode_step(model: CausalLM, cache: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), cache),
    the cache updated in place (pos + 1)."""
    pos = cache["pos"]
    x = _embed_tokens(model, tokens)
    if model.pos_embed is not None:
        x = x + model.pos_embed[pos.long()][:, None].to(x.dtype)
    for layer, c in zip(model.layers, cache["layers"]):
        x = _step_layer(layer, c, x, model.cfg, pos)
    cache["pos"] = pos + 1
    return unembed(model, x), cache


# ---------------------------------------------------------------------------
# prefill: parallel pass that also fills the decode cache
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(model: CausalLM, tokens: torch.Tensor, cache: Dict, *,
            frames=None, patches=None) -> Tuple[torch.Tensor, Dict]:
    """Parallel prefill of ``tokens`` (B, S) [+ the frontend input, as
    ``forward``]; fills the cache in place and returns the last token's
    logits (B, 1, V) and the cache (pos = S)."""
    x, positions, memory = _start(model, tokens, frames, patches)
    for layer, c in zip(model.layers, cache["layers"]):
        x, _ = _layer(layer, x, model.cfg, positions, memory, c)
    b, s = x.shape[:2]
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return unembed(model, x[:, -1:]), cache
