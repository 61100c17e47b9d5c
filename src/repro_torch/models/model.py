"""The dense causal LM of the ten assigned architectures, in PyTorch.

Port of the dense ("attn" layer type: global self-attention and a
gated MLP) part of ``repro.models.model``.  The reference stacks its
layers into groups and runs them with ``lax.scan``; here a ``CausalLM``
module holds one submodule per layer and Python loops over them.  Three
entry points, as in the reference:

  ``forward``      parallel pass → logits (B, S, V) bf16
  ``prefill``      parallel pass that also fills the decode cache
  ``decode_step``  one token against the cache

Weights live in bf16 and norm scales in f32 (the numbers of the
reference's f32 masters cast at use).  ``from_reference_params`` carries
the reference's parameter dict across; ``reference_shapes`` gives the
reference's key layout of a port model.  The decode cache is updated in
place (the reference returns a new one): a dense cache at full width is
large.  The other layer types (``local``, ``moe``, ``rglru``, ``mlstm``,
``slstm``, ``xattn``, ``dec``, ``enc``, ``dense0``) raise
``NotImplementedError`` (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

COMPUTE_DTYPE = torch.bfloat16
DENSE_TYPES = ("attn",)


def _not_ported(typ: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer type {typ!r} is not ported to repro_torch yet (ROADMAP"
        " Queue 1 item 8: the non-dense layer types); only 'attn' is")


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


def _check_dense(cfg: ArchConfig) -> None:
    for typ in layer_types(layer_plan(cfg)):
        if typ not in DENSE_TYPES:
            raise _not_ported(typ)


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


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------

class DenseLayer(torch.nn.Module):
    """ln1 → self-attention → ln2 → MLP, each with a residual."""

    def __init__(self, cfg: ArchConfig, *, generator, device):
        super().__init__()
        d, nt = cfg.d_model, cfg.norm_type
        self.ln1 = L.Norm(d, nt, device=device)
        self.attn = L.Attention(_attn_cfg(cfg), generator=generator,
                                device=device)
        self.ln2 = L.Norm(d, nt, device=device)
        self.mlp = L.MLP(d, cfg.d_ff, cfg.gated_mlp, generator=generator,
                         device=device)


class CausalLM(torch.nn.Module):
    """embed (V, D) bf16, one ``DenseLayer`` per layer, final norm and,
    unless tied, lm_head (D, V) bf16."""

    def __init__(self, cfg: ArchConfig, *, generator, device):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        if torch.device(device).type == "meta":
            embed = torch.empty((cfg.vocab_size, cfg.d_model),
                                dtype=COMPUTE_DTYPE, device=device)
        else:
            embed = torch.empty((cfg.vocab_size, cfg.d_model),
                                dtype=torch.float32, device=device)
            embed = (embed.normal_(generator=generator) * 0.02).to(
                COMPUTE_DTYPE)
        self.embed = torch.nn.Parameter(embed, requires_grad=False)
        self.layers = torch.nn.ModuleList(
            DenseLayer(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.lm_head: Optional[torch.nn.Parameter] = None
        if not cfg.tie_embeddings:
            self.lm_head = L.weight((cfg.d_model, cfg.vocab_size),
                                    cfg.d_model, generator=generator,
                                    device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the model runs on 'cuda' by default;"
            " pass device='cpu' to run on the CPU")
    return dev


def init_model(cfg: ArchConfig, *, device="cuda",
               generator: Optional[torch.Generator] = None) -> CausalLM:
    """Random weights drawn on ``device`` from ``generator`` (a fresh one
    seeded 0 when None), in the reference's distribution: embed N(0,
    0.02²), projections N(0, 1/fan_in), norm scales 0.  On ``"meta"`` only
    the shapes are made."""
    dev = _device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        return CausalLM(cfg, generator=generator, device=dev)


# the reference's key of each layer: groups of the pattern, stacked
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


def _layer_tree(layer: DenseLayer) -> Dict[str, Any]:
    attn = {k: getattr(layer.attn, k) for k in ("wq", "wk", "wv", "wo",
                                                 "q_norm", "k_norm")
            if hasattr(layer.attn, k)}
    mlp = {k: getattr(layer.mlp, k) for k in ("wi", "wd", "wg")
           if hasattr(layer.mlp, k)}

    def norm(n):
        return {k: getattr(n, k) for k in ("scale", "bias") if hasattr(n, k)}

    return {"ln1": norm(layer.ln1), "attn": attn, "ln2": norm(layer.ln2),
            "mlp": mlp}


def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def reference_shapes(model: CausalLM) -> Dict[str, Any]:
    """The reference's parameter layout of ``model``: the same nested
    keys, with each leaf's shape (groups stacked on a leading axis)."""
    cfg = model.cfg
    plan = layer_plan(cfg)
    out: Dict[str, Any] = {"embed": tuple(model.embed.shape)}
    groups: Dict[str, List] = {}
    for li, layer in enumerate(model.layers):
        key, g = _layer_key(plan, li)
        tree = _tree_map(lambda t: tuple(t.shape), _layer_tree(layer))
        if g is None:
            out[key] = tree
        else:
            groups.setdefault(key, []).append(tree)
    if groups:
        out["groups"] = {k: _tree_map(lambda *s: (len(s), *s[0]), *trees)
                         for k, trees in groups.items()}
    out["final_norm"] = _tree_map(lambda t: tuple(t.shape),
                                  {"scale": model.final_norm.scale})
    if model.lm_head is not None:
        out["lm_head"] = tuple(model.lm_head.shape)
    return out


def from_reference_params(params_np: Mapping[str, Any], cfg: ArchConfig,
                          device="cuda") -> CausalLM:
    """A port model holding the reference's weights: ``params_np`` is the
    reference's nested dict of (numpy) arrays; ``groups`` is unstacked
    along its leading axis.  f32 weights are rounded to bf16 as the
    reference casts them at use; norm scales stay f32."""
    model = init_model(cfg, device="meta")
    dev = _device(device)
    plan = layer_plan(cfg)

    def take(path, ref_leaf, idx):
        a = np.asarray(ref_leaf)
        if idx is not None:
            a = a[idx]
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        dt = torch.float32 if path[-1] in ("scale", "bias", "q_norm",
                                           "k_norm") else COMPUTE_DTYPE
        return t.to(device=dev, dtype=dt)

    def assign(module, tree_ref, idx, path=()):
        for k, sub in tree_ref.items():
            target = getattr(module, k)
            if isinstance(sub, Mapping):
                assign(target, sub, idx, path + (k,))
                continue
            t = take(path + (k,), sub, idx)
            if tuple(t.shape) != tuple(target.shape):
                raise ValueError(f"{'/'.join(path + (k,))}: reference shape"
                                 f" {tuple(t.shape)}, port {tuple(target.shape)}")
            setattr(module, k, torch.nn.Parameter(t, requires_grad=False))

    want = reference_shapes(model)
    if set(params_np) != set(want):
        raise ValueError(f"reference params have keys {sorted(params_np)},"
                         f" the port expects {sorted(want)}")
    with torch.no_grad():
        model.embed = torch.nn.Parameter(
            take(("embed",), params_np["embed"], None), requires_grad=False)
        for li, layer in enumerate(model.layers):
            key, g = _layer_key(plan, li)
            tree = params_np["groups"][key] if g is not None else params_np[key]
            assign(layer, tree, g)
        assign(model.final_norm, params_np["final_norm"], None,
               ("final_norm",))
        if model.lm_head is not None:
            model.lm_head = torch.nn.Parameter(
                take(("lm_head",), params_np["lm_head"], None),
                requires_grad=False)
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


def _apply_layer(p: DenseLayer, x, cfg: ArchConfig, positions):
    acfg = _attn_cfg(cfg)
    h = L.apply_norm(p.ln1, x)
    q, k, v = L.attn_qkv(p.attn, h, acfg, positions)
    x = x + L.attn_out(p.attn, L.attention(q, k, v, causal=True))
    h = L.apply_norm(p.ln2, x)
    return x + L.mlp_block(p.mlp, h, cfg.act), k, v


@torch.no_grad()
def forward(model: CausalLM, tokens: torch.Tensor) -> torch.Tensor:
    """Parallel pass. tokens (B, S) → logits (B, S, V) bf16."""
    cfg = model.cfg
    x = _embed_tokens(model, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in model.layers:
        x, _k, _v = _apply_layer(layer, x, cfg, positions)
    return unembed(model, x)


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

def init_cache(model: CausalLM, batch: int, max_len: int) -> Dict[str, Any]:
    """Per layer a dense K and V (B, max_len, Hkv, hd) bf16, and ``pos``
    (B,) int32: the tokens held."""
    cfg = model.cfg
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    dev = model.device
    return {
        "layers": [{"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev),
                    "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=dev)}
                   for _ in model.layers],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _decode_attention(q, k, v, valid_mask):
    """q: (B,1,Hq,hd) bf16; k/v: (B,L,Hkv,hd) bf16; valid_mask: (B,L).

    Scores and the weighted sum take the bf16 operands with f32
    accumulation (the products of bf16 values are exact in f32); the
    probabilities are rounded to bf16 before the second product, as in
    the reference.  Returns (B,1,Hq,hd) f32."""
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = float(1.0 / np.sqrt(hd))
    qg = q.reshape(b, hkv, g, hd)
    s = torch.einsum("bhgd,blhd->bhgl", qg.to(torch.float32),
                     k.to(torch.float32))
    s = s * scale
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.tensor(L.NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,blhd->bhgd", p.to(v.dtype).to(torch.float32),
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


def _step_layer(p: DenseLayer, c: Dict, x, cfg: ArchConfig, pos):
    """One-token update of one layer, writing its K/V into ``c`` in place.
    x: (B,1,D); pos: (B,) int32."""
    b = x.shape[0]
    bidx = torch.arange(b, device=x.device)
    h = L.apply_norm(p.ln1, x)
    q, k, v = _step_attn_common(p.attn, h, cfg, pos)
    c["k"][bidx, pos.long()] = k[:, 0]
    c["v"][bidx, pos.long()] = v[:, 0]
    lpos = torch.arange(c["k"].shape[1], device=x.device)[None, :]
    valid = lpos <= pos[:, None]
    o = _decode_attention(q, c["k"], c["v"], valid)
    x = x + L.attn_out(p.attn, o.to(x.dtype))
    h = L.apply_norm(p.ln2, x)
    return x + L.mlp_block(p.mlp, h, cfg.act)


@torch.no_grad()
def decode_step(model: CausalLM, cache: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B,1,V), cache),
    the cache updated in place (pos + 1)."""
    cfg = model.cfg
    pos = cache["pos"]
    x = _embed_tokens(model, tokens)
    for layer, c in zip(model.layers, cache["layers"]):
        x = _step_layer(layer, c, x, cfg, pos)
    cache["pos"] = pos + 1
    return unembed(model, x), cache


# ---------------------------------------------------------------------------
# prefill: parallel pass that also fills the decode cache
# ---------------------------------------------------------------------------

def _prefill_layer(p: DenseLayer, c: Dict, x, cfg: ArchConfig, positions):
    x, k, v = _apply_layer(p, x, cfg, positions)
    s = k.shape[1]
    c["k"][:, :s] = k
    c["v"][:, :s] = v
    return x


@torch.no_grad()
def prefill(model: CausalLM, tokens: torch.Tensor, cache: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Parallel prefill of ``tokens`` (B, S); fills the cache in place and
    returns the last token's logits (B, 1, V) and the cache (pos = S)."""
    cfg = model.cfg
    b, s = tokens.shape
    x = _embed_tokens(model, tokens)
    positions = torch.arange(s, device=x.device)
    for layer, c in zip(model.layers, cache["layers"]):
        x = _prefill_layer(layer, c, x, cfg, positions)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return unembed(model, x[:, -1:]), cache
