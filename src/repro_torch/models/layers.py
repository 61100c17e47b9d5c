"""Core transformer layers, in PyTorch.

Port of ``repro.models.layers``: norms, rotary embeddings, the q-chunked
f32 prefill attention (causal, bidirectional or windowed), the attention
projections, the (gated) MLP and the capacity-based MoE layer.  The
modules ``Norm``, ``Attention``, ``MLP`` and ``MoE`` hold the parameters
(their constructors take the place of ``init_norm``, ``init_attn``,
``init_mlp`` and ``init_moe``), and the functions take them where the
reference takes parameter dicts.  Weights are held in bf16 and norm
scales in f32, which gives the numbers of the reference's f32 masters
cast to bf16 at use (``.astype(dt)``).

Each block takes a ``ShardCtx`` (``models.sharding``).  Without a mesh
(``NO_MESH``, the default) it runs plain tensors and every ``ctx.cs`` is
the identity.  With one, the parameters and activations are DTensors:
``ctx.cs`` redistributes where the reference places
``with_sharding_constraint``, the products run with the layouts
``ctx.contract`` chooses, and the row-local work (attention per row and
head, norms, rope, the MoE's routing of each data shard's token groups)
runs on each device's own blocks.  The large products are
``torch.matmul``/``einsum``/``bmm`` in bf16, as the reference leaves
them to XLA; the prefill attention is plain f32 tensor code, as in the
reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.models.sharding import ShardCtx

NO_MESH = ShardCtx()
COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, in_axis_size=None, *, generator, device,
               dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in f32 on ``device`` and rounded to
    ``dtype`` once, as the reference's f32 master is cast at use.  On the
    meta device only the shape is made."""
    fan_in = in_axis_size or shape[0]
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(generator=generator)
    return (x * (1.0 / np.sqrt(fan_in))).to(dtype)


def weight(shape, fan_in, *, generator, device,
           dtype=COMPUTE_DTYPE) -> torch.nn.Parameter:
    """A projection drawn by ``dense_init``: bf16 for use, f32 for a
    trainer's masters (no grad until a trainer asks for it)."""
    return torch.nn.Parameter(dense_init(
        shape, fan_in, generator=generator, device=device, dtype=dtype),
        requires_grad=False)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without a card raises (no
    entry point falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the model runs on 'cuda' by default;"
            " pass device='cpu' to run on the CPU")
    return dev


def zeros_f32(n: int, device) -> torch.nn.Parameter:
    """An f32 norm scale or bias, zero at init (no grad until a trainer
    asks for it)."""
    return torch.nn.Parameter(
        torch.zeros(n, dtype=torch.float32, device=device),
        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * (1.0 + scale.to(torch.float32)) + bias.to(torch.float32)
    return out.to(x.dtype)


class Norm(torch.nn.Module):
    """An RMSNorm or LayerNorm's f32 parameters (zeros at init)."""

    def __init__(self, d: int, norm_type: str, *, device):
        super().__init__()
        self.norm_type = norm_type
        self.scale = zeros_f32(d, device)
        if norm_type != "rmsnorm":
            self.bias = zeros_f32(d, device)


def apply_norm(norm: Norm, x: torch.Tensor,
               ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    """The norm of each row of x (on a mesh, of each device's rows)."""
    if norm.norm_type == "rmsnorm":
        return ctx.rowwise(rmsnorm, x, norm.scale)
    return ctx.rowwise(layernorm, x, norm.scale, norm.bias)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
         ctx: ShardCtx = NO_MESH):
    """x: (B, S, H, D) with D even; positions: (B, S) or (S,).  On a mesh
    each device rotates its own block of x (positions laid out as x's
    leading dims)."""
    if ctx.mesh is not None:
        spec = ctx.spec_of(x)[: positions.dim()] if positions.dim() == 2 \
            else (ctx.spec_of(x)[1],)
        return ctx.rowwise(lambda x, pos: rope(x, pos, theta), x,
                           (positions, spec))
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (q-chunked; GQA; causal / window / cross) — the parallel pass
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, mask, scale):
    """q: (B,Sq,Hkv,G,D); k/v: (B,T,Hkv,D); mask: (B,Sq,T) bool."""
    s = torch.einsum("bqhgd,bthd->bhgqt", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(mask[:, None, None, :, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqt,bthd->bqhgd", p, v.to(torch.float32))


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # position of q[0] within the kv timeline
    chunk: int = 512,
    ctx: ShardCtx = NO_MESH,
) -> torch.Tensor:
    """GQA attention in f32, in chunks of ``chunk`` query rows (the
    largest divisor of Sq not above it, as in the reference), so a long
    prefill never holds an Sq x T score matrix.  ``causal`` masks later
    keys; ``window`` also masks keys ``window`` or more positions back.
    On a mesh each device runs it on its own block (``_attention_local``)."""
    if ctx.mesh is not None:
        return _attention_local(q, k, v, ctx, causal=causal, window=window,
                                q_offset=q_offset, chunk=chunk)
    b, sq, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(1.0 / np.sqrt(d))
    qg = q.reshape(b, sq, hkv, g, d)
    kv_pos = torch.arange(t, device=q.device)

    def mask_for(q_pos):
        m = torch.ones((b, q_pos.shape[0], t), dtype=torch.bool,
                       device=q.device)
        if causal:
            m &= kv_pos[None, None, :] <= q_pos[None, :, None]
        if window is not None:
            m &= kv_pos[None, None, :] > q_pos[None, :, None] - window
        return m

    if sq % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if sq % c == 0)
    out = torch.empty((b, sq, hkv, g, d), dtype=q.dtype, device=q.device)
    for s0 in range(0, sq, chunk):
        q_pos = q_offset + s0 + torch.arange(min(chunk, sq), device=q.device)
        out[:, s0:s0 + chunk] = _attn_block(
            qg[:, s0:s0 + chunk], k, v, mask_for(q_pos), scale).to(q.dtype)
    return out.reshape(b, sq, hq, d)


def heads_of(ctx: ShardCtx, hq: int, hkv: int, axis="model"):
    """(q's head axis, kv's head axis, the kv head of each local q head or
    None): the heads go over ``axis`` where their count divides by it;
    where only q's does, each device keeps every kv head and takes those
    of its own q heads."""
    m = ctx.axis_size(axis)
    q_ax = axis if m > 1 and hq % m == 0 else None
    kv_ax = axis if q_ax and hkv % m == 0 else None
    pick = None
    if q_ax and not kv_ax:
        n = hq // m
        first = ctx.coordinate(axis) * n
        pick = [(first + i) // (hq // hkv) for i in range(n)]
    return q_ax, kv_ax, pick


def _attention_local(q, k, v, ctx: ShardCtx, **kw):
    """Attention on a mesh.  Each (batch row, head) is independent, so
    every device runs the plain attention on its own rows (the data
    axes) and heads (``heads_of``); the output is laid out as q."""
    q_ax, kv_ax, pick = heads_of(ctx, q.shape[2], k.shape[2])
    q_spec = (ctx.dp, None, q_ax, None)
    kv_spec = (ctx.dp, None, kv_ax, None)

    def fn(q, k, v):
        if pick is not None:
            idx = torch.tensor(pick, device=k.device)
            k, v = k[:, :, idx], v[:, :, idx]
        return (attention(q, k, v, **kw),)

    return ctx.local_map(fn, (q, k, v), (q_spec, kv_spec, kv_spec),
                         [ctx.placements(q.shape, q_spec)])[0]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None
    causal: bool = True
    use_rope: bool = True
    norm_type: str = "rmsnorm"


class Attention(torch.nn.Module):
    """wq (D,H,hd), wk/wv (D,Hkv,hd), wo (H,hd,D) in bf16; q_norm/k_norm
    (hd,) f32 with qk-norm."""

    def __init__(self, cfg: AttnCfg, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        d, h, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = weight((d, h, hd), d, **kw)
        self.wk = weight((d, hkv, hd), d, **kw)
        self.wv = weight((d, hkv, hd), d, **kw)
        self.wo = weight((h, hd, d), h * hd, **kw)
        if cfg.qk_norm:
            self.q_norm = zeros_f32(hd, device)
            self.k_norm = zeros_f32(hd, device)


def head_proj(x, w, ctx: ShardCtx = NO_MESH, heads=None):
    """x (B, S, D) @ w (D, H, hd) → (B, S, H, hd): on a mesh the rows over
    the data axes, the heads over ``heads`` (w gathered over "data",
    FSDP)."""
    return ctx.contract("bsd,dhk->bshk", x, w.to(x.dtype),
                        (ctx.dp, None, None), (None, heads, None))


def qkv_proj(p: Attention, x, ctx: ShardCtx = NO_MESH):
    q_ax, kv_ax, _ = heads_of(ctx, p.wq.shape[1], p.wk.shape[1])
    return (head_proj(x, p.wq, ctx, q_ax), head_proj(x, p.wk, ctx, kv_ax),
            head_proj(x, p.wv, ctx, kv_ax))


def attn_qkv(p: Attention, x: torch.Tensor, cfg: AttnCfg, positions,
             ctx: ShardCtx = NO_MESH):
    # SP: gather the sequence-sharded residual to full S at block entry
    x = ctx.cs(x, ctx.dp, None, None)
    q, k, v = qkv_proj(p, x, ctx)
    q = ctx.cs(q, ctx.dp, None, "model", None)
    k = ctx.cs(k, ctx.dp, None, "model", None)
    v = ctx.cs(v, ctx.dp, None, "model", None)
    if cfg.qk_norm:
        q = ctx.rowwise(rmsnorm, q, p.q_norm)
        k = ctx.rowwise(rmsnorm, k, p.k_norm)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta, ctx)
        k = rope(k, positions, cfg.rope_theta, ctx)
    return q, k, v


# ``remat_policy="save_tp"`` keeps the outputs made inside this context
# (the reference's ``checkpoint_name(out, "tp_block_out")``)
_TP_BLOCK_OUT = [0]


@contextlib.contextmanager
def tp_block_out():
    _TP_BLOCK_OUT[0] += 1
    try:
        yield
    finally:
        _TP_BLOCK_OUT[0] -= 1


def in_tp_block_out() -> bool:
    return _TP_BLOCK_OUT[0] > 0


def attn_out(p: Attention, o: torch.Tensor,
             ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    q_ax = heads_of(ctx, p.wq.shape[1], p.wk.shape[1])[0]
    with tp_block_out():
        out = ctx.contract("bshk,hkd->bsd", o, p.wo.to(o.dtype),
                           (ctx.dp, None, q_ax, None), (q_ax, None, None))
    return ctx.cs(out, ctx.dp, ctx.act_seq, None)


def self_attention_block(p: Attention, x: torch.Tensor, cfg: AttnCfg,
                         positions, chunk: int = 512,
                         ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    q, k, v = attn_qkv(p, x, cfg, positions, ctx)
    o = attention(q, k, v, causal=cfg.causal, window=cfg.window,
                  chunk=chunk, ctx=ctx)
    return attn_out(p, o, ctx)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

# The activations follow jax.nn's definitions op by op in the input's
# dtype (constants rounded to it), so that a bf16 input is rounded after
# each op as the reference is; F.silu and F.gelu round once.

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    c = torch.tensor([0.044715, np.sqrt(2 / np.pi)], dtype=x.dtype).tolist()
    return x * (0.5 * (1 + torch.tanh(c[1] * (x + c[0] * x ** 3))))


def _act(name: str):
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu
    raise ValueError(f"unknown activation {name!r}")


class MLP(torch.nn.Module):
    """wi (D,F), wd (F,D) and, gated, wg (D,F), in bf16."""

    def __init__(self, d: int, f: int, gated: bool = True, *, generator,
                 device, dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wi = weight((d, f), d, **kw)
        self.wd = weight((f, d), f, **kw)
        if gated:
            self.wg = weight((d, f), d, **kw)


def mlp_block(p: MLP, x: torch.Tensor, act: str,
              ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    dt = x.dtype
    x = ctx.cs(x, ctx.dp, None, None)  # SP: full S inside the block
    rows = (ctx.dp, None, None)
    h = ctx.mm(x, p.wi.to(dt), rows, (None, "model"))
    h = ctx.cs(h, ctx.dp, None, "model")
    a = _act(act)
    if hasattr(p, "wg"):
        h = a(ctx.mm(x, p.wg.to(dt), rows, (None, "model"))) * h
    else:
        h = a(h)
    with tp_block_out():
        out = ctx.mm(h, p.wd.to(dt), (ctx.dp, None, "model"), ("model", None))
    return ctx.cs(out, ctx.dp, ctx.act_seq, None)


# ---------------------------------------------------------------------------
# MoE (capacity-based, token groups, EP over "model")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert hidden width
    num_shared: int = 0
    capacity_factor: float = 1.25


class MoE(torch.nn.Module):
    """router (D,E), we_in/we_gate (E,D,F), we_out (E,F,D) in bf16 and,
    with shared experts, a gated ``shared`` MLP of width num_shared*F."""

    def __init__(self, d: int, cfg: MoECfg, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        e, f = cfg.num_experts, cfg.d_expert
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.router = weight((d, e), d, **kw)
        self.we_in = weight((e, d, f), d, **kw)
        self.we_gate = weight((e, d, f), d, **kw)
        self.we_out = weight((e, f, d), f, **kw)
        if cfg.num_shared:
            self.shared = MLP(d, cfg.num_shared * f, True, **kw)


def moe_capacity(tokens: int, cfg: MoECfg) -> int:
    """Slots per expert: ceil(T*k/E*cf) rounded up to 8, at least 8."""
    cap = int(np.ceil(tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def top_k_lower_first(probs: torch.Tensor, k: int):
    """The k largest of the last axis, in descending order, equal values
    lower index first (``jax.lax.top_k``'s rule; ``torch.topk`` promises
    no order among ties).  Returns (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(ids: torch.Tensor, num_experts: int, capacity: int):
    """ids (..., T, k) → each choice's row in its group's (E*capacity)
    expert buffer and whether it was kept, both (..., k*T) slot-major:
    every token's first choice is placed before any token's second, so
    the later choices are the ones dropped at capacity.  A dropped
    choice's row is E*capacity, one past the buffer.  Leading dims are
    token groups, each counted on its own."""
    flat = ids.transpose(-1, -2).reshape(*ids.shape[:-2], -1)  # slot-major
    onehot = torch.nn.functional.one_hot(flat, num_experts)
    pos = (onehot.cumsum(-2) - 1).gather(-1, flat[..., None])[..., 0]
    keep = pos < capacity
    row = torch.where(keep, flat * capacity + pos,
                      torch.full_like(flat, num_experts * capacity))
    return row, keep


def _moe_route(tokens, probs, *, k: int, e: int, cap: int):
    """One data shard's groups: tokens (G, Tg, D), router probs (G, Tg, E)
    → (renormalised top-k weights (G, Tg, k), ids (G, Tg, k), rows
    (G, k*Tg), the expert buffers (G, E, cap, D)): each kept choice's
    token copied into its expert's slot of its group."""
    g, tg, d = tokens.shape
    weights, ids = top_k_lower_first(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    row, _keep = moe_dispatch(ids, e, cap)
    src = torch.arange(tg, device=tokens.device).repeat(k)  # token of each
    gi = torch.arange(g, device=tokens.device)[:, None]
    buf = tokens.new_zeros((g, e * cap + 1, d))
    buf[gi, row] = tokens[:, src]  # kept rows are distinct; spare row cut
    return weights, ids, row, buf[:, : e * cap].view(g, e, cap, d)


def _moe_experts(buf, we_in, we_gate, we_out, *, act):
    """Every expert's gated MLP over its slots of every group: buf (G, E,
    cap, D) → (G, E, cap, D), as three ``bmm`` over (E, G*cap, D)."""
    g, e, cap, d = buf.shape
    bufe = buf.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    h = torch.bmm(bufe, we_in)
    h = act(torch.bmm(bufe, we_gate)) * h
    return torch.bmm(h, we_out).reshape(e, g, cap, d).permute(1, 0, 2, 3)


def _moe_combine(out, weights, row, *, k: int):
    """One data shard's groups: expert outputs (G, E, cap, D), weights
    (G, Tg, k), rows (G, k*Tg) → (G, Tg, D): each token's k outputs
    weighted by the bf16-rounded weights and summed in f32 in slot order;
    a dropped choice adds 0."""
    g, e, cap, d = out.shape
    tg = weights.shape[1]
    dt = out.dtype
    flat = torch.cat([out.reshape(g, e * cap, d), out.new_zeros((g, 1, d))],
                     dim=1)
    gi = torch.arange(g, device=out.device)[:, None]
    o = flat[gi, row].view(g, k, tg, d)
    w = weights.transpose(1, 2).to(dt).to(torch.float32)  # as oh_e * w_s
    return ((w[..., None] * o.to(torch.float32)).sum(1).to(dt),)


def moe_block(p: MoE, x: torch.Tensor, cfg: MoECfg, act: str,
              ctx: ShardCtx = NO_MESH):
    """x: (B, S, D) → ((B, S, D), aux); capacity-dropped choices add 0.

    The reference's semantics with an index dispatch in place of its
    one-hot einsums: tokens in G groups (G = the data-parallel world when
    it divides the tokens, else 1; GShard's local groups), softmax router
    in f32, top-k lower index first, weights renormalised, slot-major
    capacity drops per group, each kept choice's token copied into its
    expert's slot, the experts' gated MLPs as three ``bmm`` over the
    (E, G*C, D) buffer (every expert's weights read once), each token's k
    outputs weighted by the bf16-rounded weights and summed in f32 in
    slot order, the shared MLP on every token, and the GShard aux from
    the first choices.  The shared MLP takes the (G, Tg, D) tokens as
    they are laid out (the reference flattens them to one batch row,
    which its constraint then replicates on every chip).  On a mesh the
    routing and the combine run on each data shard's own groups
    (``ShardCtx.per_shard``) and the buffer is laid out with its experts
    over "model"."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    n_groups = ctx.dp_size if t % max(ctx.dp_size, 1) == 0 else 1
    tg = t // n_groups
    x = ctx.cs(x, ctx.dp, None, None)  # the reshapes keep dim 0 over dp
    tokens = ctx.cs(x.reshape(n_groups, tg, d), ctx.dp, None, None)
    logits = ctx.mm(tokens, p.router.to(dt), (ctx.dp, None, None),
                    (None, None)).to(torch.float32)
    probs = torch.softmax(ctx.cs(logits, ctx.dp, None, None), dim=-1)
    cap = moe_capacity(tg, cfg)
    weights, ids, row, buf = ctx.per_shard(
        functools.partial(_moe_route, k=k, e=e, cap=cap), tokens, probs)
    buf = ctx.cs(buf, ctx.dp, "model", None, None)  # EP over "model"

    experts = functools.partial(_moe_experts, act=_act(act))
    ws = (p.we_in.to(dt), p.we_gate.to(dt), p.we_out.to(dt))
    lay = (ctx.dp, "model", None, None)
    out, = ctx.local_map(lambda *xs: (experts(*xs),), (buf, *ws),
                         (lay,) + (("model", None, None),) * 3,
                         [ctx.placements(buf.shape, lay)])
    out = ctx.cs(out, ctx.dp, "model", None, None)
    y, = ctx.per_shard(functools.partial(_moe_combine, k=k), out, weights,
                       row)
    y = ctx.cs(y, ctx.dp, None, None)
    if hasattr(p, "shared"):  # on the grouped tokens, laid out as they are
        y = y + mlp_block(p.shared, tokens, act, ctx)

    # aux load balancing (GShard): fraction per expert × mean prob
    me = probs.reshape(t, e).mean(0)
    first = ids[..., 0].reshape(t)
    experts = ctx.const(torch.arange(e, device=first.device))
    ce = (first[:, None] == experts).to(torch.float32).mean(0)
    aux = (me * ce).sum() * e
    return ctx.cs(y.reshape(b, s, d), ctx.dp, None, None), aux
