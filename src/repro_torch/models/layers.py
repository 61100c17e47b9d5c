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

There is no ``ShardCtx``: the port runs on one card, where the
reference's sharding constraints are no-ops (and its MoE token groups
are one group).  The large products are ``torch.matmul``/``einsum``/
``bmm`` in bf16, as the reference leaves them to XLA; the prefill
attention is plain f32 tensor code, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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


def apply_norm(norm: Norm, x: torch.Tensor) -> torch.Tensor:
    if norm.norm_type == "rmsnorm":
        return rmsnorm(x, norm.scale)
    return layernorm(x, norm.scale, norm.bias)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (B, S, H, D) with D even; positions: (B, S) or (S,)."""
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
) -> torch.Tensor:
    """GQA attention in f32, in chunks of ``chunk`` query rows (the
    largest divisor of Sq not above it, as in the reference), so a long
    prefill never holds an Sq x T score matrix.  ``causal`` masks later
    keys; ``window`` also masks keys ``window`` or more positions back."""
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


def attn_qkv(p: Attention, x: torch.Tensor, cfg: AttnCfg, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))


def self_attention_block(p: Attention, x: torch.Tensor, cfg: AttnCfg,
                         positions, chunk: int = 512) -> torch.Tensor:
    q, k, v = attn_qkv(p, x, cfg, positions)
    o = attention(q, k, v, causal=cfg.causal, window=cfg.window,
                  chunk=chunk)
    return attn_out(p, o)


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


def mlp_block(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    h = x @ p.wi.to(dt)
    a = _act(act)
    if hasattr(p, "wg"):
        h = a(x @ p.wg.to(dt)) * h
    else:
        h = a(h)
    return h @ p.wd.to(dt)


# ---------------------------------------------------------------------------
# MoE (capacity-based, one token group)
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
    """ids (T, k) → each choice's row in the (E*capacity) expert buffer
    and whether it was kept, both (k*T,) slot-major: every token's first
    choice is placed before any token's second, so the later choices are
    the ones dropped at capacity.  A dropped choice's row is E*capacity,
    one past the buffer."""
    flat = ids.T.reshape(-1)  # (k*T,), slot-major
    onehot = torch.nn.functional.one_hot(flat, num_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = pos < capacity
    row = torch.where(keep, flat * capacity + pos,
                      torch.full_like(flat, num_experts * capacity))
    return row, keep


def moe_block(p: MoE, x: torch.Tensor, cfg: MoECfg, act: str):
    """x: (B, S, D) → ((B, S, D), aux); capacity-dropped choices add 0.

    The reference's semantics with an index dispatch in place of its
    one-hot einsums: softmax router in f32, top-k lower index first,
    weights renormalised, slot-major capacity drops, each kept choice's
    token copied into its expert's slot, the experts' gated MLPs as three
    ``bmm`` over the (E, C, D) buffer (every expert's weights read once),
    each token's k outputs weighted by the bf16-rounded weights and
    summed in f32 in slot order, the shared MLP on every token, and the
    GShard aux from the first choices."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    tokens = x.reshape(t, d)
    logits = (tokens @ p.router.to(dt)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = top_k_lower_first(probs, k)  # (T, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    cap = moe_capacity(t, cfg)
    row, keep = moe_dispatch(ids, e, cap)
    src = torch.arange(t, device=x.device).repeat(k)  # token of each choice
    buf = x.new_zeros((e * cap + 1, d))
    buf[row] = tokens[src]  # kept rows are distinct; the spare row is cut
    buf = buf[: e * cap].view(e, cap, d)

    a = _act(act)
    h = torch.bmm(buf, p.we_in.to(dt))
    h = a(torch.bmm(buf, p.we_gate.to(dt))) * h
    out = torch.bmm(h, p.we_out.to(dt)).view(e * cap, d)
    out = torch.cat([out, out.new_zeros((1, d))])  # the dropped choices' 0
    w = weights.T.to(dt).to(torch.float32)  # (k, T), as oh_e * w_s in bf16
    y = (w[..., None] * out[row].view(k, t, d).to(torch.float32)).sum(0)
    y = y.to(dt)
    if hasattr(p, "shared"):
        y = y + mlp_block(p.shared, tokens, act)

    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(ids[:, 0], e).to(torch.float32).mean(0)
    aux = (me * ce).sum() * e
    return y.reshape(b, s, d), aux
