"""Recurrent sequence mixers: RG-LRU (Griffin), mLSTM & sLSTM (xLSTM).

Port of ``repro.models.recurrent``.  The parallel (forward / prefill)
passes keep the reference's forms: a log-depth scan of the RG-LRU's
linear recurrence in f32 (the reference's associative scan, combined in
another order), the mLSTM's chunked stabilised gated-attention form with
``chunk=256``, and the sLSTM as a sequential loop (it is inherently
serial).  The decode paths are single-step state updates.  The modules
``RGLRU``, ``MLstm`` and ``SLstm`` hold the parameters (their
constructors take the place of ``init_rglru``, ``init_mlstm`` and
``init_slstm``): projections and conv weights in bf16, the values the
reference uses uncast in f32 (``rg_a`` and the sLSTM's ``r_*``) in f32.

Two limits of the reference are kept and raise here instead of
misbehaving: the mLSTM's parallel core needs S ≤ 256 or S % 256 == 0,
and a prefill's conv tail needs S ≥ conv_width − 1.

Each block takes a ``ShardCtx`` and lays out its activations where the
reference does (``ctx.cs``); the tensors it makes are made on the mesh
(``ctx.const``).  Without a mesh both are the identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    NO_MESH,
    gelu,
    resolve_device,
    sigmoid,
    silu,
    weight,
    zeros_f32,
)
from repro_torch.models.sharding import ShardCtx

RG_C = 8.0  # Griffin's fixed recurrence sharpness
F32 = torch.float32


def _conv_tail(u_raw: torch.Tensor, conv_width: int) -> torch.Tensor:
    """The last conv_width-1 pre-conv inputs: a prefill's conv state."""
    s = u_raw.shape[1]
    if s < conv_width - 1:
        raise ValueError(
            f"a prefill of {s} tokens is shorter than the conv state's"
            f" {conv_width - 1} (conv width {conv_width}): the reference's"
            " state slice [S-(W-1):] is wrong there")
    return u_raw[:, s - (conv_width - 1):]


# ---------------------------------------------------------------------------
# causal conv1d (width W, per-channel)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x: (B,S,D); w: (W,D); b: (D).  Accumulates in x's dtype, one
    rounding per product and per sum, as the reference's loop does."""
    width = w.shape[0]
    s = x.shape[1]
    pads = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pads[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def conv1d_step(state, x_t, w, b):
    """state: (B, W-1, D) previous inputs; x_t: (B, D).  The window's dot
    with w accumulates in f32 and rounds once, as a bf16 einsum does."""
    dt = x_t.dtype
    window = torch.cat([state, x_t[:, None]], dim=1)  # (B, W, D)
    out = (window.to(F32) * w.to(dt).to(F32)).sum(1).to(dt) + b.to(dt)
    return window[:, 1:], out


# ---------------------------------------------------------------------------
# RG-LRU (Griffin, arXiv:2402.19427)
# ---------------------------------------------------------------------------

class RGLRU(torch.nn.Module):
    """rg_in/rg_gate (D,W), rg_out (W,D), rg_gi/rg_gr (W,W), conv_w
    (cw,W) and conv_b (W,) in bf16; rg_a (W,) f32, Λ drawn so that a^c
    lies in about (0.9, 0.999)."""

    def __init__(self, d_model: int, width: int, conv_width: int = 4, *,
                 generator, device, dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.rg_in = weight((d_model, width), d_model, **kw)
        self.rg_gate = weight((d_model, width), d_model, **kw)
        self.rg_out = weight((width, d_model), width, **kw)
        self.rg_gi = weight((width, width), width, **kw)
        self.rg_gr = weight((width, width), width, **kw)
        rg_a = torch.empty((width,), dtype=F32, device=device)
        if rg_a.device.type != "meta":
            rg_a.uniform_(0.3, 0.8, generator=generator)
            rg_a = torch.log(torch.expm1(rg_a))
        self.rg_a = torch.nn.Parameter(rg_a, requires_grad=False)
        self.conv_w = weight((conv_width, width), conv_width, **kw)
        self.conv_b = torch.nn.Parameter(torch.zeros(
            (width,), dtype=dtype, device=device), requires_grad=False)


def _mm(ctx: ShardCtx, x, w, contract=None, out=None):
    """``x @ w``; on a mesh x's rows over the data axes, the contracted
    dim over ``contract`` and w's columns over ``out`` (``ShardCtx.mm``)."""
    return ctx.mm(x, w, (ctx.dp,) + (None,) * (x.dim() - 2) + (contract,),
                  (contract, out))


def _rg_gates(p: RGLRU, u, ctx: ShardCtx = NO_MESH):
    """u: (..., W) conv output → (a, gated_input) in f32."""
    dt = u.dtype
    r = sigmoid(_mm(ctx, u, p.rg_gr.to(dt))).to(F32)
    i = sigmoid(_mm(ctx, u, p.rg_gi.to(dt))).to(F32)
    softplus = torch.logaddexp(p.rg_a, torch.zeros_like(p.rg_a))
    a = torch.exp(-RG_C * softplus * r)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * u.to(F32)


def _linear_scan(a, b):
    """h_t = a_t h_(t-1) + b_t from h_(-1) = 0 along axis 1, in log2(S)
    rounds of the reference's combine (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_parallel(p: RGLRU, u):
    """u: (B,S,W) → (B,S,W) via the scan over S."""
    a, bterm = _rg_gates(p, u)
    return _linear_scan(a, bterm).to(u.dtype)


def rglru_step(p: RGLRU, state_h, u_t, ctx: ShardCtx = NO_MESH):
    """state_h: (B,W) f32; u_t: (B,W) → (new_h, out)."""
    a, bterm = _rg_gates(p, u_t, ctx)
    h = a * state_h + bterm
    return h, h.to(u_t.dtype)


def _rglru_seq(p: RGLRU, x, ctx: ShardCtx = NO_MESH):
    """(out (B,S,D), pre-conv u (B,S,W), f32 states (B,S,W))."""
    dt = x.dtype
    gate = gelu(_mm(ctx, x, p.rg_gate.to(dt), out="model"))
    u_raw = ctx.cs(_mm(ctx, x, p.rg_in.to(dt), out="model"), ctx.dp, None,
                   "model")
    u = causal_conv1d(u_raw, p.conv_w, p.conv_b)
    a, bterm = _rg_gates(p, u, ctx)
    h_seq = ctx.alike(_linear_scan, a, bterm)
    out = _mm(ctx, h_seq.to(dt) * gate, p.rg_out.to(dt), contract="model")
    return ctx.cs(out, ctx.dp, None, None), u_raw, h_seq


def rglru_block(p: RGLRU, x, ctx: ShardCtx = NO_MESH):
    """Griffin recurrent block: gate branch ∥ (conv → RG-LRU), out proj."""
    return _rglru_seq(p, x, ctx)[0]


def rglru_block_prefill(p: RGLRU, x, ctx: ShardCtx = NO_MESH):
    """Parallel block pass that also returns the decode state: the last
    conv_width-1 *pre-conv* inputs and the final f32 h."""
    out, u_raw, h_seq = _rglru_seq(p, x, ctx)
    state = {"conv": _conv_tail(u_raw, p.conv_w.shape[0]).to(x.dtype),
             "h": h_seq[:, -1]}
    return out, state


def rglru_block_step(p: RGLRU, state, x_t, ctx: ShardCtx = NO_MESH):
    """x_t: (B, D); state: {"conv": (B,W-1,Wd), "h": (B,Wd) f32}."""
    dt = x_t.dtype
    gate = gelu(_mm(ctx, x_t, p.rg_gate.to(dt), out="model"))
    u = _mm(ctx, x_t, p.rg_in.to(dt), out="model")
    conv_state, u = conv1d_step(state["conv"], u, p.conv_w, p.conv_b)
    h_f32, h = rglru_step(p, state["h"], u, ctx)
    out = _mm(ctx, h * gate, p.rg_out.to(dt), contract="model")
    return {"conv": conv_state, "h": h_f32}, ctx.cs(out, ctx.dp, None)


def rglru_init_state(batch: int, width: int, conv_width: int = 4,
                     dtype=COMPUTE_DTYPE, device="cuda"):
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, width), dtype=F32, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM, arXiv:2405.04517) — matrix memory, parallel form
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLstmCfg:
    d_model: int
    num_heads: int
    proj_factor: float = 2.0
    conv_width: int = 4

    @property
    def inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.inner // self.num_heads


class MLstm(torch.nn.Module):
    """lstm_up (D,2U), lstm_q/k/v (U,U), lstm_i/f (U,H), lstm_down (U,D),
    conv_w (cw,U) and conv_b (U,), all bf16."""

    def __init__(self, cfg: MLstmCfg, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        d, ud, h = cfg.d_model, cfg.inner, cfg.num_heads
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.lstm_up = weight((d, 2 * ud), d, **kw)
        self.lstm_q = weight((ud, ud), ud, **kw)
        self.lstm_k = weight((ud, ud), ud, **kw)
        self.lstm_v = weight((ud, ud), ud, **kw)
        self.lstm_i = weight((ud, h), ud, **kw)
        self.lstm_f = weight((ud, h), ud, **kw)
        self.lstm_down = weight((ud, d), ud, **kw)
        self.conv_w = weight((cfg.conv_width, ud), cfg.conv_width, **kw)
        self.conv_b = torch.nn.Parameter(torch.zeros(
            (ud,), dtype=dtype, device=device), requires_grad=False)


def _mlstm_parallel_core(q, k, v, i_raw, f_raw, chunk=256,
                         ctx: ShardCtx = NO_MESH):
    """q,k,v: (B,S,H,hd); i_raw,f_raw: (B,S,H). Returns (B,S,H,hd) in
    q's dtype, in chunks of ``chunk`` query rows.  On a mesh each data
    shard runs it on its own rows."""
    if ctx.mesh is not None:
        spec = (ctx.dp, None, None, None)
        return ctx.local_map(
            lambda *xs: (_mlstm_parallel_core(*xs, chunk=chunk),),
            (q, k, v, i_raw, f_raw), [spec] * 5,
            [ctx.placements(q.shape, spec)])[0]
    b, s, h, hd = q.shape
    if s > chunk and s % chunk:
        raise ValueError(
            f"the mLSTM's parallel pass takes S <= {chunk} or a multiple of"
            f" {chunk}, not S = {s} (as the reference)")
    scale = float(1.0 / np.sqrt(hd))
    logf = F.logsigmoid(f_raw.to(F32))  # (B,S,H)
    cumf = torch.cumsum(logf, dim=1)  # F_t
    i_f = i_raw.to(F32)
    kf, vf = k.to(F32), v.to(F32)
    t_pos = torch.arange(s, device=q.device)

    def block(qc, p0):
        c = qc.shape[1]
        fq = cumf[:, p0:p0 + c]  # (B,c,H)
        dmat = fq[:, :, None, :] - cumf[:, None, :, :] + i_f[:, None, :, :]
        mask = (p0 + torch.arange(c, device=q.device))[:, None] >= t_pos
        dmat = torch.where(mask[None, :, :, None], dmat,
                           torch.tensor(float("-inf"), device=q.device))
        m = torch.clamp(dmat.amax(dim=2, keepdim=True), min=-1e30)
        w = torch.exp(dmat - m)  # (B,c,S,H)
        scores = torch.einsum("bchd,bshd->bcsh", qc.to(F32), kf) * scale
        sw = scores * w
        n = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
        out = torch.einsum("bcsh,bshd->bchd", sw, vf)
        return (out / n[..., None]).to(q.dtype)

    if s <= chunk:
        return block(q, 0)
    return torch.cat([block(q[:, p0:p0 + chunk], p0)
                      for p0 in range(0, s, chunk)], dim=1)


def _head_mm(ctx: ShardCtx, heads: int):
    """``a @ w`` for the mLSTM's per-head projections: ``@`` without a
    mesh; on one, w's output columns over "model" only where the heads
    divide by it (the outputs are then split into heads), else
    replicated."""
    if ctx.mesh is None:
        return lambda a, w: a @ w
    ax = "model" if heads % ctx.axis_size("model") == 0 else None
    return lambda a, w: ctx.mm(a, w, (ctx.dp,) + (None,) * (a.dim() - 1),
                               (None, ax))


def _mlstm_seq(p: MLstm, x, cfg: MLstmCfg, ctx: ShardCtx = NO_MESH):
    """(out, pre-conv a, k, v, i_raw f32, f_raw f32) of the parallel pass."""
    dt = x.dtype
    b, s, _d = x.shape
    ud, h, hd = cfg.inner, cfg.num_heads, cfg.head_dim
    up = ctx.cs(_mm(ctx, x, p.lstm_up.to(dt)), ctx.dp, None,
                "model")  # (B,S,2*ud)
    proj = _head_mm(ctx, h)
    a_raw, gate = up[..., :ud], up[..., ud:]
    a = silu(causal_conv1d(a_raw, p.conv_w, p.conv_b))
    q = proj(a, p.lstm_q.to(dt)).reshape(b, s, h, hd)
    k = proj(a, p.lstm_k.to(dt)).reshape(b, s, h, hd)
    v = proj(a, p.lstm_v.to(dt)).reshape(b, s, h, hd)
    i_raw = proj(a, p.lstm_i.to(dt)).to(F32)  # (B,S,H)
    f_raw = proj(a, p.lstm_f.to(dt)).to(F32)
    o = _mlstm_parallel_core(q, k, v, i_raw, f_raw, ctx=ctx)
    o = ctx.cs(o.reshape(b, s, ud), ctx.dp, None, None)  # heads whole
    out = _mm(ctx, o * silu(gate), p.lstm_down.to(dt))
    return ctx.cs(out, ctx.dp, None, None), a_raw, k, v, i_raw, f_raw


def mlstm_block(p: MLstm, x, cfg: MLstmCfg, ctx: ShardCtx = NO_MESH):
    return _mlstm_seq(p, x, cfg, ctx)[0]


def mlstm_block_prefill(p: MLstm, x, cfg: MLstmCfg,
                        ctx: ShardCtx = NO_MESH):
    """Parallel block pass that also returns the decode state (C, n, m).

    The closed form of the stabilized recurrence after S steps:
      m_S = max_t (i_t + F_S − F_t),     F_t = Σ_{j≤t} log σ(f_j)
      C_S = Σ_t exp(i_t + F_S − F_t − m_S) · v_t k_tᵀ
      n_S = Σ_t exp(i_t + F_S − F_t − m_S) · k_t
    which matches unrolling mlstm_block_step.
    """
    out, a_raw, k, v, i_raw, f_raw = _mlstm_seq(p, x, cfg, ctx)
    conv = _conv_tail(a_raw, cfg.conv_width)
    c_s, n_s, m_s = ctx.per_shard(_mlstm_state, k, v, i_raw, f_raw)
    return out, {"conv": conv, "C": c_s, "n": n_s, "m": m_s}


def _mlstm_state(k, v, i_raw, f_raw):
    """The closed-form state (C, n, m) after S steps (rows independent)."""
    cumf = torch.cumsum(F.logsigmoid(f_raw), dim=1)
    w = i_raw + (cumf[:, -1:, :] - cumf)  # (B,S,H)
    m_s = w.amax(dim=1)  # (B,H)
    ew = torch.exp(w - m_s[:, None, :])  # (B,S,H)
    kf, vf = k.to(F32), v.to(F32)
    c_s = torch.einsum("bshv,bshk->bhvk", ew[..., None] * vf, kf)
    n_s = torch.einsum("bsh,bshk->bhk", ew, kf)
    return c_s, n_s, m_s


def mlstm_init_state(batch: int, cfg: MLstmCfg, dtype=COMPUTE_DTYPE,
                     device="cuda"):
    device = resolve_device(device)
    h, hd = cfg.num_heads, cfg.head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.inner),
                            dtype=dtype, device=device),
        "C": torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=F32, device=device),
    }


def _mlstm_cell(q, k, v, i_raw, f_raw, c, n, m):
    """One step of the stabilised matrix memory (rows independent):
    (C, n, m, the read-out (B,H,hd) f32)."""
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_s = torch.exp(i_raw - m_new)[..., None]  # (B,H,1)
    f_s = torch.exp(logf + m - m_new)[..., None]
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    c_new = f_s[..., None] * c + i_s[..., None] * (
        v[..., :, None] * k[..., None, :])  # (B,H,hd,hd) outer product v kᵀ
    n_new = f_s * n + i_s * k
    qs = q * scale
    num = torch.einsum("bhvk,bhk->bhv", c_new, qs)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qs).abs(),
                        torch.exp(-m_new))
    return c_new, n_new, m_new, num / den[..., None]


def mlstm_block_step(p: MLstm, state, x_t, cfg: MLstmCfg,
                     ctx: ShardCtx = NO_MESH):
    dt = x_t.dtype
    b = x_t.shape[0]
    ud, h, hd = cfg.inner, cfg.num_heads, cfg.head_dim
    up = _mm(ctx, x_t, p.lstm_up.to(dt))
    a, gate = up[..., :ud], up[..., ud:]
    conv_state, a = conv1d_step(state["conv"], a, p.conv_w, p.conv_b)
    a = silu(a)
    proj = _head_mm(ctx, h)
    q = proj(a, p.lstm_q.to(dt)).reshape(b, h, hd).to(F32)
    k = proj(a, p.lstm_k.to(dt)).reshape(b, h, hd).to(F32)
    v = proj(a, p.lstm_v.to(dt)).reshape(b, h, hd).to(F32)
    i_raw = proj(a, p.lstm_i.to(dt)).to(F32)  # (B,H)
    f_raw = proj(a, p.lstm_f.to(dt)).to(F32)
    c_new, n_new, m_new, o = ctx.per_shard(
        _mlstm_cell, q, k, v, i_raw, f_raw, state["C"], state["n"],
        state["m"])
    o = o.reshape(b, ud).to(dt)
    o = o * silu(gate)
    out = ctx.cs(_mm(ctx, o, p.lstm_down.to(dt)), ctx.dp, None)
    return {"conv": conv_state, "C": c_new, "n": n_new, "m": m_new}, out


# ---------------------------------------------------------------------------
# sLSTM — scalar memory, sequential
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLstmCfg:
    d_model: int
    num_heads: int
    proj_factor: float = 1.0

    @property
    def inner(self) -> int:
        return int(self.d_model * self.proj_factor)


class SLstm(torch.nn.Module):
    """lstm_z/i/f/o (D,U) and lstm_down (U,D) in bf16; the diagonal
    recurrent weights r_z/i/f/o (U,) in f32, zero at init."""

    def __init__(self, cfg: SLstmCfg, *, generator, device,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        d, ud = cfg.d_model, cfg.inner
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.lstm_z = weight((d, ud), d, **kw)
        self.lstm_i = weight((d, ud), d, **kw)
        self.lstm_f = weight((d, ud), d, **kw)
        self.lstm_o = weight((d, ud), d, **kw)
        self.r_z = zeros_f32(ud, device)
        self.r_i = zeros_f32(ud, device)
        self.r_f = zeros_f32(ud, device)
        self.r_o = zeros_f32(ud, device)
        self.lstm_down = weight((ud, d), ud, **kw)


def slstm_init_state(batch: int, cfg: SLstmCfg, device="cuda"):
    device = resolve_device(device)

    def z():
        return torch.zeros((batch, cfg.inner), dtype=F32, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, cfg.inner), -1e30, dtype=F32,
                            device=device)}


def _slstm_cell(p: SLstm, state, zx, ix, fx, ox):
    """One step; gate pre-activations from input already computed."""
    h_prev = state["h"]
    z = torch.tanh(zx + p.r_z * h_prev)
    i_raw = ix + p.r_i * h_prev
    f_raw = fx + p.r_f * h_prev
    o = sigmoid(ox + p.r_o * h_prev)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + state["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * z
    n = torch.clamp(f_s * state["n"] + i_s, min=1e-6)
    h = o * (c / n)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_gates(p: SLstm, x, ctx: ShardCtx = NO_MESH):
    dt = x.dtype
    return tuple(_mm(ctx, x, w.to(dt), out="model").to(F32)
                 for w in (p.lstm_z, p.lstm_i, p.lstm_f, p.lstm_o))


def slstm_block_prefill(p: SLstm, x, cfg: SLstmCfg,
                        ctx: ShardCtx = NO_MESH):
    """Sequential block pass that also returns the final decode state."""
    dt = x.dtype
    gates = _slstm_gates(p, x, ctx)
    if ctx.mesh is None:
        hs, state = _slstm_scan(p, *gates, cfg)
    else:  # the rows are independent: each data shard scans its own
        rows = (ctx.dp, None, None)
        keys = ("c", "n", "h", "m")

        def scan(zx, ix, fx, ox, *r):
            hs, state = _slstm_scan(SLstmRecurrent(*r), zx, ix, fx, ox, cfg)
            return (hs, *(state[k] for k in keys))

        b, s, u = gates[0].shape
        outs = ctx.local_map(
            scan, (*gates, p.r_z, p.r_i, p.r_f, p.r_o),
            [rows] * 4 + [(None,)] * 4,
            [ctx.placements((b, s, u), rows)]
            + [ctx.placements((b, u), rows)] * 4)
        hs, state = outs[0], dict(zip(keys, outs[1:]))
    h = hs.to(dt)  # (B,S,ud)
    return ctx.cs(_mm(ctx, h, p.lstm_down.to(dt)), ctx.dp, None,
                  None), state


@dataclasses.dataclass
class SLstmRecurrent:
    """The sLSTM's diagonal recurrent weights alone (``_slstm_cell``'s
    view of a layer, for a scan on local tensors)."""
    r_z: torch.Tensor
    r_i: torch.Tensor
    r_f: torch.Tensor
    r_o: torch.Tensor


def _slstm_scan(p, zx, ix, fx, ox, cfg: SLstmCfg):
    """The sequential sLSTM over S from the zero state: (h (B,S,ud) f32,
    the final state)."""
    state = slstm_init_state(zx.shape[0], cfg, device=zx.device)
    hs = []
    for t in range(zx.shape[1]):
        state = _slstm_cell(p, state, zx[:, t], ix[:, t], fx[:, t],
                            ox[:, t])
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def slstm_block(p: SLstm, x, cfg: SLstmCfg, ctx: ShardCtx = NO_MESH):
    """x: (B,S,D) → a sequential loop over S (inherently serial)."""
    return slstm_block_prefill(p, x, cfg, ctx)[0]


def slstm_block_step(p: SLstm, state, x_t, cfg: SLstmCfg,
                     ctx: ShardCtx = NO_MESH):
    dt = x_t.dtype
    gates = _slstm_gates(p, x_t, ctx)
    if ctx.mesh is None:
        new_state = _slstm_cell(p, state, *gates)
    else:  # rows independent: each data shard steps its own
        keys = ("c", "n", "h", "m")
        rows = (ctx.dp, None)

        def cell(*xs):
            st = _slstm_cell(SLstmRecurrent(*xs[8:]), dict(zip(keys, xs[:4])),
                             *xs[4:8])
            return tuple(st[k] for k in keys)

        lay = ctx.placements(gates[0].shape, rows)
        new_state = dict(zip(keys, ctx.local_map(
            cell, (*(state[k] for k in keys), *gates, p.r_z, p.r_i, p.r_f,
                   p.r_o), [rows] * 8 + [(None,)] * 4, [lay] * 4)))
    out = _mm(ctx, new_state["h"].to(dt), p.lstm_down.to(dt))
    return new_state, ctx.cs(out, ctx.dp, None)
