"""The port's recurrent mixers and MoE layer against the JAX reference.

Unit cases on seeded numpy inputs and parameters fed to both packages
(parameters rounded to bf16 first where the port stores bf16, so both
hold the same numbers; the conv biases and the sLSTM's recurrent weights
non-zero): the causal conv and its step, the RG-LRU (gates, scan,
block, prefill state, step), the mLSTM (chunked parallel core, block,
closed-form prefill state, step, initial state), the sLSTM (block,
prefill, step), and ``moe_block`` (capacity, slot-major drops, the
lower-index-first rule among router ties, the shared expert, the aux).
The reference runs op by op, which rounds every bf16 value it declares.
Tolerances: bf16 outputs within 2 bf16 ulps of the reference's largest
value, f32 within 2e-5 relative to it (a scan combined in another order,
f32 sums over another blocking; 1e-4 for the mLSTM's chunked core, whose
normaliser can nearly cancel), integer results and routing exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models.sharding import ShardCtx
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR

torch.set_num_threads(1)

CTX = ShardCtx(None)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _bf16(a):
    """numpy f32 values rounded to bf16 (as the port stores them)."""
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float(
    ).numpy()


def _load(module, tree):
    """Copy a numpy tree (the reference's layout) into a port module."""
    mt = TM._module_tree(module)

    def walk(t, r):
        for k, v in r.items():
            if isinstance(v, dict):
                walk(t[k], v)
            else:
                with torch.no_grad():
                    t[k].copy_(torch.from_numpy(np.array(v, np.float32)))

    walk(mt, tree)
    return module


def _meta(cls, *args):
    return cls(*args, generator=None, device="meta").to_empty(device="cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _x(shape, dtype, seed=1, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    _, jdt, tdt = DTYPES[dtype]
    xt = torch.from_numpy(a).to(tdt)
    return jnp.asarray(xt.float().numpy()).astype(jdt), xt


def _close(got, want, dtype, rel=2e-5):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    top = max(float(np.abs(want).max()), 1e-30)
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == "bf16" \
        else rel * top
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _rglru(seed=0, d=32, w=24):
    p = jax.tree_util.tree_map(np.asarray, JR.init_rglru(
        jax.random.key(seed), d, w))
    rng = np.random.default_rng(seed + 10)
    p["conv_b"] = rng.standard_normal(w).astype(np.float32) * 0.1
    p = {k: (v if k == "rg_a" else _bf16(v)) for k, v in p.items()}
    return p, _load(_meta(TR.RGLRU, d, w), p)


def _mlstm(seed=0, d=32, heads=2):
    cfg_j, cfg_t = JR.MLstmCfg(d, heads), TR.MLstmCfg(d, heads)
    p = jax.tree_util.tree_map(np.asarray, JR.init_mlstm(
        jax.random.key(seed), cfg_j))
    p["conv_b"] = np.random.default_rng(seed + 10).standard_normal(
        cfg_t.inner).astype(np.float32) * 0.1
    p = {k: _bf16(v) for k, v in p.items()}
    return cfg_j, cfg_t, p, _load(_meta(TR.MLstm, cfg_t), p)


def _slstm(seed=0, d=32, heads=2):
    cfg_j, cfg_t = JR.SLstmCfg(d, heads), TR.SLstmCfg(d, heads)
    p = jax.tree_util.tree_map(np.asarray, JR.init_slstm(
        jax.random.key(seed), cfg_j))
    rng = np.random.default_rng(seed + 10)
    for k in ("r_z", "r_i", "r_f", "r_o"):
        p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.5
    p = {k: (v if k.startswith("r_") else _bf16(v)) for k, v in p.items()}
    return cfg_j, cfg_t, p, _load(_meta(TR.SLstm, cfg_t), p)


def _state_close(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], "bf16" if got[k].dtype == torch.bfloat16
               else "f32")


# -- causal conv -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_matches_reference(dtype):
    xj, xt = _x((2, 11, 24), dtype)
    w = _bf16(np.random.default_rng(2).standard_normal((4, 24)) * 0.5)
    b = _bf16(np.random.default_rng(3).standard_normal(24) * 0.1)
    want = JR.causal_conv1d(xj, jnp.asarray(w), jnp.asarray(b))
    got = TR.causal_conv1d(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_step_matches_reference(dtype):
    sj, st = _x((2, 3, 24), dtype, seed=4)
    xj, xt = _x((2, 24), dtype, seed=5)
    w = _bf16(np.random.default_rng(2).standard_normal((4, 24)) * 0.5)
    b = _bf16(np.random.default_rng(3).standard_normal(24) * 0.1)
    wj, oj = JR.conv1d_step(sj, xj, jnp.asarray(w), jnp.asarray(b))
    wt, ot = TR.conv1d_step(st, xt, torch.from_numpy(w), torch.from_numpy(b))
    _close(wt, wj, dtype)
    _close(ot, oj, dtype)


def test_conv_tail_needs_conv_width_minus_one_tokens():
    _, mod = _rglru()
    _, xt = _x((1, 2, 32), "bf16")
    with pytest.raises(ValueError, match="conv state"):
        TR.rglru_block_prefill(mod, xt)
    out = TR.rglru_block(mod, xt)  # the forward has no such limit
    assert out.shape == (1, 2, 32)


# -- RG-LRU ------------------------------------------------------------------

def test_linear_scan_is_the_sequential_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)).astype(np.float32))
    h = torch.zeros(2, 5)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(TR._linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_gates_and_scan_match_reference(dtype):
    p, mod = _rglru()
    uj, ut = _x((2, 13, 24), dtype)
    aj, bj = JR._rg_gates(_j(p), uj)
    at, bt = TR._rg_gates(mod, ut)
    _close(at, aj, "f32")
    _close(bt, bj, "f32")
    _close(TR.rglru_parallel(mod, ut), JR.rglru_parallel(_j(p), uj), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_and_prefill_state_match_reference(dtype):
    p, mod = _rglru()
    xj, xt = _x((2, 13, 32), dtype)
    _close(TR.rglru_block(mod, xt), JR.rglru_block(_j(p), xj, CTX), dtype)
    oj, sj = JR.rglru_block_prefill(_j(p), xj, CTX)
    ot, st = TR.rglru_block_prefill(mod, xt)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == xt.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_step_matches_reference(dtype):
    p, mod = _rglru()
    xj, xt = _x((2, 32), dtype)
    hj, ht = _x((2, 24), "f32", seed=7)
    cj, ct = _x((2, 3, 24), dtype, seed=8)
    sj, oj = JR.rglru_block_step(_j(p), {"conv": cj, "h": hj}, xj, CTX)
    st, ot = TR.rglru_block_step(mod, {"conv": ct, "h": ht}, xt)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)


def test_rglru_prefill_state_matches_step_chain():
    """The scan's final state and conv tail equal unrolling the step."""
    p, mod = _rglru()
    _, xt = _x((2, 12, 32), "f32")
    _, state_par = TR.rglru_block_prefill(mod, xt)
    state = TR.rglru_init_state(2, 24, dtype=torch.float32,
                                 device="cpu")
    for t in range(12):
        state, _ = TR.rglru_block_step(mod, state, xt[:, t])
    np.testing.assert_allclose(state_par["h"].numpy(), state["h"].numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(state_par["conv"].numpy(),
                                  state["conv"].numpy())


def test_rglru_init_state_matches_reference():
    sj = JR.rglru_init_state(3, 24)
    st = TR.rglru_init_state(3, 24, device="cpu")
    for k in sj:
        assert tuple(st[k].shape) == sj[k].shape
        assert str(st[k].dtype).split(".")[-1] == str(sj[k].dtype)
        assert not st[k].any()


# -- mLSTM -------------------------------------------------------------------

@pytest.mark.parametrize("s", [12, 256, 512])
def test_mlstm_parallel_core_matches_reference(s):
    """One block up to 256 rows, chunks of 256 beyond (S = 512)."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, s, 2, 8)).astype(np.float32)
               for _ in range(3))
    i_raw, f_raw = (rng.standard_normal((1, s, 2)).astype(np.float32)
                    for _ in range(2))
    want = JR._mlstm_parallel_core(*map(jnp.asarray, (q, k, v, i_raw,
                                                      f_raw)))
    got = TR._mlstm_parallel_core(*map(torch.from_numpy, (q, k, v, i_raw,
                                                          f_raw)))
    # the normaliser divides by a sum that can nearly cancel: 2.6e-5 of
    # the largest value measured at S = 512 (4.8e-5 at 1024)
    _close(got, want, "f32", rel=1e-4)


def test_mlstm_parallel_core_raises_off_the_chunk_grid():
    x = torch.zeros((1, 300, 2, 8))
    i = torch.zeros((1, 300, 2))
    with pytest.raises(ValueError, match="multiple of 256"):
        TR._mlstm_parallel_core(x, x, x, i, i)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_block_and_prefill_state_match_reference(dtype):
    cfg_j, cfg_t, p, mod = _mlstm()
    xj, xt = _x((2, 12, 32), dtype)
    _close(TR.mlstm_block(mod, xt, cfg_t),
           JR.mlstm_block(_j(p), xj, cfg_j, CTX), dtype)
    oj, sj = JR.mlstm_block_prefill(_j(p), xj, cfg_j, CTX)
    ot, st = TR.mlstm_block_prefill(mod, xt, cfg_t)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_step_matches_reference(dtype):
    cfg_j, cfg_t, p, mod = _mlstm()
    xj, xt = _x((2, 12, 32), dtype)
    _, sj = JR.mlstm_block_prefill(_j(p), xj, cfg_j, CTX)
    _, st = TR.mlstm_block_prefill(mod, xt, cfg_t)
    yj, yt = _x((2, 32), dtype, seed=9)
    sj, oj = JR.mlstm_block_step(_j(p), sj, yj, cfg_j, CTX)
    st, ot = TR.mlstm_block_step(mod, st, yt, cfg_t)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)


def test_mlstm_prefill_state_matches_step_chain():
    """Closed-form prefill state == unrolled single-step recurrence (the
    reference's test, on the port)."""
    _, cfg, _, mod = _mlstm()
    _, x = _x((2, 12, 32), "f32")
    _, state_par = TR.mlstm_block_prefill(mod, x, cfg)
    state_seq = TR.mlstm_init_state(2, cfg, dtype=torch.float32,
                                     device="cpu")
    for t in range(12):
        state_seq, _ = TR.mlstm_block_step(mod, state_seq, x[:, t], cfg)
    np.testing.assert_allclose(state_par["C"].numpy(),
                               state_seq["C"].numpy(), atol=1e-4)
    np.testing.assert_allclose(state_par["m"].numpy(),
                               state_seq["m"].numpy(), atol=1e-5)


def test_mlstm_init_state_matches_reference():
    cfg_j, cfg_t = JR.MLstmCfg(32, 2), TR.MLstmCfg(32, 2)
    sj = JR.mlstm_init_state(3, cfg_j)
    st = TR.mlstm_init_state(3, cfg_t, device="cpu")
    for k in sj:
        assert tuple(st[k].shape) == sj[k].shape
        np.testing.assert_array_equal(st[k].float().numpy(),
                                      np.asarray(sj[k], np.float32))
    assert float(st["m"][0, 0]) == float(np.float32(-1e30))
    assert (cfg_t.inner, cfg_t.head_dim) == (cfg_j.inner, cfg_j.head_dim)


# -- sLSTM -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block_prefill_and_step_match_reference(dtype):
    cfg_j, cfg_t, p, mod = _slstm()
    xj, xt = _x((2, 12, 32), dtype)
    _close(TR.slstm_block(mod, xt, cfg_t),
           JR.slstm_block(_j(p), xj, cfg_j, CTX), dtype)
    oj, sj = JR.slstm_block_prefill(_j(p), xj, cfg_j, CTX)
    ot, st = TR.slstm_block_prefill(mod, xt, cfg_t)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)
    yj, yt = _x((2, 32), dtype, seed=9)
    sj, oj = JR.slstm_block_step(_j(p), sj, yj, cfg_j, CTX)
    st, ot = TR.slstm_block_step(mod, st, yt, cfg_t)
    _close(ot, oj, dtype)
    _state_close(st, sj, dtype)


def test_slstm_recurrent_weights_stay_f32_and_count():
    """r_* are read in f32 (the reference does not cast them); with them
    zeroed the output moves, so the test above exercises them."""
    _, cfg, p, mod = _slstm()
    assert all(getattr(mod, k).dtype == torch.float32
               for k in ("r_z", "r_i", "r_f", "r_o"))
    _, xt = _x((2, 12, 32), "f32")
    out = TR.slstm_block(mod, xt, cfg)
    with torch.no_grad():
        for k in ("r_z", "r_i", "r_f", "r_o"):
            getattr(mod, k).zero_()
    assert float((TR.slstm_block(mod, xt, cfg) - out).abs().max()) > 1e-2
    sj = JR.slstm_init_state(3, JR.SLstmCfg(32, 2))
    st = TR.slstm_init_state(3, cfg, device="cpu")
    for k in sj:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))


# -- MoE ---------------------------------------------------------------------

def _moe(e=4, k=2, f=16, shared=1, cf=1.25, d=32, seed=0, tie=()):
    cfg_j = JL.MoECfg(e, k, f, shared, cf)
    cfg_t = TL.MoECfg(e, k, f, shared, cf)
    p = jax.tree_util.tree_map(np.array, JL.init_moe(
        jax.random.key(seed), d, cfg_j))
    for a, b in tie:  # planted ties: identical router columns
        p["router"][:, b] = p["router"][:, a]
    p = jax.tree_util.tree_map(_bf16, p)
    return cfg_j, cfg_t, p, _load(_meta(TL.MoE, d, cfg_t), p)


@pytest.mark.parametrize("t,k,e,cf", [(48, 2, 4, 1.25), (4, 6, 64, 1.25),
                                      (512, 6, 64, 1.25), (576, 1, 16, 8.0),
                                      (3, 1, 16, 0.1), (1000, 2, 7, 1.0)])
def test_moe_capacity_is_the_references(t, k, e, cf):
    cap = int(np.ceil(t * k / e * cf))
    want = max(8, -(-cap // 8) * 8)
    assert TL.moe_capacity(t, TL.MoECfg(e, k, 8, 0, cf)) == want


def test_top_k_picks_the_lower_index_among_ties():
    rng = np.random.default_rng(0)
    probs = (np.round(rng.random((500, 16)) * 4) / 4).astype(np.float32)
    for k in (1, 2, 6):
        vals, ids = TL.top_k_lower_first(torch.from_numpy(probs), k)
        want = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
        np.testing.assert_array_equal(ids.numpy(), want)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_dispatch_is_slot_major():
    """Every token's first choice is placed before any second choice: a
    capacity that holds each expert's first choices drops only second
    choices, where a token-major order would drop first ones."""
    ids = torch.tensor([[0, 1]] * 10 + [[1, 0]] * 6)  # (T=16, k=2)
    row, keep = TL.moe_dispatch(ids, 2, 10)
    keep = keep.view(2, 16)
    assert keep[0].all()  # every first choice fits
    # 32 choices for 20 slots: the 12 dropped are all second choices
    assert int((~keep[1]).sum()) == 12
    pos = row.view(2, 16)
    assert (pos[~keep.view(2, 16)] == 20).all()  # the spare row
    np.testing.assert_array_equal(pos[0, :10].numpy(), np.arange(10))
    # a token-major order would have kept only 10 of the first choices
    flat_tm = ids.reshape(-1)
    pos_tm = (torch.nn.functional.one_hot(flat_tm, 2).cumsum(0) - 1).gather(
        1, flat_tm[:, None])[:, 0].view(16, 2)
    assert not (pos_tm[:, 0] < 10).all()


MOE_CASES = {
    "no drops": dict(cf=8.0),
    "drops at capacity": dict(cf=0.25),
    "planted router ties": dict(tie=((0, 1), (2, 3)), cf=0.5),
    "top-1, no shared expert": dict(k=1, shared=0, e=16, cf=1.0),
    "64 experts top-6": dict(e=64, k=6, cf=1.25, f=8),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(case):
    cfg_j, cfg_t, p, mod = _moe(**MOE_CASES[case])
    xj, xt = _x((4, 16, 32), "bf16", seed=3)
    yj, auxj = JL.moe_block(_j(p), xj, cfg_j, "silu", CTX)
    kept = []
    real = TL.moe_dispatch

    def spy(ids, e, cap):
        row, keep = real(ids, e, cap)
        kept.append((ids, keep))
        return row, keep

    TL.moe_dispatch = spy
    try:
        yt, auxt = TL.moe_block(mod, xt, cfg_t, "silu")
    finally:
        TL.moe_dispatch = real
    _close(yt, yj, "bf16")
    assert abs(float(auxt) - float(auxj)) < 1e-6
    ids, keep = kept[0]
    if case == "drops at capacity":
        assert not keep.all()
    if case == "no drops":
        assert keep.all()
    if case == "planted router ties":
        # the twin columns give equal probabilities, so experts 0 and 1
        # (and 2 and 3) are chosen together and the lower one first
        both = (ids == 0).any(-1) & (ids == 1).any(-1)
        assert both.any()
        first = ids[both]
        assert (first[:, 0] < first[:, 1]).all()


def test_moe_router_ties_decide_the_output():
    """Breaking the planted ties the other way (higher index first) moves
    the output, so the reference comparison above pins the rule."""
    cfg_j, cfg_t, p, mod = _moe(k=1, shared=0, tie=((0, 1), (2, 3)), cf=8.0)
    _, xt = _x((4, 16, 32), "bf16", seed=3)
    y, _ = TL.moe_block(mod, xt, cfg_t, "silu")
    real = TL.top_k_lower_first

    def higher_first(probs, k):
        vals, idx = real(probs.flip(-1), k)
        return vals, probs.shape[-1] - 1 - idx

    TL.top_k_lower_first = higher_first
    try:
        y_other, _ = TL.moe_block(mod, xt, cfg_t, "silu")
    finally:
        TL.top_k_lower_first = real
    assert float((y - y_other).abs().max()) > 1e-2
