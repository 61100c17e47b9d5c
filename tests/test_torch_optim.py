"""The port's optimiser (``repro_torch.optim``) and train state against
the JAX reference on the CPU.

The reference's ``tests/test_optim.py`` is ported first, case for case.
Then seeded numpy inputs go to both packages:

- ``compress_decompress_grads`` over 50 steps: q, the dequantised
  gradient and the carried error equal bit for bit (``torch.round``
  rounds half to even, as ``jnp.round``; every division is one f32
  division);
- ``adamw_update`` over six steps: parameters, m and v within
  ``ADAMW_RTOL`` = 1e-6 of each leaf's largest value (measured: 0 at
  these seeds; the bias corrections' f32 ``pow`` may differ by an ulp
  between XLA and PyTorch, which moves an update by about 1e-7 of it);
- ``clip_by_global_norm`` under and over the limit: the norm and the
  clipped leaves within ``NORM_RTOL`` = 1e-6 relative (measured 7.2e-8
  and 1.8e-7 over the limit, 0 under it: the two packages sum the
  squares in other orders);
- ``linear_warmup`` and ``cosine_schedule`` at every step of a
  1000-step schedule, from Python ints and from int32 tensors: within
  ``SCHEDULE_ATOL`` = 1e-6 (measured 6.0e-8: f32 ``cos`` differs by an
  ulp);
- ``init_train_state``'s keys, shapes and dtypes against the
  reference's ``abstract_train_state`` with ``bf16_params``, with
  ``compress_grads`` and with neither.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as J
from repro.launch import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import optim as T
from repro_torch.launch import steps as TS
from repro_torch.optim.compress import _q8
from repro_torch.tree import leaf_paths

ADAMW_RTOL = 1e-6
NORM_RTOL = 1e-6
SCHEDULE_ATOL = 1e-6


def _tree_np(tree):
    return dict(leaf_paths(jax.tree_util.tree_map(np.asarray, tree)))


def _tree_t(tree):
    return {k: v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in leaf_paths(tree)}


# -- the reference's tests/test_optim.py on the port -------------------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([4.0, -3.0], dtype=torch.float32)}
    state = T.adamw_init(params)
    cfg = T.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = T.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state["count"]) == 300
    assert state["count"].dtype == torch.int32


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 3.0), "b": torch.full((5,), 4.0)}
    clipped, norm = T.clip_by_global_norm(grads, 1.0)
    assert abs(float(T.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0
    # under the limit: untouched
    small = {"a": torch.full((4,), 1e-3)}
    out, _ = T.clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(out["a"].numpy(), small["a"].numpy(),
                               rtol=1e-6)


def test_schedules():
    assert float(T.linear_warmup(0, 10)) <= 0.11
    assert float(T.linear_warmup(100, 10)) == 1.0
    lr0 = float(T.cosine_schedule(0, 1000, warmup_steps=10))
    lr_mid = float(T.cosine_schedule(500, 1000, warmup_steps=10))
    lr_end = float(T.cosine_schedule(1000, 1000, warmup_steps=10))
    assert lr0 < lr_mid  # warming up
    assert lr_end <= lr_mid
    assert lr_end >= 0.09  # min_ratio floor


def test_error_feedback_compensates_quantization():
    """Accumulated EF-compressed grads converge to accumulated true
    grads (error feedback makes quantization unbiased over time)."""
    rng = np.random.default_rng(0)
    g_true = [{"w": torch.from_numpy(rng.normal(0, 1, (64,)).astype(
        np.float32))} for _ in range(50)]
    error = T.init_error_feedback(g_true[0])
    acc_c = torch.zeros((64,))
    acc_t = torch.zeros((64,))
    for g in g_true:
        gq, error = T.compress_decompress_grads(g, error)
        acc_c = acc_c + gq["w"]
        acc_t = acc_t + g["w"]
    # residual error is bounded by one step's quantization, not O(T)
    resid = float((acc_c - acc_t).abs().max())
    one_step_q = float(g_true[0]["w"].abs().max()) / 127 * 4
    assert resid < one_step_q * 2, resid


def test_bf16_param_state_roundtrip():
    cfg = tconfigs.smoke_config("phi3-mini-3.8b")
    hyper = TS.TrainHyper(bf16_params=True, num_microbatches=1)
    state = TS.init_train_state(0, cfg, hyper, device="cpu")
    # live params bf16, fp32 master in the optimizer
    leaf = state["params"]["groups"]["0_attn"]["attn"]["wq"]
    assert leaf.dtype == torch.bfloat16
    master = state["opt"]["master"]["groups"]["0_attn"]["attn"]["wq"]
    assert master.dtype == torch.float32
    assert torch.equal(master.to(torch.bfloat16), leaf)


# -- against the reference ---------------------------------------------------

def _grad_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((33,)) * scale * 1e-3).astype(
                np.float32),
                  "d": (rng.standard_normal((2, 3, 4)) * scale).astype(
                      np.float32)}}


def test_compress_decompress_matches_reference_bit_for_bit():
    """50 steps of seeded gradients (leaves of very different scales, a
    zero leaf, and planted exact halves of the quantisation step): q,
    the dequantised gradient and the error equal bit for bit."""
    rng = np.random.default_rng(11)
    grads = [_grad_tree(rng, scale=10.0 ** rng.integers(-4, 3))
             for _ in range(50)]
    grads[3]["b"]["c"][:] = 0.0
    grads[7]["a"][0, :] = np.array([127.0, 0.5, 1.5, 2.5, -2.5], np.float32)
    ej = jax.tree_util.tree_map(jnp.zeros_like, grads[0])
    et = T.init_error_feedback(jax.tree_util.tree_map(torch.from_numpy,
                                                      grads[0]))
    for g in grads:
        gj, ej = J.compress_decompress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), ej)
        gt, et_new = T.compress_decompress_grads(
            jax.tree_util.tree_map(torch.from_numpy, g), et)
        for key, a in _tree_np(gj).items():
            np.testing.assert_array_equal(_tree_t(gt)[key], a, key)
        for key, a in _tree_np(ej).items():
            np.testing.assert_array_equal(_tree_t(et_new)[key], a, key)
        # the int8 codes themselves
        for (key, x), e in zip(leaf_paths(g), leaf_paths(et)):
            xf = x + e[1].numpy()
            qj, sj = J.compress._q8(jnp.asarray(xf))
            qt, st = _q8(torch.from_numpy(xf))
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj), key)
            assert float(st) == float(sj), key
        et = et_new


def test_adamw_update_matches_reference_over_steps():
    rng = np.random.default_rng(3)
    params = _grad_tree(rng)
    cfg_j, cfg_t = J.AdamWConfig(lr=1e-2), T.AdamWConfig(lr=1e-2)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = jax.tree_util.tree_map(torch.from_numpy, params)
    sj, st = J.adamw_init(pj), T.adamw_init(pt)
    for i in range(6):
        g = _grad_tree(rng, scale=0.3)
        scale = float(np.float32(0.25 + 0.125 * i))
        pj, sj = J.adamw_update(pj, jax.tree_util.tree_map(jnp.asarray, g),
                                sj, cfg_j, jnp.float32(scale))
        pt, st = T.adamw_update(pt, jax.tree_util.tree_map(torch.from_numpy,
                                                           g),
                                st, cfg_t, torch.tensor(scale))
        for name, a, b in (("params", pj, pt), ("m", sj["m"], st["m"]),
                           ("v", sj["v"], st["v"])):
            tb = _tree_t(b)
            for key, x in _tree_np(a).items():
                np.testing.assert_allclose(
                    tb[key], x, rtol=0,
                    atol=ADAMW_RTOL * float(np.abs(x).max()),
                    err_msg=f"step {i} {name} {key}")
        assert int(st["count"]) == int(sj["count"]) == i + 1


@pytest.mark.parametrize("over", [False, True])
def test_clip_by_global_norm_matches_reference(over):
    g = _grad_tree(np.random.default_rng(5), scale=1.0 if over else 1e-3)
    cj, nj = J.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                   1.0)
    ct, nt = T.clip_by_global_norm(jax.tree_util.tree_map(torch.from_numpy,
                                                          g), 1.0)
    assert (float(nj) > 1.0) == over
    assert float(nt) == pytest.approx(float(nj), rel=NORM_RTOL)
    tc = _tree_t(ct)
    for key, x in _tree_np(cj).items():
        np.testing.assert_allclose(tc[key], x, rtol=NORM_RTOL, atol=0,
                                   err_msg=key)
    if not over:  # untouched
        for key, x in leaf_paths(g):
            np.testing.assert_array_equal(tc[key], x)


def test_schedules_match_reference_at_every_step():
    total, warm = 1000, 37
    steps = np.arange(total + 1)
    want_cos = np.array([float(J.cosine_schedule(s, total, warm))
                         for s in steps])
    want_warm = np.array([float(J.linear_warmup(s, warm)) for s in steps])
    got_cos = np.array([float(T.cosine_schedule(int(s), total, warm))
                        for s in steps])
    got_cos_t = np.array([float(T.cosine_schedule(
        torch.tensor(s, dtype=torch.int32), total, warm)) for s in steps])
    got_warm = np.array([float(T.linear_warmup(int(s), warm))
                         for s in steps])
    got_warm_t = np.array([float(T.linear_warmup(
        torch.tensor(s, dtype=torch.int32), warm)) for s in steps])
    for got in (got_cos, got_cos_t):
        np.testing.assert_allclose(got, want_cos, rtol=0, atol=SCHEDULE_ATOL)
    for got in (got_warm, got_warm_t):
        np.testing.assert_allclose(got, want_warm, rtol=0,
                                   atol=SCHEDULE_ATOL)
    assert T.cosine_schedule(torch.tensor(5), total, warm).dtype == \
        torch.float32


HYPERS = {
    "plain": dict(),
    "bf16_params": dict(bf16_params=True),
    "compress_grads": dict(compress_grads=True),
}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek_moe_16b",
                                  "whisper_large_v3"])
@pytest.mark.parametrize("hyper", list(HYPERS))
def test_init_train_state_has_reference_layout(arch, hyper):
    jcfg = jconfigs.smoke_config(arch)
    tcfg = tconfigs.smoke_config(arch)
    ref = JS.abstract_train_state(jcfg, JS.TrainHyper(**HYPERS[hyper]))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in leaf_paths(
        jax.tree_util.tree_map(lambda x: x, ref))}
    for device in ("meta", "cpu"):
        state = TS.init_train_state(0, tcfg, TS.TrainHyper(**HYPERS[hyper]),
                                    device=device)
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in leaf_paths(state)}
        assert got == want, device
        assert [k for k, _ in leaf_paths(state)] == list(want)

