"""The port's LM against the JAX reference on the CPU, all ten archs.

The configs are copies and must equal the reference's field by field.
The reference's weights are carried across by ``from_reference_params``
after the leaves it initialises to zero (the cross-attention gates, the
sLSTM's recurrent weights, the conv biases) and the norm parameters get
seeded non-zero values in the numpy tree both packages are fed, so the
cross-attention, the recurrences and the norms all count.  For each
smoke config: ``forward``'s logits and MoE aux, ``prefill``'s logits
and every cache tensor (dense K/V, the local ring and its ``pos_abs``,
cross-KV, the RG-LRU, mLSTM and sLSTM states), and two ``decode_step``s
with the cache after them, against the reference's; and the int8 KV
view the same way.

The reference runs compiled with XLA's excess precision off
(``_strict``): every value it declares bf16 is then rounded to bf16, as
in its op-by-op evaluation.  XLA's CPU default keeps some of those in
f32 inside fusions, which moves the reference's own scanned forward away
from its op-by-op evaluation of the same layers by up to 0.92 (xlstm
smoke logits) and 0.45 (deepseek, a router flip); the port rounds where
the reference's code does.  Tolerances, measured at these seeds (the
largest over the ten archs) times a margin, all under the reference's
own bf16 parity tolerance of 0.35: logits 0.06 (0.043 measured,
llama-3.2-vision's forward), bf16 K/V, cross-KV and conv states 0.05
(one bf16 ulp at 2–4, 0.0312), f32 recurrent states 1e-4 (3.1e-5), the
MoE aux 1e-5 (7.2e-6), int8 K/V within one step and their bf16 scales
within one ulp, ring positions exact.

The gradient half of the reference's ``test_forward_and_grad``:
``loss_fn`` and its gradient with respect to every f32 master leaf
(``torch.autograd`` through ``bind_reference``'s casts) against
``jax.value_and_grad(loss_fn)`` under ``_strict``, the carried weights,
seeded labels with some masked: the loss within ``LOSS_TOL`` = 2e-3
(6.1e-4 measured, whisper), each gradient leaf within ``GRAD_RTOL`` =
0.05 of its largest value plus ``GRAD_ATOL`` = 2e-3 (measured 0.031,
recurrentgemma's ``rg_gr``, and 8.0e-4 absolute on llama-3.2-vision's
``mgate``, a scalar whose gradient, 1.4e-3, is a sum of B·S·D bf16
products that cancel).

The reference's ``tests/test_models.py`` is ported below (its
prefill/decode parity on the port's own weights, the MoE capacity lift,
the MoE specs, the published dimensions, the long-context shapes, the
int8 view's parity).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.sharding import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaf_paths, leaves, tree_map

torch.set_num_threads(1)

CTX = ShardCtx(None)
ARCHS = jconfigs.ARCH_IDS
DENSE = ("phi3-mini-3.8b", "qwen3-32b", "minitron-4b")
MOE = ("deepseek_moe_16b", "llama4_scout_17b_a16e")
NOT_DENSE = ("recurrentgemma_2b", "deepseek_moe_16b", "llama4_scout_17b_a16e",
             "llama_3_2_vision_11b", "whisper_large_v3", "xlstm_1_3b")
ATOL = 0.35  # the reference's own bf16 parity tolerance
LOGIT_TOL = 0.06
KV_TOL = 0.05
STATE_TOL = 1e-4
AUX_TOL = 1e-5
LOSS_TOL = 2e-3
GRAD_RTOL = 0.05
GRAD_ATOL = 2e-3
B, S = 2, 24
# the reference initialises these leaves to zero; the tests give them
# seeded values of this scale in the tree fed to both packages
WAKE = {"xgate": 1.0, "mgate": 1.0, "r_z": 0.5, "r_i": 0.5, "r_f": 0.5,
        "r_o": 0.5, "conv_b": 0.1, "scale": 0.1, "bias": 0.1,
        "q_norm": 0.1, "k_norm": 0.1}
STRICT = {"xla_allow_excess_precision": False}


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def _strict(fn, *args):
    """``fn(*args)`` compiled with every declared bf16 value rounded."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _wake(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _wake(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in WAKE:
        a = (rng.standard_normal(a.shape) * WAKE[key]).astype(np.float32)
    return a


def _configs(arch, capacity=None):
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    if capacity is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _carried(arch, seed=0):
    """(reference config, its params as jnp, the port model holding them,
    the numpy tree): the reference's init with the ``WAKE`` leaves
    seeded."""
    jcfg, tcfg = _configs(arch)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_model(jax.random.key(seed), jcfg))
    params = _wake(params, np.random.default_rng(7))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, params),
            TM.from_reference_params(params, tcfg, device="cpu"), params)


def _inputs(cfg, seed=1):
    """Tokens (B, S) and the frontend input, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    name = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if name:
        extra[name] = rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return toks, extra


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32, copy=True).numpy()


def _ref_layers(model, cache):
    """The reference's cache as one {name: array} per port layer."""
    out = []
    for li in range(len(model.layers)):
        key, g = TM._layer_key(model.plan, li)
        c = cache["groups"][key] if g is not None else cache[key]
        out.append({k: np.asarray(v, np.float32)[g] if g is not None
                    else np.asarray(v, np.float32) for k, v in c.items()})
    return out


def _port_layers(cache):
    return [{k: _np(v) for k, v in c.items()} for c in cache["layers"]]


@functools.lru_cache(maxsize=None)
def _served(arch, kv_int8=False):
    """Both packages on the same inputs: forward over S tokens, prefill of
    S-2, two decode steps; each cache copied after the prefill and after
    the steps."""
    jcfg, jp, model, _ = _carried(arch)
    toks, extra = _inputs(jcfg)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    out = {"forward": (
        _strict(lambda p, b: JM.forward(p, jcfg, b, CTX), jp,
                dict(jx, tokens=jnp.asarray(toks))),
        TM.forward(model, torch.from_numpy(toks), **tx))}
    cj = JM.init_cache(jcfg, B, S + 8, kv_int8=kv_int8)
    ct = TM.init_cache(model, B, S + 8, kv_int8=kv_int8)
    lpj, cj = _strict(lambda p, b, c: JM.prefill(p, jcfg, b, c, CTX), jp,
                      dict(jx, tokens=jnp.asarray(toks[:, :-2])), cj)
    lpt, ct = TM.prefill(model, torch.from_numpy(toks[:, :-2]), ct, **tx)
    out["prefill"] = (lpj, lpt)
    out["prefill cache"] = (_ref_layers(model, cj), _port_layers(ct),
                            int(cj["pos"][0]), int(ct["pos"][0]))
    out["decode"] = []
    for i in (2, 1):
        tok = toks[:, S - i:S - i + 1]
        ldj, cj = _strict(lambda p, c, t: JM.decode_step(p, jcfg, c, t, CTX),
                          jp, cj, jnp.asarray(tok))
        ldt, ct = TM.decode_step(model, ct, torch.from_numpy(tok))
        out["decode"].append((ldj, ldt))
    out["decode cache"] = (_ref_layers(model, cj), _port_layers(ct),
                           int(cj["pos"][0]), int(ct["pos"][0]))
    return out


def _diff(j, t):
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


STATE_NAMES = ("h", "C", "n", "m", "c")  # f32 recurrent states
BF16_NAMES = ("k", "v", "xk", "xv", "conv")


def _check_cache(ref, port, int8=False):
    assert len(ref) == len(port)
    for li, (r, p) in enumerate(zip(ref, port)):
        assert set(r) == set(p), li
        for name in r:
            what = f"layer {li} {name}"
            if name == "pos_abs":
                np.testing.assert_array_equal(p[name], r[name], what)
            elif int8 and name in ("k", "v"):
                np.testing.assert_allclose(p[name], r[name], atol=1, rtol=0,
                                           err_msg=what)
            elif name in ("kscale", "vscale"):
                np.testing.assert_allclose(p[name], r[name], rtol=2 ** -7,
                                           atol=0, err_msg=what)
            elif name in STATE_NAMES:
                np.testing.assert_allclose(p[name], r[name], atol=STATE_TOL,
                                           rtol=0, err_msg=what)
            else:
                assert name in BF16_NAMES, what
                np.testing.assert_allclose(p[name], r[name], atol=KV_TOL,
                                           rtol=0, err_msg=what)


# -- configs and parameters --------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference_field_by_field(arch):
    assert _as_dict(tconfigs.get_config(arch)) == _as_dict(
        jconfigs.get_config(arch))
    assert _as_dict(tconfigs.smoke_config(arch)) == _as_dict(
        jconfigs.smoke_config(arch))
    assert tconfigs.get_config(arch).hd == jconfigs.get_config(arch).hd
    assert tconfigs.get_config(arch).layer_types() == jconfigs.get_config(
        arch).layer_types()


def test_config_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for alias in ("qwen3-32b", "phi3-mini-3.8b", "llama-3.2-vision-11b"):
        assert tconfigs.canonical_arch(alias) == jconfigs.canonical_arch(alias)
    assert {k: _as_dict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: _as_dict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        assert [s.name for s in tconfigs.shapes_for(tconfigs.get_config(
            arch))] == [s.name for s in jconfigs.shapes_for(
                jconfigs.get_config(arch))]
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-17")


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_init_model_has_reference_keys_and_shapes(arch, size):
    """Every layout: head, stacked groups, tail, the encoder's groups and
    positions, the learned decoder positions, the frontend projection.
    On the meta device the full configs cost no memory."""
    get = "smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    model = TM.init_model(getattr(tconfigs, get)(arch), device="meta")
    assert TM.reference_shapes(model) == _shapes(JM.init_model_abstract(jcfg))
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32


# leaves the reference uses uncast in f32 (``cast_weights`` keeps the norm
# scales, the gates and rg_a; _slstm_cell reads r_* in f32)
F32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "xgate", "mgate", "rg_a",
              "r_z", "r_i", "r_f", "r_o")


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_dtypes_follow_the_references_use(arch):
    model = TM.init_model(tconfigs.get_config(arch), device="meta")
    for name, p in model.named_parameters():
        want = (torch.float32 if name.rsplit(".", 1)[-1] in F32_LEAVES
                else torch.bfloat16)
        assert p.dtype == want, name


def test_init_model_draws_the_reference_distribution_from_a_generator():
    cfg = tconfigs.smoke_config("qwen3-32b")
    a = TM.init_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    b = TM.init_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    for (na, pa), (_nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert float(a.embed.float().std()) == pytest.approx(0.02, rel=0.1)
    wq = a.layers[0].attn.wq.float()
    assert float(wq.std()) == pytest.approx(1 / np.sqrt(cfg.d_model), rel=0.1)
    assert not a.layers[0].attn.q_norm.any()


def test_non_dense_init_draws_the_reference_distribution():
    """Gates, conv biases and sLSTM recurrent weights start at zero and
    a^c = exp(-8 softplus(rg_a)) in about (0.9, 0.999) at r = 1/8...1,
    as the reference draws them."""
    g = torch.Generator().manual_seed(0)
    vis = TM.init_model(tconfigs.smoke_config("llama_3_2_vision_11b"),
                        device="cpu", generator=g)
    x = next(layer for layer in vis.layers if layer.typ == "xattn")
    assert float(x.xgate) == 0.0 and float(x.mgate) == 0.0
    rg = TM.init_model(tconfigs.smoke_config("recurrentgemma_2b"),
                       device="cpu", generator=g)
    rec = rg.layers[0].rec
    sp = torch.nn.functional.softplus(rec.rg_a)
    assert float(sp.min()) >= 0.3 - 1e-6 and float(sp.max()) <= 0.8 + 1e-6
    assert not rec.conv_b.any()
    xl = TM.init_model(tconfigs.smoke_config("xlstm_1_3b"), device="cpu",
                       generator=g)
    sl = next(layer for layer in xl.layers if layer.typ == "slstm")
    assert not any(getattr(sl.lstm, n).any() for n in ("r_z", "r_i", "r_f",
                                                        "r_o"))
    wh = TM.init_model(tconfigs.smoke_config("whisper_large_v3"),
                       device="cpu", generator=g)
    assert wh.pos_embed.shape == (TM.MAX_DECODER_POS, 64)
    assert float(wh.encoder.pos_embed.float().std()) == pytest.approx(
        0.02, rel=0.3)


def test_carried_models_hold_the_woken_leaves():
    """The differential tests run with the gates, the recurrent weights
    and the conv biases non-zero in both packages."""
    _, _, vis, _ = _carried("llama_3_2_vision_11b")
    x = next(layer for layer in vis.layers if layer.typ == "xattn")
    assert float(x.xgate) != 0.0 and float(x.mgate) != 0.0
    _, _, xl, params = _carried("xlstm_1_3b")
    sl = next(layer for layer in xl.layers if layer.typ == "slstm")
    for n in ("r_z", "r_i", "r_f", "r_o"):
        assert getattr(sl.lstm, n).abs().min() > 0
        np.testing.assert_array_equal(
            getattr(sl.lstm, n).numpy(), params["groups"]["7_slstm"]["lstm"][
                n][0])
    assert xl.layers[0].lstm.conv_b.abs().max() > 0
    _, _, rg, _ = _carried("recurrentgemma_2b")
    assert rg.layers[0].rec.conv_b.abs().max() > 0


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tconfigs.smoke_config("qwen3-32b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.from_reference_params({}, cfg)


def test_from_reference_params_rejects_a_foreign_layout():
    _, _, _, params = _carried("phi3-mini-3.8b")
    params = dict(params)
    params.pop("lm_head")
    with pytest.raises(ValueError, match="keys"):
        TM.from_reference_params(params, tconfigs.smoke_config(
            "phi3-mini-3.8b"), device="cpu")
    _, _, _, params = _carried("whisper_large_v3")
    params = dict(params, encoder=dict(params["encoder"]))
    params["encoder"]["pos_embed"] = params["encoder"]["pos_embed"][:3]
    with pytest.raises(ValueError, match="encoder/pos_embed"):
        TM.from_reference_params(params, tconfigs.smoke_config(
            "whisper_large_v3"), device="cpu")


# -- every arch against the reference ----------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_logits_match_reference_with_carried_weights(arch):
    r = _served(arch)
    (lj, _), (lt, _) = r["forward"]
    cfg = tconfigs.smoke_config(arch)
    assert lt.shape == (B, S, cfg.vocab_size) and lt.dtype == torch.bfloat16
    assert _diff(lj, lt) < LOGIT_TOL <= ATOL
    assert _diff(*r["prefill"]) < LOGIT_TOL
    for ldj, ldt in r["decode"]:
        assert _diff(ldj, ldt) < LOGIT_TOL
    # the port's own prefill/decode parity with its parallel pass
    assert float((ldt[:, 0].float() - lt[:, -1].float()).abs().max()) < ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    (lj, auxj), (lt, auxt) = _served(arch)["forward"]
    cfg = tconfigs.smoke_config(arch)
    assert lt.shape == (B, S, cfg.vocab_size) and lt.dtype == torch.bfloat16
    assert _diff(lj, lt) < LOGIT_TOL
    assert auxt.dtype == torch.float32 and auxt.shape == ()
    assert abs(float(auxj) - float(auxt)) < AUX_TOL
    assert (float(auxt) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_its_cache_match_reference(arch):
    r = _served(arch)
    lpj, lpt = r["prefill"]
    assert lpt.shape == (B, 1, tconfigs.smoke_config(arch).vocab_size)
    assert _diff(lpj, lpt) < LOGIT_TOL
    ref, port, pos_j, pos_t = r["prefill cache"]
    _check_cache(ref, port)
    assert pos_j == pos_t == S - 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_match_reference(arch):
    r = _served(arch)
    for ldj, ldt in r["decode"]:
        assert ldt.shape == (B, 1, tconfigs.smoke_config(arch).vocab_size)
        assert _diff(ldj, ldt) < LOGIT_TOL
    ref, port, pos_j, pos_t = r["decode cache"]
    _check_cache(ref, port)
    assert pos_j == pos_t == S


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` and the gradient of every f32 master against
    ``jax.value_and_grad``; and the reference test's own checks: a finite
    loss, a non-zero global norm."""
    jcfg, jp, _, pnp = _carried(arch)
    toks, extra = _inputs(jcfg)
    labels = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    jb = dict({k: jnp.asarray(v) for k, v in extra.items()},
              tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    lj, gj = _strict(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, CTX)), jp, jb)
    tree = tree_map(lambda a: torch.from_numpy(np.array(
        a, np.float32)).requires_grad_(), pnp)
    tb = dict({k: torch.from_numpy(v) for k, v in extra.items()},
              tokens=torch.from_numpy(toks), labels=torch.from_numpy(labels))
    lt = TM.loss_fn(tree, tconfigs.smoke_config(arch), tb)
    gt = torch.autograd.grad(lt, leaves(tree))
    lt = lt.detach()
    assert np.isfinite(float(lt)) and lt.dtype == torch.float32
    assert abs(float(lt) - float(lj)) < LOSS_TOL
    want = leaf_paths(jax.tree_util.tree_map(np.asarray, gj))
    norm = 0.0
    for (key, a), g in zip(want, gt):
        assert g.dtype == torch.float32 and g.shape == a.shape, key
        np.testing.assert_allclose(
            g.numpy(), a, rtol=0,
            atol=GRAD_RTOL * float(np.abs(a).max()) + GRAD_ATOL, err_msg=key)
        norm += float((g.double() ** 2).sum())
    assert norm > 0


def test_local_ring_wraps_at_these_sizes():
    """recurrentgemma's smoke window (16) is shorter than the prefill
    (22 tokens) and the two steps: the ring wraps, keeps the last 16
    positions, and the steps overwrite the oldest slots."""
    ref, port, _, _ = _served("recurrentgemma_2b")["decode cache"]
    pa = next(c["pos_abs"] for c in port if "pos_abs" in c)
    assert sorted(pa[0].astype(int).tolist()) == list(range(S - 16, S))
    assert all(int(p) % 16 == slot for slot, p in enumerate(pa[0]))


def test_int8_kv_view_matches_reference():
    """The int8 view (phi3 smoke, ``test_int8_kv_view_decode_parity``'s
    case): int8 K/V within one step of the reference's (half-to-even
    rounding of values within a bf16 ulp), scales within one bf16 ulp,
    logits within the tolerance."""
    r = _served("phi3_mini_3_8b", kv_int8=True)
    assert _diff(*r["prefill"]) < LOGIT_TOL
    for ldj, ldt in r["decode"]:
        assert _diff(ldj, ldt) < LOGIT_TOL
    for key in ("prefill cache", "decode cache"):
        ref, port, pos_j, pos_t = r[key]
        _check_cache(ref, port, int8=True)
        assert set(port[0]) == {"k", "v", "kscale", "vscale"}
    model = _carried("phi3_mini_3_8b")[2]
    c = TM.init_cache(model, B, S, kv_int8=True)["layers"][0]
    assert c["k"].dtype == torch.int8 and c["kscale"].dtype == torch.bfloat16


def test_quantize_kv_rounds_half_to_even_as_the_reference():
    x = np.array([[[[0.5, 1.5, 2.5, -2.5, 127.0, 3.0]]]], np.float32)
    x = np.concatenate([x, -x * 0.37, x * 1e-9], axis=2)
    jq, js = JM._quantize_kv(jnp.asarray(x))
    tq, ts = TM._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


# planted faults: each breaks the decode comparison by far more than its
# tolerance, so the tolerance can see such a fault
def _zero_in_cache(typ, names):
    def fault(model, cache):
        for layer, c in zip(model.layers, cache["layers"]):
            if layer.typ == typ:
                for n in names:
                    c[n].zero_()
    return fault


FAULTS = {
    "rglru h not carried": ("recurrentgemma_2b", _zero_in_cache("rglru",
                                                               ("h",))),
    "mlstm C not carried": ("xlstm_1_3b", _zero_in_cache("mlstm", ("C",))),
    "cross-KV zeroed (dec)": ("whisper_large_v3", _zero_in_cache(
        "dec", ("xk", "xv"))),
    "cross-KV zeroed (xattn)": ("llama_3_2_vision_11b", _zero_in_cache(
        "xattn", ("xk", "xv"))),
    "local ring positions lost": ("recurrentgemma_2b", _zero_in_cache(
        "local", ("k", "v"))),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_breaks_the_decode_comparison(fault):
    arch, plant = FAULTS[fault]
    jcfg, _, model, _ = _carried(arch)
    toks, extra = _inputs(jcfg)
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    ct = TM.init_cache(model, B, S + 8)
    TM.prefill(model, torch.from_numpy(toks[:, :-2]), ct, **tx)
    plant(model, ct)
    ldt, _ = TM.decode_step(model, ct, torch.from_numpy(toks[:, S - 2:S - 1]))
    ldj = _served(arch)["decode"][0][0]
    assert _diff(ldj, ldt) > 5 * LOGIT_TOL


# -- limits and refusals -----------------------------------------------------

def test_limits_of_the_reference_raise():
    xl = _carried("xlstm_1_3b")[2]
    toks = torch.zeros((1, 300), dtype=torch.long)
    with pytest.raises(ValueError, match="multiple of 256"):
        TM.forward(xl, toks)
    rg = _carried("recurrentgemma_2b")[2]
    with pytest.raises(ValueError, match="conv state"):
        TM.prefill(rg, toks[:, :2], TM.init_cache(rg, 1, 8))
    phi = _carried("phi3_mini_3_8b")[2]
    with pytest.raises(ValueError, match="does not fit"):
        TM.prefill(phi, toks[:, :20], TM.init_cache(phi, 1, 16))
    wh = _carried("whisper_large_v3")[2]
    with pytest.raises(ValueError, match="frames"):
        TM.forward(wh, toks[:, :4])


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_paged_engine_sends_non_dense_archs_to_the_dense_cache_path(arch):
    cfg = tconfigs.smoke_config(arch)
    with pytest.raises(ValueError, match="prefill and decode_step"):
        ServingEngine(cfg, TM.init_model(cfg, device="meta"))


# -- the reference's tests/test_models.py on the port ------------------------

def _port_smoke(arch):
    """The reference's ``_smoke_cfg``: capacity lifted to 8 so that the
    parity check isolates real bugs (the forward drops choices at
    capacity, decode never does); the port's own seeded weights."""
    cfg = _configs(arch, 8.0 if tconfigs.smoke_config(arch).moe else None)[1]
    return cfg, TM.init_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_parity(arch):
    cfg, model = _port_smoke(arch)
    toks, extra = _inputs(cfg)
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    logits, _ = TM.forward(model, torch.from_numpy(toks), **tx)
    assert not torch.isnan(logits).any()
    cache = TM.init_cache(model, B, S + 8)
    lg_pre, cache = TM.prefill(model, torch.from_numpy(toks[:, :S - 1]),
                               cache, **tx)
    lg_dec, cache = TM.decode_step(model, cache,
                                   torch.from_numpy(toks[:, S - 1:]))
    full = logits.float().numpy()
    np.testing.assert_allclose(lg_pre[:, 0].float().numpy(), full[:, -2],
                               atol=ATOL)
    dec = lg_dec[:, 0].float().numpy()
    if cfg.moe is not None:
        # top-k routing is discontinuous: a knife-edge token may flip
        # experts under the decode path's rounding (the reference's rule)
        assert (np.abs(dec - full[:, -1]) < ATOL).mean() > 0.6
    else:
        np.testing.assert_allclose(dec, full[:, -1], atol=ATOL)
    assert int(cache["pos"][0]) == S


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_lift(arch):
    """At the published capacity factor the carried smoke forward drops
    choices at capacity; lifted to 8 it cannot (every expert holds every
    token); a decode step's B tokens never fill the least capacity, 8."""
    _, tcfg = _configs(arch)
    mcfg = TM._moe_cfg(tcfg)
    lifted = dataclasses.replace(mcfg, capacity_factor=8.0)
    assert TL.moe_capacity(B * S, lifted) >= B * S
    assert TL.moe_capacity(B, mcfg) == 8 >= B * mcfg.top_k
    kept = []
    real = TL.moe_dispatch

    def spy(ids, e, cap):
        row, keep = real(ids, e, cap)
        kept.append(keep)
        return row, keep

    TL.moe_dispatch = spy
    try:
        model = _carried(arch)[2]
        toks, _ = _inputs(tcfg)
        TM.forward(model, torch.from_numpy(toks))
    finally:
        TL.moe_dispatch = real
    assert kept and not all(bool(k.all()) for k in kept)


def test_moe_specs():
    d = tconfigs.get_config("deepseek_moe_16b")
    assert (d.moe.num_experts, d.moe.top_k, d.moe.num_shared) == (64, 6, 2)
    l4 = tconfigs.get_config("llama4_scout_17b_a16e")
    assert (l4.moe.num_experts, l4.moe.top_k) == (16, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_numbers_match_brief(arch):
    """The full configs must carry the exact published dimensions."""
    expect = {
        "phi3_mini_3_8b": (32, 3072, 32, 32, 8192, 32064),
        "minitron_4b": (32, 3072, 24, 8, 9216, 256000),
        "command_r_plus_104b": (64, 12288, 96, 8, 33792, 256000),
        "qwen3_32b": (64, 5120, 64, 8, 25600, 151936),
        "whisper_large_v3": (32, 1280, 20, 20, 5120, 51866),
        "recurrentgemma_2b": (26, 2560, 10, 1, 7680, 256000),
        "deepseek_moe_16b": (28, 2048, 16, 16, 1408, 102400),
        "llama4_scout_17b_a16e": (48, 5120, 40, 8, 8192, 202048),
        "llama_3_2_vision_11b": (40, 4096, 32, 8, 14336, 128256),
        "xlstm_1_3b": (48, 2048, 4, 4, 0, 50304),
    }[arch]
    cfg = tconfigs.get_config(arch)
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == expect


def test_long_context_only_for_sub_quadratic():
    for arch in ARCHS:
        names = {s.name for s in tconfigs.shapes_for(
            tconfigs.get_config(arch))}
        assert ("long_500k" in names) == (arch in ("recurrentgemma_2b",
                                                   "xlstm_1_3b"))


def test_int8_kv_view_decode_parity():
    """§4 multi-representation cached views applied to KV: the int8 view
    must agree with full-precision decode on argmax and closely on
    logits (phi3 smoke)."""
    cfg, model = _port_smoke("phi3_mini_3_8b")
    toks, _ = _inputs(cfg)
    logits, _ = TM.forward(model, torch.from_numpy(toks))
    cache = TM.init_cache(model, B, S + 4, kv_int8=True)
    assert cache["layers"][0]["k"].dtype == torch.int8
    TM.prefill(model, torch.from_numpy(toks[:, :S - 1]), cache)
    lgd, _ = TM.decode_step(model, cache, torch.from_numpy(toks[:, S - 1:]))
    ref = logits[:, -1].float().numpy()
    got = lgd[:, 0].float().numpy()
    assert np.abs(got - ref).max() < 0.5
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# -- layers ------------------------------------------------------------------

def test_attention_chunks_like_the_reference():
    """A prefill longer than one chunk (and not a multiple of it) gives
    the reference's rows: the port snaps the chunk the same way."""
    from repro.models import layers as JL

    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 45, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 45, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 45, 2, 8)).astype(np.float32)
    want = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)), chunk=16))
    got = TL.attention(*map(torch.from_numpy, (q, k, v)), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 5), (True, 1), (False, None),
                                           (True, 64)])
def test_attention_window_and_bidirectional_match_reference(causal, window):
    from repro.models import layers as JL

    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 45, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 45, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 45, 2, 8)).astype(np.float32)
    want = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window, chunk=16))
    got = TL.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       window=window, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_self_attention_block_matches_reference(causal, window):
    """The block of the ``attn``/``local``/``enc`` layers (f32 weights
    carried across, f32 activations)."""
    from repro.models import layers as JL

    cfg = TM._attn_cfg(tconfigs.smoke_config("qwen3-32b"), window=window,
                       causal=causal)
    jcfg = JL.AttnCfg(**dataclasses.asdict(cfg))
    p = jax.tree_util.tree_map(np.array, JL.init_attn(
        jax.random.key(0), jcfg))
    mod = TL.Attention(cfg, generator=None, device="meta").to_empty(
        device="cpu").float()
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    x = np.random.default_rng(2).standard_normal((2, 21, cfg.d_model)).astype(
        np.float32)
    want = JL.self_attention_block(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), jcfg, jnp.arange(21), CTX,
                                   chunk=8)
    got = TL.self_attention_block(mod, torch.from_numpy(x), cfg,
                                  torch.arange(21), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_activations_round_like_the_reference():
    """silu, gelu and sigmoid on bf16 give the reference's bits (it
    rounds after each op of jax.nn's definitions; F.silu and F.gelu
    round once and differ in about 40 % of values)."""
    x = np.random.default_rng(8).standard_normal(20000).astype(np.float32) * 3
    xt = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    for jf, tf in ((jax.nn.silu, TL.silu), (jax.nn.gelu, TL.gelu),
                   (jax.nn.sigmoid, TL.sigmoid)):
        np.testing.assert_array_equal(tf(xt).float().numpy(),
                                      np.asarray(jf(xj), np.float32))
        np.testing.assert_allclose(
            tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)


def test_norms_and_rope_match_reference():
    from repro.models import layers as JL

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TL.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias)).numpy(),
        np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias))), rtol=1e-5, atol=1e-5)
    pos = np.arange(5, dtype=np.int32) + 1000
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-4)
