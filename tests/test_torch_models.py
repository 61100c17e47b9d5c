"""The port's dense LM against the JAX reference on the CPU.

The configs are copies and must equal the reference's field by field.
With the reference's weights carried across by
``from_reference_params``, the logits of ``forward``, ``prefill`` and
``decode_step`` of the dense smoke configs agree with the reference's
within its own bf16 parity tolerance (atol 0.35,
``tests/test_models.py``); the largest difference measured is about 0.05
(bf16 logits of magnitude ~3, rounded in other places).  The non-dense
layer types raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.sharding import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM

torch.set_num_threads(1)

CTX = ShardCtx(None)
DENSE = ("phi3-mini-3.8b", "qwen3-32b", "minitron-4b")
NOT_DENSE = ("recurrentgemma_2b", "deepseek_moe_16b", "llama4_scout_17b_a16e",
             "llama_3_2_vision_11b", "whisper_large_v3", "xlstm_1_3b")
ATOL = 0.35  # the reference's own bf16 parity tolerance
MEASURED = 0.06  # the largest difference seen at these seeds, with margin
B, S = 2, 24


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


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


@pytest.mark.parametrize("arch", DENSE + ("command-r-plus-104b",))
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_init_model_has_reference_keys_and_shapes(arch, size):
    """On the meta device the full configs cost no memory."""
    get = "smoke_config" if size == "smoke" else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    model = TM.init_model(getattr(tconfigs, get)(arch), device="meta")
    assert TM.reference_shapes(model) == _shapes(JM.init_model_abstract(jcfg))
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32


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


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tconfigs.smoke_config("qwen3-32b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.from_reference_params({}, cfg)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_layer_types_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TM.init_model(tconfigs.smoke_config(arch), device="meta")


def _carried(arch, seed=0):
    jcfg = jconfigs.smoke_config(arch)
    params = JM.init_model(jax.random.key(seed), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, TM.from_reference_params(
        params_np, tconfigs.smoke_config(arch), device="cpu")


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _diff(j, t):
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


@pytest.mark.parametrize("arch", DENSE)
def test_logits_match_reference_with_carried_weights(arch):
    jcfg, params, model = _carried(arch)
    toks = _tokens(jcfg)
    lj, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, CTX)
    lt = TM.forward(model, torch.from_numpy(toks))
    assert lt.shape == (B, S, jcfg.vocab_size) and lt.dtype == torch.bfloat16
    assert _diff(lj, lt) < MEASURED <= ATOL

    cache = JM.init_cache(jcfg, B, max_len=S + 8)
    lpj, cache = JM.prefill(params, jcfg, {"tokens": jnp.asarray(
        toks[:, :-1])}, cache, CTX)
    ldj, cache = JM.decode_step(params, jcfg, cache, jnp.asarray(
        toks[:, -1:]), CTX)
    tc = TM.init_cache(model, B, max_len=S + 8)
    lpt, tc = TM.prefill(model, torch.from_numpy(toks[:, :-1]), tc)
    ldt, tc = TM.decode_step(model, tc, torch.from_numpy(toks[:, -1:]))
    assert _diff(lpj, lpt) < MEASURED
    assert _diff(ldj, ldt) < MEASURED
    assert int(tc["pos"][0]) == S
    # the port's own prefill/decode parity with its parallel pass
    assert float((ldt[:, 0].float() - lt[:, -1].float()).abs().max()) < ATOL
    for c, cj in zip(tc["layers"], range(jcfg.num_layers)):
        np.testing.assert_allclose(
            c["k"][:, :S].float().numpy(),
            np.asarray(cache["groups"]["0_attn"]["k"][cj, :, :S], np.float32),
            atol=0.1)


def test_from_reference_params_rejects_a_foreign_layout():
    jcfg, params, _ = _carried("phi3-mini-3.8b")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    params_np.pop("lm_head")
    with pytest.raises(ValueError, match="keys"):
        TM.from_reference_params(params_np, tconfigs.smoke_config(
            "phi3-mini-3.8b"), device="cpu")


def test_attention_chunks_like_the_reference():
    """A prefill longer than one chunk (and not a multiple of it) gives
    the reference's rows: the port snaps the chunk the same way."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 45, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 45, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 45, 2, 8)).astype(np.float32)
    want = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)), chunk=16))
    got = TL.attention(*map(torch.from_numpy, (q, k, v)), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_norms_and_rope_match_reference():
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

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
