"""The port's training substrate against the JAX reference on the CPU:
the token pipeline, checkpoints on VSS, the runner's crash and resume,
and the train step.

The reference's ``tests/test_train.py`` is ported first, case for case
(``device="cpu"`` everywhere; the CPU step is deterministic, so the
crash-restart resume is bit for bit).  Then both packages get the same
inputs:

- ``TokenPipeline`` batches of one seeded corpus, each package writing
  its own store: equal, wrap-around included;
- ``tree_to_frames`` of one train state (the reference's
  ``init_train_state`` carried across by ``from_reference_state``, with
  and without ``bf16_params``) in ``f32``, ``bf16`` and ``int8``: equal
  frames byte for byte and equal specs;
- a checkpoint written by either package restores in the other, leaf
  for leaf, in ``f32`` and in its derived ``int8`` view;
- one train step (phi3 and deepseek smoke configs, two microbatches,
  with ``compress_grads`` and with ``bf16_params``; the norm scales,
  zero at init, given seeded values whose bits reach below bf16's, so
  the bf16 live params' rounded norms count) against the reference's
  step compiled with excess precision off (``_strict``, as in
  ``tests/test_torch_models.py``).  The loss within ``LOSS_TOL`` = 5e-4
  (measured 2.1e-4), the grad norm within ``GNORM_RTOL`` = 2e-3
  relative (measured 6.1e-4), the gradients within ``GRAD_RTOL`` = 3e-2
  of each leaf's largest value (measured 1.11e-2: bf16 rounding of the
  activations' cotangents, summed in other orders).  The optimizer is held apart, on the
  same gradients: on step 1 AdamW moves each parameter by about
  lr·sign(g), so a gradient element within an ulp of 0 in one package
  and of the other sign in the other moves that parameter by up to
  2·lr·lr_scale, which says nothing of the optimizer.  So the port's
  ``apply_grads`` and the reference step's second half (compress, clip,
  schedule, AdamW, compiled ``_strict``) both take the reference's
  gradients, and every leaf of the new state (params, m, v, the
  master) must be within ``OPT_RTOL`` = 1e-5 of the leaf's largest
  value, the error within 1e-5 of its gradient's largest value (compiled,
  XLA rounds the reference's quantiser otherwise than its op-by-op
  evaluation, which the port equals bit for bit: an ulp of the gradient
  in the error), the bf16 live parameters equal to the port's master
  rounded and within one bf16 ulp of the reference's (measured: 4.6e-7
  on params, m, v and master, 8.9e-8 on the error, the bf16 parameters
  equal).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.store import VSS as JVSS
from repro.data import tokens as JT
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.sharding import ShardCtx
from repro.train import checkpoint as JC
from repro_torch.configs import smoke_config
from repro_torch.core import VSS as TVSS
from repro_torch.core import VSSConfig
from repro_torch.data.tokens import (
    TokenPipeline,
    read_tokens,
    write_token_corpus,
)
from repro_torch.launch import steps as TS
from repro_torch.launch.steps import TrainHyper, init_train_state
from repro_torch.train.checkpoint import (
    CheckpointManager,
    frames_to_tree,
    tree_to_frames,
)
from repro_torch.train.runner import SimulatedFailure, Trainer, TrainerConfig
from repro_torch.tree import leaf_paths, leaves

torch.set_num_threads(1)

CFG = smoke_config("phi3-mini-3.8b")
HYPER = TrainHyper(num_microbatches=2, total_steps=40, warmup_steps=2)
CTX = ShardCtx(None)
STRICT = {"xla_allow_excess_precision": False}
LOSS_TOL = 5e-4
GNORM_RTOL = 2e-3
GRAD_RTOL = 3e-2
OPT_RTOL = 1e-5


def VSS(root, **kw):
    return TVSS(root, config=VSSConfig(device="cpu"), **kw)


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


@pytest.fixture()
def corpus(tmp_path):
    vss = VSS(str(tmp_path / "data"))
    tokens = np.random.default_rng(0).integers(
        0, CFG.vocab_size, 200_000
    ).astype(np.int32)
    n = write_token_corpus(vss, "corpus", tokens)
    yield vss, n, tokens
    vss.close()


def _trainer(tmp_path, corpus, sub, fail=None):
    vss, n, _ = corpus
    pipe = TokenPipeline(vss, "corpus", n, batch=4, seq=32)
    ck = CheckpointManager(str(tmp_path / f"ckpt_{sub}"), keep_last=2,
                           derived_reprs=("bf16",), device="cpu")
    return Trainer(CFG, HYPER, pipe, ck,
                   tcfg=TrainerConfig(checkpoint_every=4, fail_at_step=fail,
                                      log_every=4), device="cpu")


def _like():
    return init_train_state(0, CFG, HYPER, device="meta")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def _equal_leaves(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x.cpu(), y.cpu())
        else:
            np.testing.assert_array_equal(_np(x), _np(y))


# -- the reference's tests/test_train.py on the port --------------------------

def test_pipeline_deterministic(corpus):
    vss, n, tokens = corpus
    p1 = TokenPipeline(vss, "corpus", n, batch=4, seq=32)
    p2 = TokenPipeline(vss, "corpus", n, batch=4, seq=32)
    b1 = p1.get(7)
    b2 = p2.get(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # step addressing is absolute: batch 7 == tokens at offset 7*4*33
    flat = read_tokens(vss, "corpus", 7 * 4 * 33, 4 * 33, n)
    np.testing.assert_array_equal(
        b1["tokens"], flat.reshape(4, 33)[:, :-1]
    )
    p1.close()
    p2.close()


def test_pipeline_straggler_bounded_staleness(corpus):
    vss, n, _ = corpus
    pipe = TokenPipeline(vss, "corpus", n, batch=2, seq=16,
                         deadline_s=0.05, delay_s=0.5)
    pipe.get(0)  # first fetch blocks hard (nothing staged)
    pipe.get(1)  # prefetched by get(0)'s tail prefetch... may or may not hit
    pipe.get(5)  # far fetch → deadline miss → stale reuse
    assert pipe.stats.stale_reuses >= 1
    pipe.close()


def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = init_train_state(0, CFG, HYPER, device="cpu")
    ck = CheckpointManager(str(tmp_path / "ck"), keep_last=2,
                           derived_reprs=("bf16", "int8"), device="cpu")
    for s in (4, 8, 12):
        ck.save(s, state, blocking=True)
    assert ck.steps() == [8, 12]  # keep_last=2 retention
    restored, step = ck.restore(like=_like())
    assert step == 12
    _equal_leaves(state, restored)
    # quantized views restore approximately
    r8, _ = ck.restore(repr_="int8", like=_like())
    for x, y in zip(leaves(state), leaves(r8)):
        x = _np(x).astype(np.float32)
        y = _np(y).astype(np.float32)
        if x.size:
            assert np.abs(x - y).max() <= max(np.abs(x).max() / 100, 1e-6)
    ck.close()


def test_cold_checkpoints_deferred_compressed(tmp_path):
    state = init_train_state(0, CFG, HYPER, device="cpu")
    ck = CheckpointManager(str(tmp_path / "ck"), keep_last=3, device="cpu")
    ck.save(1, state, blocking=True)
    ck.save(2, state, blocking=True)
    ck.save(3, state, blocking=True)
    sizes = {s: i.nbytes for s, i in ck.stats().items()}
    # cold masters (1, 2) are zstd-wrapped in place; newest stays raw
    assert sizes[1] < sizes[3]
    restored, _ = ck.restore(step=1, like=_like())  # wrapped GOPs still read
    _equal_leaves(state, restored)
    ck.close()


def test_crash_restart_bitwise_resume(tmp_path, corpus):
    t_ref = _trainer(tmp_path, corpus, "ref").init()
    t_ref.train(12)
    t1 = _trainer(tmp_path, corpus, "ft", fail=6).init()
    with pytest.raises(SimulatedFailure):
        t1.train(12)
    t1.ckpt.wait()  # durable storage finishes its in-flight write
    t2 = _trainer(tmp_path, corpus, "ft")
    assert t2.resume()
    assert t2.step == 4
    t2.train(12)
    for a, b in zip(leaves(t_ref.state["params"]),
                    leaves(t2.state["params"])):
        assert torch.equal(a, b)


def test_resume_without_checkpoint_returns_false(tmp_path, corpus):
    t = _trainer(tmp_path, corpus, "none")
    assert not t.resume()
    t.init_or_resume()
    assert t.state is not None and t.step == 0


def test_tree_to_frames_roundtrip():
    tree = {"a": np.arange(13, dtype=np.float32),
            "b": {"c": np.ones((3, 5), np.int32)}}
    frames, spec = tree_to_frames(tree)
    assert frames.dtype == np.uint8 and frames.shape[1:] == (64, 128, 3)
    out = frames_to_tree(frames, spec, like=tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])


# -- the port's own refusals --------------------------------------------------

def test_trainer_takes_a_mesh(tmp_path, corpus):
    """A ``DeviceMesh`` is taken (a (1, 1) gloo mesh steps); anything else
    given as a mesh raises ``TypeError``, at construction and at
    ``resume``."""
    from repro_torch.launch.mesh import host_group, make_host_mesh

    vss, n, _ = corpus
    ck = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    pipe = TokenPipeline(vss, "corpus", n, batch=2, seq=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(CFG, HYPER, pipe, ck, mesh=object(), device="cpu")
    t = Trainer(CFG, HYPER, pipe, ck, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        t.resume(mesh=object())
    with host_group("cpu"):
        t = Trainer(CFG, HYPER, pipe, ck, mesh=make_host_mesh("cpu"),
                    device="cpu").init()
        t.train(2)
        assert t.step == 2 and t.state["step"].full_tensor().item() == 2
    pipe.close()
    ck.close()


def test_prefill_and_decode_step_wrappers():
    """``make_prefill_step``/``make_decode_step`` are ``prefill`` and
    ``decode_step`` (the audio family's frames passed through)."""
    from repro_torch.models import model as TM

    cfg = smoke_config("whisper_large_v3")
    model = TM.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_frontend_tokens, cfg.frontend_dim)).astype(np.float32))
    want_c = TM.init_cache(model, 2, 8)
    want, want_c = TM.prefill(model, toks, want_c, frames=frames)
    got_c = TM.init_cache(model, 2, 8)
    got, got_c = TS.make_prefill_step(cfg)(
        model, {"tokens": toks, "frames": frames}, got_c)
    assert torch.equal(got, want)
    nxt = toks[:, :1]
    want, _ = TM.decode_step(model, want_c, nxt)
    got, got_c = TS.make_decode_step(cfg)(model, got_c, nxt)
    assert torch.equal(got, want) and int(got_c["pos"][0]) == 7


# -- against the reference ----------------------------------------------------

def test_pipeline_batches_match_reference(tmp_path):
    """Each package writes the same corpus into its own store; batches
    at the same steps (one wrapping past the corpus end) are equal."""
    tokens = np.random.default_rng(4).integers(
        0, CFG.vocab_size, 30_001).astype(np.int32)
    jv, tv = JVSS(str(tmp_path / "j")), VSS(str(tmp_path / "t"))
    nj = JT.write_token_corpus(jv, "c", tokens)
    nt = write_token_corpus(tv, "c", tokens)
    assert nj == nt == tokens.size
    pj = JT.TokenPipeline(jv, "c", nj, batch=3, seq=40)
    pt = TokenPipeline(tv, "c", nt, batch=3, seq=40)
    for step in (0, 1, 7, 241, 242):  # 242 * 123 wraps past 30 001
        bj, bt = pj.get(step), pt.get(step)
        assert set(bj) == set(bt)
        for k in bj:
            assert bt[k].dtype == bj[k].dtype == np.int32
            np.testing.assert_array_equal(bt[k], bj[k], f"{step} {k}")
    pj.close()
    pt.close()
    jv.close()
    tv.close()


def _woken(state, bf16_params):
    """The norm scales (zero at init) given seeded f32 values with bits
    below bf16's, in the masters; the bf16 live params rounded from
    them, as the reference's ``init_train_state`` rounds."""
    rng = np.random.default_rng(7)
    key = ("opt", "master") if bf16_params else ("params",)

    def wake(tree):
        if isinstance(tree, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32)
                        * np.float32(0.1) if k in ("scale", "q_norm",
                                                   "k_norm")
                        else v) if not isinstance(v, dict) else wake(v)
                    for k, v in tree.items()}
        return tree

    state = dict(state, opt=dict(state["opt"]))
    masters = wake(state[key[0]] if len(key) == 1 else state["opt"]["master"])
    if bf16_params:
        state["opt"]["master"] = masters
        state["params"] = jax.tree_util.tree_map(
            lambda p: np.asarray(jnp.asarray(p, jnp.bfloat16))
            if p.dtype == np.float32 else p, masters)
    else:
        state["params"] = masters
    return state


@functools.lru_cache(maxsize=None)
def _reference_state(arch, woken=False, **hyper):
    """The reference's ``init_train_state`` as numpy; ``woken``: the norm
    scales seeded (``_woken``)."""
    jcfg = jconfigs.smoke_config(arch)
    state = JS.init_train_state(jax.random.key(0), jcfg,
                                JS.TrainHyper(**hyper))
    state = jax.tree_util.tree_map(np.asarray, state)
    return _woken(state, hyper.get("bf16_params", False)) if woken else state


@pytest.mark.parametrize("bf16_params", [False, True])
@pytest.mark.parametrize("repr_", ["f32", "bf16", "int8"])
def test_tree_to_frames_matches_reference(repr_, bf16_params):
    """The reference's state and the port's copy of it serialise to the
    same frames and specs (bf16 live params in every representation when
    ``bf16_params``)."""
    hyper = dict(bf16_params=bf16_params, compress_grads=True)
    ref = _reference_state("phi3-mini-3.8b", **hyper)
    port = TS.from_reference_state(ref, CFG, TrainHyper(**hyper),
                                   device="cpu")
    cast = None if repr_ == "f32" else repr_
    fj, sj = JC.tree_to_frames(ref, cast=cast)
    ft, st = tree_to_frames(port, cast=cast)
    assert st == sj
    assert ft.shape == fj.shape
    assert ft.tobytes() == fj.tobytes()
    dtypes = {s["dtype"] for s in st["leaves"]}
    assert ("bfloat16" in dtypes) == (bf16_params or repr_ == "bf16")
    # and the port reads the reference's frames back
    back = frames_to_tree(fj, sj, like=port)
    for (key, x), y in zip(leaf_paths(JC.frames_to_tree(fj, sj, like=ref)),
                           leaves(back)):
        np.testing.assert_array_equal(_np(y), _np(x), key)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    hyper = dict(bf16_params=True)
    ref = _reference_state("phi3-mini-3.8b", **hyper)
    port = TS.from_reference_state(ref, CFG, TrainHyper(**hyper),
                                   device="cpu")
    root = str(tmp_path / "ck")
    if writer == "reference":
        ck = JC.CheckpointManager(root, keep_last=2, derived_reprs=("int8",))
        ck.save(4, ref)
        ck.save(8, ref)
    else:
        ck = CheckpointManager(root, keep_last=2, derived_reprs=("int8",),
                               device="cpu")
        ck.save(4, port)
        ck.save(8, port)
    ck.close()
    like_t = init_train_state(0, CFG, TrainHyper(**hyper), device="meta")
    like_j = JS.abstract_train_state(jconfigs.smoke_config("phi3-mini-3.8b"),
                                     JS.TrainHyper(**hyper))
    tck = CheckpointManager(root, keep_last=2, derived_reprs=("int8",),
                            device="cpu")
    jck = JC.CheckpointManager(root, keep_last=2, derived_reprs=("int8",))
    for repr_ in ("f32", "int8"):
        got, step_t = tck.restore(repr_=repr_, like=like_t)
        want, step_j = jck.restore(repr_=repr_, like=like_j)
        assert step_t == step_j == 8
        for (key, x), y in zip(leaf_paths(jax.tree_util.tree_map(
                np.asarray, want)), leaves(got)):
            np.testing.assert_array_equal(_np(y), _np(x), f"{repr_} {key}")
    # the cold master at step 4 was compressed by whichever wrote it
    assert tck.stats()[4].nbytes < tck.stats()[8].nbytes
    tck.close()
    jck.close()


# -- one train step against the reference's -----------------------------------

STEP_CASES = [(arch, mode) for arch in ("phi3-mini-3.8b", "deepseek_moe_16b")
              for mode in ("compress_grads", "bf16_params")]
STEP_HYPER = dict(num_microbatches=2, total_steps=40, warmup_steps=2)
B, S = 4, 16


def _reference_grads(jcfg, hyper):
    """The reference step's first half (``repro/launch/steps.py``'s
    microbatch scan), returning (loss, grads)."""

    def loss_of(params, mb):
        return JM.loss_fn(params, jcfg, mb, CTX)

    def grads(params, batch):
        n = hyper.num_microbatches
        micro = JS._split_microbatches(batch, n)

        def acc(carry, mb):
            loss_sum, gsum = carry
            loss, g = jax.value_and_grad(loss_of)(params, mb)
            gsum = jax.tree_util.tree_map(
                lambda a, b: a + b.astype(jnp.float32), gsum, g)
            return (loss_sum + loss, gsum), None

        zeros = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (loss_sum, g), _ = jax.lax.scan(acc, (jnp.float32(0.0), zeros),
                                        micro)
        return loss_sum / n, jax.tree_util.tree_map(lambda x: x / n, g)

    return grads


def _reference_apply(hyper):
    """The reference step's second half (``repro/launch/steps.py``)."""
    from repro.optim import (adamw_update, clip_by_global_norm,
                             compress_decompress_grads, cosine_schedule)

    def apply(state, grads):
        new_state = dict(state)
        if hyper.compress_grads:
            grads, new_state["ef"] = compress_decompress_grads(
                grads, state["ef"])
        grads, _gnorm = clip_by_global_norm(grads, hyper.adamw.clip_norm)
        lr_scale = cosine_schedule(state["step"], hyper.total_steps,
                                   hyper.warmup_steps)
        if hyper.bf16_params:
            opt = dict(state["opt"])
            master = opt.pop("master")
            new_master, new_opt = adamw_update(master, grads, opt,
                                               hyper.adamw, lr_scale)
            new_opt["master"] = new_master
            new_params = jax.tree_util.tree_map(
                lambda p: p.astype(jnp.bfloat16)
                if p.dtype == jnp.float32 else p, new_master)
        else:
            new_params, new_opt = adamw_update(
                state["params"], grads, state["opt"], hyper.adamw, lr_scale)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        return new_state

    return apply


@functools.lru_cache(maxsize=None)
def _stepped(arch, mode):
    hyper = dict(STEP_HYPER, **{mode: True})
    jcfg = jconfigs.smoke_config(arch)
    tcfg = smoke_config(arch)
    jh, th = JS.TrainHyper(**hyper), TrainHyper(**hyper)
    ref = _reference_state(arch, woken=True, **hyper)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)}
    batch["labels"][1, :5] = -1
    jstate = jax.tree_util.tree_map(jnp.asarray, ref)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_j, met_j = _strict(JS.make_train_step(jcfg, CTX, jh), jstate, jbatch)
    loss_j, grads_j = _strict(_reference_grads(jcfg, jh),
                              jstate["params"], jbatch)
    held_j = _strict(_reference_apply(jh), jstate, grads_j)
    state = TS.from_reference_state(ref, tcfg, th, device="cpu")
    new_t, met_t = TS.make_train_step(tcfg, th)(state, batch)
    loss_t, grads_t = TS.make_grad_step(tcfg, th)(state["params"], batch)
    # the optimizer alone, fed the reference's gradients
    fed = TS.from_reference_state(ref, tcfg, th, device="cpu")
    gj_t = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), grads_j)
    held, _ = TS.apply_grads(fed, torch.tensor(float(loss_j)), gj_t, th)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(new_j=as_np(new_j), met_j=as_np(met_j), grads_j=as_np(grads_j),
                held_j=as_np(held_j),
                loss_j=float(loss_j), new_t=new_t, met_t=met_t,
                grads_t=grads_t, loss_t=float(loss_t), held=held, th=th,
                state_t=state)


@pytest.mark.parametrize("arch,mode", STEP_CASES)
def test_train_step_loss_and_gradients_match_reference(arch, mode):
    r = _stepped(arch, mode)
    assert abs(float(r["met_t"]["loss"]) - float(r["met_j"]["loss"])) \
        < LOSS_TOL
    assert abs(r["loss_t"] - r["loss_j"]) < LOSS_TOL
    assert float(r["met_t"]["grad_norm"]) == pytest.approx(
        float(r["met_j"]["grad_norm"]), rel=GNORM_RTOL)
    assert float(r["met_t"]["lr_scale"]) == float(r["met_j"]["lr_scale"])
    got = dict(leaf_paths(r["grads_t"]))
    for key, want in leaf_paths(r["grads_j"]):
        g = got[key]
        assert g.dtype == torch.float32, key  # summed over microbatches
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_RTOL * float(np.abs(want).max()),
            err_msg=key)
    assert int(r["new_t"]["step"]) == int(r["new_j"]["step"]) == 1


@pytest.mark.parametrize("arch,mode", STEP_CASES)
def test_train_step_optimizer_matches_reference(arch, mode):
    """The port's ``apply_grads`` and the reference step's second half,
    both on the reference's gradients: every state leaf."""
    r = _stepped(arch, mode)
    held = dict(leaf_paths(r["held"]))
    new_j = dict(leaf_paths(r["held_j"]))
    grads = dict(leaf_paths(r["grads_j"]))
    assert set(held) == set(new_j)
    for key, want in new_j.items():
        got = held[key]
        w = np.asarray(want, np.float32) if want.dtype.name == "bfloat16" \
            else want
        if got.dtype == torch.bfloat16:  # live params rounded from master
            np.testing.assert_allclose(
                got.float().numpy(), w, rtol=2 ** -8, atol=0, err_msg=key)
            master = held["opt/master/" + key.split("/", 1)[1]]
            assert torch.equal(got, master.to(torch.bfloat16)), key
            continue
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        scale = np.abs(w).max()
        if key.startswith("ef/"):  # an ulp of the gradient (see above)
            scale = np.abs(grads[key.split("/", 1)[1]]).max()
        atol = OPT_RTOL * float(scale or 1.0)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)
