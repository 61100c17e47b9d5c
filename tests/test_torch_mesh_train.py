"""The sharded half of the port: MoE token groups, the bf16
weight cast, the group recompute, the train step on a (1, 1) gloo mesh
and on four gloo ranks (with sharded serving and MoE drops there), and
the trainer's elastic ``resume(mesh=)``.

* MoE token groups: the port's ``moe_block`` with G ∈ {1, 2, 4} groups
  against the reference's ``moe_block`` under a stand-in ctx
  (``dp_size=G``, ``dp="data"``, ``cs`` the identity) on the same seeded
  inputs, within the bf16 tolerance of ``test_torch_recurrent.py``.
* ``cast_weights`` bit for bit against the reference's.
* Recompute (``remat_policy`` "none" and "save_tp") gives the bits of no
  recompute.
* On a (1, 1) gloo mesh every placement is ``Replicate``: the sharded
  step equals the plain step bit for bit for each family's smoke config.
* Four gloo ranks on a (2, 2) mesh (spawned once, meeting through a
  ``FileStore``):
  - training: the gathered state after the training phase's
    ``VS_CPU_STEPS`` steps is within its ``VS_CPU`` limits of the
    unsharded steps with the same token groups, and a planted wrong
    placement exceeds them.  (The limits are set for that many steps:
    after one, AdamW's change is lr·sign(g), and the near-zero gradient
    elements whose sign a rounding flips dominate the parameters'
    change.  The MoE config runs at the non-dense phase's
    ``PARITY_CAPACITY``, where no choice is dropped: a drop at capacity
    is a step function of the routing, so the tensor-parallel partial
    sums' other rounding moves whole tokens between experts.)
  - serving: prefill and two decode steps of the dense, MoE and
    recurrentgemma (one kv head) smoke configs, logits and every cache
    tensor against one device within ``SERVE_REL``; a planted wrong
    K-cache layout exceeds it.
  - MoE drops: one ``moe_block`` at a capacity that drops, its input
    laid out from one full tensor: each data shard's ids and rows equal
    its group's in the unsharded block with two groups, exactly.
* ``Trainer.resume(mesh=)``: a (1, 1)-mesh trainer resumed from the
  unsharded trainer's checkpoint writes the bytes the unsharded trainer
  writes.
"""
import pathlib
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import sharding as JSH
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import VSS as TVSS
from repro_torch.core import VSSConfig
from repro_torch.data.tokens import TokenPipeline, write_token_corpus
from repro_torch.launch.mesh import host_group, make_host_mesh
from repro_torch.launch.specs import (
    cache_shardings,
    distribute,
    distribute_state,
    full_state,
)
from repro_torch.launch.steps import (
    TrainHyper,
    init_train_state,
    make_decode_step,
    make_grad_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.sharding import (
    ShardCtx,
    is_dtensor,
    param_shardings,
    spec_for,
)
from repro_torch.train.checkpoint import CheckpointManager, tree_to_frames
from repro_torch.train.runner import Trainer, TrainerConfig
from repro_torch.tree import leaf_paths, leaves
from test_torch_recurrent import _close, _j, _moe, _x

REPO = pathlib.Path(__file__).resolve().parent.parent
HYPER = TrainHyper(num_microbatches=2, total_steps=40, warmup_steps=2,
                   shard_grad_accum=True)


class Groups(ShardCtx):
    """No mesh, but the MoE's token groups of a data-parallel world of
    ``n`` (the unsharded twin of a sharded step)."""

    def __init__(self, n, **kw):
        super().__init__(**kw)
        self.n = n

    @property
    def dp_size(self):
        return self.n


def _batches(cfg, n, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32)}
        front = (b, cfg.num_frontend_tokens, cfg.frontend_dim)
        if cfg.family == "audio":
            bt["frames"] = rng.standard_normal(front).astype(np.float32)
        if cfg.family == "vlm":
            bt["patches"] = rng.standard_normal(front).astype(np.float32)
        out.append(bt)
    return out


def _unequal(a, b, ma, mb):
    """Paths of the leaves and metrics of ``a`` and (gathered) ``b`` that
    differ in any bit."""
    fb = full_state(b)
    bad = [p for (p, x), y in zip(leaf_paths(a), leaves(fb))
           if not torch.equal(x, y)]
    for x, y in zip(ma, mb):
        y = full_state(y)
        bad += [k for k in x if not torch.equal(x[k], y[k])]
    return bad


# -- MoE token groups ----------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_token_groups_match_reference(groups, cf):
    cfg_j, cfg_t, p, mod = _moe(e=8, k=2, cf=cf)
    xj, xt = _x((4, 16, 32), "bf16", seed=3)
    ref_ctx = types.SimpleNamespace(mesh=None, dp_size=groups, dp="data",
                                    act_seq=None, cs=lambda x, *s: x)
    yj, auxj = JL.moe_block(_j(p), xj, cfg_j, "silu", ref_ctx)
    yt, auxt = TL.moe_block(mod, xt, cfg_t, "silu", Groups(groups))
    _close(yt, yj, "bf16")
    assert abs(float(auxt) - float(auxj)) < 1e-6


def test_token_groups_change_the_drops():
    """At a capacity that drops, one group and four route otherwise (so
    the comparison above pins the groups)."""
    _cfg_j, cfg_t, _p, mod = _moe(e=8, k=2, cf=0.5)
    _, xt = _x((4, 16, 32), "bf16", seed=3)
    y1, _ = TL.moe_block(mod, xt, cfg_t, "silu", Groups(1))
    y4, _ = TL.moe_block(mod, xt, cfg_t, "silu", Groups(4))
    assert float((y1 - y4).abs().max()) > 1e-2


# -- cast_weights, recompute -------------------------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "xlstm_1_3b",
                                  "recurrentgemma_2b"])
def test_cast_weights_matches_reference(arch):
    jparams = jax.tree_util.tree_map(
        np.asarray, JM.init_model(jax.random.key(0),
                                  jconfigs.smoke_config(arch)))
    port = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  jparams)
    ref = JM.cast_weights(jax.tree_util.tree_map(jnp.asarray, jparams),
                          JSH.ShardCtx(None, bf16_weights=True))
    got = TM.cast_weights(port, ShardCtx(bf16_weights=True))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(dict(leaf_paths(got))) == set(want)
    for path, leaf in leaf_paths(got):
        assert str(leaf.dtype).replace("torch.", "") == str(
            want[path].dtype), path
        np.testing.assert_array_equal(_bits(leaf), _bits(want[path]))
    assert TM.cast_weights(port, ShardCtx()) is port


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek_moe_16b",
                                  "whisper_large_v3", "xlstm_1_3b"])
@pytest.mark.parametrize("policy", ["none", "save_tp"])
def test_recompute_gives_the_same_bits(arch, policy):
    cfg = smoke_config(arch)
    state = init_train_state(0, cfg, HYPER, device="cpu")
    batch = _batches(cfg, 1)[0]
    loss, grads = make_grad_step(cfg, HYPER)(state["params"], batch)
    rloss, rgrads = make_grad_step(cfg, HYPER, ShardCtx(
        remat_policy=policy))(state["params"], batch)
    assert torch.equal(loss, rloss)
    for (p, a), b in zip(leaf_paths(grads), leaves(rgrads)):
        assert torch.equal(a, b), p


# -- the (1, 1) gloo mesh ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_by_one_mesh_step_equals_plain_step(arch):
    cfg = smoke_config(arch)
    state = init_train_state(0, cfg, HYPER, device="cpu")
    batches = _batches(cfg, 2)
    plain = make_train_step(cfg, HYPER)
    a, ma = state, []
    for bt in batches:
        a, m = plain(a, bt)
        ma.append(m)
    with host_group("cpu"):
        mesh = make_host_mesh("cpu")
        sharded = make_train_step(cfg, HYPER, ShardCtx(mesh))
        d, md = distribute_state(state, mesh), []
        for bt in batches:
            d, m = sharded(d, bt)
            md.append(m)
        assert not _unequal(a, d, ma, md)


def test_host_mesh_asks_for_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        host_group()


# -- four gloo ranks on a (2, 2) mesh ----------------------------------------

FOUR_RANK_ARCHS = ("phi3-mini-3.8b", "deepseek_moe_16b")


def _wrong_placement(state, path):
    """Planted fault: the leaf at ``path`` given the placements of its two
    sharded dims swapped (the same local blocks, laid out otherwise)."""
    from torch.distributed.tensor import DTensor

    out = {k: v for k, v in state.items()}
    node, keys = out, path.split("/")
    for k in keys[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    leaf = node[keys[-1]]
    pl = tuple(reversed(leaf.placements))
    node[keys[-1]] = DTensor.from_local(leaf.to_local(), leaf.device_mesh, pl,
                                        run_check=False)
    return out


FAULT_LEAF = "params/groups/0_attn/mlp/wi"
FAULT_LEAF_MOE = "params/groups/0_moe/attn/wq"


def _four_rank_config(arch):
    """The smoke config, an MoE one at capacity ``PARITY_CAPACITY``."""
    import dataclasses

    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg = smoke_config(arch)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=chip_smoke.PARITY_CAPACITY))


SERVE_ARCHS = ("phi3-mini-3.8b", "deepseek_moe_16b", "recurrentgemma_2b")
SERVE_B, SERVE_S = 2, 24
MOE_CF = 0.5  # a capacity at which choices are dropped


def _gathered(tree):
    """A copy of a cache tree ({"layers": [...], "pos"}) with every
    DTensor gathered."""
    def one(t):
        return (t.full_tensor() if is_dtensor(t) else t).clone()

    return {"layers": [{k: one(v) for k, v in c.items()}
                       for c in tree["layers"]], "pos": one(tree["pos"])}


def _serve(arch, mesh=None, fault=False):
    """The launch layer's prefill of ``SERVE_S - 2`` seeded tokens and two
    decode steps of the seeded smoke model, on ``mesh`` (parameters,
    tokens and cache laid out by their rules) or on one device: the
    gathered logits, the gathered cache after the prefill and after the
    steps, and the MoE routes taken (ids and router probabilities of
    each call; on a mesh, this device's groups).  ``fault`` plants a
    wrong layout after the prefill: the first K cache's two sharded dims
    swap their placements (the same local blocks)."""
    cfg = _four_rank_config(arch)
    model = TM.init_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32))
    cache = TM.init_cache(model, SERVE_B, SERVE_S + 8)
    ctx = None if mesh is None else ShardCtx(mesh)
    lay = (lambda t: t) if ctx is None else (
        lambda t: ctx.distribute(t, (ctx.dp,)))
    if ctx is not None:
        params = TM.reference_params(model)
        model = TM.model_from_params(cfg, distribute(
            params, param_shardings(params, mesh), mesh))
        cache = distribute(cache, cache_shardings(cache, mesh), mesh)
    prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
    routes, real = [], TL._moe_route
    TL._moe_route = _route_spy(routes)
    try:
        lp, cache = prefill(model, {"tokens": lay(toks[:, :-2])}, cache)
        logits, caches = [lp], [_gathered(cache)]
        if fault:
            from torch.distributed.tensor import DTensor

            c = next(c for c in cache["layers"] if "k" in c)
            c["k"] = DTensor.from_local(c["k"].to_local(), mesh,
                                        tuple(reversed(c["k"].placements)),
                                        run_check=False)
        for i in (2, 1):
            ld, cache = decode(model, cache,
                               lay(toks[:, SERVE_S - i:SERVE_S - i + 1]))
            logits.append(ld)
    finally:
        TL._moe_route = real
    caches.append(_gathered(cache))
    return ([t.full_tensor() if is_dtensor(t) else t for t in logits],
            caches, routes)


def _route_spy(record):
    """A stand-in for ``layers._moe_route`` that records each call's ids,
    rows and router probabilities (on a mesh: this device's groups)."""
    real = TL._moe_route

    def spy(tokens, probs, **kw):
        out = real(tokens, probs, **kw)
        record.append((out[1].clone(), out[2].clone(), probs.clone()))
        return out

    return spy


def _moe_forward(ctx, mesh=None):
    """One ``moe_block`` at ``MOE_CF`` on the seeded input of the token
    groups' test: (output, aux, the routes recorded).  On ``mesh`` the
    input is laid out from the one full tensor over the data axes and the
    weights by their rules, so the router sees exact rows."""
    _cfg_j, cfg_t, _p, mod = _moe(e=8, k=2, cf=MOE_CF)
    _, x = _x((4, 16, 32), "bf16", seed=3)
    if mesh is not None:
        for name, t in list(mod.named_parameters()):
            owner, _, attr = name.rpartition(".")
            sub = mod.get_submodule(owner) if owner else mod
            sub._parameters[attr] = ctx.distribute(
                t.detach(), spec_for(attr, tuple(t.shape), False))
        x = ctx.distribute(x, (ctx.dp,))
    record, real = [], TL._moe_route
    TL._moe_route = _route_spy(record)
    try:
        with torch.no_grad():
            y, aux = TL.moe_block(mod, x, cfg_t, "silu", ctx)
    finally:
        TL._moe_route = real
    full = [t.full_tensor() if is_dtensor(t) else t for t in (y, aux)]
    return full[0], full[1], record, cfg_t


def _four_rank_worker(rank, root, steps):
    """One rank on the (2, 2) mesh: each training arch's smoke state,
    ``steps`` sharded steps clean and from the planted wrong placement;
    the serving archs' prefill and decode steps; one ``moe_block`` that
    drops choices.  Rank 0 saves the gathered states, metrics, logits
    and caches; every rank saves the routes of its own data shard."""
    from repro_torch.launch.mesh import make_mesh, process_group

    torch.set_num_threads(1)
    out = {}
    with process_group("gloo", 4, rank, store_path=str(root / "store")):
        mesh = make_mesh((2, 2), device_type="cpu")
        for arch in FOUR_RANK_ARCHS:
            cfg = _four_rank_config(arch)
            state = init_train_state(0, cfg, HYPER, device="cpu")
            step = make_train_step(cfg, HYPER, ShardCtx(mesh))
            d = distribute_state(state, mesh)
            leaf = FAULT_LEAF_MOE if cfg.family == "moe" else FAULT_LEAF
            for fault, new in (("clean", d),
                               ("wrong placement",
                                _wrong_placement(d, leaf))):
                mets = []
                for batch in _batches(cfg, steps):
                    new, met = step(new, batch)
                    mets.append(full_state(met))
                out[(arch, fault)] = (full_state(new), mets)
        serve_routes = {}
        for arch in SERVE_ARCHS:
            logits, caches, serve_routes[arch] = _serve(arch, mesh)
            faulty = _serve(arch, mesh, fault=True)[:2]
            out[(arch, "serve")] = ((logits, caches), faulty)
        ctx = ShardCtx(mesh)
        y, aux, routes, _ = _moe_forward(ctx, mesh)
        out["moe"] = (y, aux)
        torch.save({"data": ctx.coordinate("data"), "routes": routes,
                    "serve": serve_routes}, root / f"routes{rank}.pt")
    if rank == 0:
        torch.save(out, root / "out.pt")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' results: rank 0's file and each rank's routes."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    root = tmp_path_factory.mktemp("four_ranks")
    torch.multiprocessing.spawn(_four_rank_worker,
                                args=(root, chip_smoke.VS_CPU_STEPS),
                                nprocs=4, join=True)
    return (torch.load(root / "out.pt", weights_only=False),
            [torch.load(root / f"routes{r}.pt", weights_only=False)
             for r in range(4)])


def test_four_gloo_ranks_within_vs_cpu_and_the_fault_is_not(four_ranks):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    steps = chip_smoke.VS_CPU_STEPS
    got = four_ranks[0]

    def pairs(mets):
        return [(float(m["loss"]), float(m["grad_norm"])) for m in mets]

    for arch in FOUR_RANK_ARCHS:
        cfg = _four_rank_config(arch)
        state = init_train_state(0, cfg, HYPER, device="cpu")
        step = make_train_step(cfg, HYPER, Groups(2))
        want, wms = state, []
        for batch in _batches(cfg, steps):
            want, wm = step(want, batch)
            wms.append(wm)
        diffs = {}
        for fault in ("clean", "wrong placement"):
            new, mets = got[(arch, fault)]
            diffs[fault] = chip_smoke.state_differences(
                state, new, want, pairs(mets), pairs(wms))
        over = {k: v for k, v in diffs["clean"].items()
                if v > chip_smoke.VS_CPU[k]}
        assert not over, (arch, diffs["clean"])
        assert any(v > chip_smoke.VS_CPU[k]
                   for k, v in diffs["wrong placement"].items()), (
            arch, diffs["wrong placement"])


# A sharded product rounds each device's partial sum to bf16 before the
# sum across devices: one rounding more than the plain product (2^-9 of
# its scale each).  Over the smoke configs' layers (and recurrentgemma's
# recurrence) that came to at most 2.4 % of a tensor's largest value
# (recurrentgemma's last decode logits; phi3-mini 0.9 %).  A wrong layout
# or softmax combine moves values by their own size.
SERVE_REL = 0.04
# a routing choice this close to a tie (in router logits, of order 1
# here) may fall the other way under that rounding
TIE_LOGITS = 2.0 ** -5


def _flipped_rows(arch, mesh_routes, plain_routes):
    """Batch rows of each serving call (prefill, decode, decode) from
    which on a MoE token's choices differ between the mesh and one
    device; each such choice must be a near-tie on one device."""
    if not plain_routes:
        return [set(), set(), set()]
    by_data = {}
    for r in mesh_routes:
        by_data.setdefault(r["data"], r["serve"][arch])
    per_call = len(plain_routes) // 3  # MoE layers
    out, bad = [], set()
    for i, (ids, _rows, probs) in enumerate(plain_routes):
        got = torch.cat([by_data[c][i][0] for c in sorted(by_data)])
        k = ids.shape[-1]
        ids, got = ids.reshape(-1, k), got.reshape(-1, k)
        probs = probs.reshape(ids.shape[0], -1)
        step = i // per_call
        per_row = ids.shape[0] // SERVE_B
        for t in torch.nonzero((ids.sort(-1)[0] != got.sort(-1)[0])
                               .any(-1)).flatten().tolist():
            top = probs[t].log().sort(descending=True)[0]
            assert float(top[k - 1] - top[k]) < TIE_LOGITS, (arch, i, t)
            bad.add((step, t // per_row))
    for step in range(3):
        out.append({row for s, row in bad if s <= step})
    return out


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _cache_rel(got, want, rows):
    """Largest relative difference over the cache's layers and entries,
    batch rows outside ``rows`` only; positions must be equal there."""
    keep = [b for b in range(SERVE_B) if b not in rows]
    worst = 0.0
    for g, w in zip(got["layers"] + [{"pos": got["pos"]}],
                    want["layers"] + [{"pos": want["pos"]}]):
        assert set(g) == set(w)
        for name in w:
            if name in ("pos", "pos_abs"):
                assert torch.equal(g[name][keep], w[name][keep]), name
            else:
                worst = max(worst, _rel(g[name][keep], w[name][keep]))
    return worst


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_four_gloo_ranks_serve_as_one_device(arch, four_ranks):
    """Prefill and two decode steps on the (2, 2) mesh (the cache's
    positions split over "model", decode attention as a split softmax;
    recurrentgemma's one kv head does not divide "model", so each device
    picks its q heads' kv head) against the same steps on one device:
    logits and every cache tensor within ``SERVE_REL`` of their scale,
    positions exact.  A MoE token whose expert choice is a near-tie may
    route otherwise on the mesh (checked); its row is left out from that
    call on.  The planted wrong K-cache layout must exceed the bound."""
    (got_logits, got_caches), (bad_logits, bad_caches) = \
        four_ranks[0][(arch, "serve")]
    want_logits, want_caches, plain_routes = _serve(arch)
    rows = _flipped_rows(arch, four_ranks[1], plain_routes)
    assert len(got_logits) == len(want_logits) == 3
    for step, (g, w) in enumerate(zip(got_logits, want_logits)):
        keep = [b for b in range(SERVE_B) if b not in rows[step]]
        assert g.shape == w.shape and keep, (step, rows)
        assert _rel(g[keep], w[keep]) < SERVE_REL, step
    for step, (g, w) in zip((0, 2), zip(got_caches, want_caches)):
        assert _cache_rel(g, w, rows[step]) < SERVE_REL, step
    after = [_rel(g, w) for g, w in zip(bad_logits[1:], want_logits[1:])]
    after.append(_cache_rel(bad_caches[1], want_caches[1], set()))
    assert max(after) > SERVE_REL, after


def test_four_gloo_ranks_drop_moe_choices_per_data_shard(four_ranks):
    """One ``moe_block`` at a capacity that drops, on the (2, 2) mesh: each
    data shard routes and drops within its own group, so the ids and
    rows of each device equal those of its group in the unsharded block
    with two token groups, exactly, and the output and aux agree within
    bf16 (the shared expert's tensor-parallel partial sums round
    otherwise)."""
    y, aux = four_ranks[0]["moe"]
    wy, waux, want, cfg = _moe_forward(Groups(2))
    (w_ids, w_rows, _), = want
    e, cap = cfg.num_experts, TL.moe_capacity(w_ids.shape[1], cfg)
    assert bool((w_rows == e * cap).any()), "no choice was dropped"
    for rank in four_ranks[1]:
        (ids, rows, _), = rank["routes"]
        c = rank["data"]
        assert torch.equal(ids, w_ids[c:c + 1])
        assert torch.equal(rows, w_rows[c:c + 1])
    _close(y, wy.float().numpy(), "bf16")
    assert abs(float(aux) - float(waux)) < 1e-6


# -- elastic resume -------------------------------------------------------

def test_mesh_resume_writes_the_unsharded_trainers_bytes(tmp_path):
    cfg = smoke_config("phi3-mini-3.8b")
    hyper = TrainHyper(num_microbatches=2, total_steps=40, warmup_steps=2)
    vss = TVSS(str(tmp_path / "data"), config=VSSConfig(device="cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 50_000)
    n = write_token_corpus(vss, "corpus", tokens.astype(np.int32))

    def trainer(sub, mesh=None):
        pipe = TokenPipeline(vss, "corpus", n, batch=4, seq=32)
        ck = CheckpointManager(str(tmp_path / sub), keep_last=2,
                               device="cpu")
        return Trainer(cfg, hyper, pipe, ck, mesh=mesh, device="cpu",
                       tcfg=TrainerConfig(checkpoint_every=4, log_every=4))

    first = trainer("plain").init()
    first.train(4)
    first.ckpt.wait()
    shutil.copytree(tmp_path / "plain", tmp_path / "sharded")
    plain = trainer("plain")
    assert plain.resume() and plain.step == 4
    plain.train(8)
    with host_group("cpu"):
        sharded = trainer("sharded")
        assert sharded.resume(mesh=make_host_mesh("cpu"))
        assert sharded.step == 4 and sharded.mesh is not None
        sharded.train(8)
    like = init_train_state(0, cfg, hyper, device="meta")
    a, sa = plain.ckpt.restore(like=like)
    b, sb = sharded.ckpt.restore(like=like)
    assert sa == sb == 8
    fa, _ = tree_to_frames(a)
    fb, _ = tree_to_frames(b)
    np.testing.assert_array_equal(fa, fb)
    for t in (first, plain, sharded):
        t.pipeline.close()
        t.ckpt.close()
    vss.close()
