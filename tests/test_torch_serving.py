"""The port's serving engine and page pool against the JAX reference on
the CPU.

Both pools run the same script of allocations, prefix lookups,
registrations, retentions and LRU_VSS evictions and must hold the same
state after every step.  The reference's four engine scenarios
(``tests/test_serving.py``) run through both engines with the smoke
weights carried across by ``from_reference_params``: the schedules
(``dedup_pages``, ``metrics``) are equal, and so are the tokens, up to a
near tie — a step where the two packages' bf16 logits (each engine's
own, captured per step) put two tokens within their measured difference
of each other; the sequences part there and are compared no further.
The port's engine is also held against the port's dense greedy path,
teacher-forced on the engine's tokens, at every step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving import engine as jengine
from repro.serving import pages as jpages
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.serving import engine as tengine
from repro_torch.serving import pages as tpages

torch.set_num_threads(1)

ARCH = "phi3-mini-3.8b"
# largest |Δ| between the two packages' (or the paged and dense paths')
# bf16 logits at one step, with margin over the ~0.05 measured; the
# reference's own parity tolerance is 0.35
LOGIT_TOL = 0.1


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.smoke_config(ARCH)
    params = JM.init_model(jax.random.key(0), jcfg)
    model = TM.from_reference_params(
        jax.tree_util.tree_map(np.asarray, params),
        tconfigs.smoke_config(ARCH), device="cpu")
    return jcfg, params, tconfigs.smoke_config(ARCH), model


# -- the page pool ---------------------------------------------------------

def _pool_state(pool):
    return (list(pool.free), pool.refcount.tolist(), dict(pool.prefix_index),
            [(r.page_ids, r.hashes, r.lru) for r in pool.retained],
            pool.pages_in_use)


def test_prefix_hash_is_the_references():
    for toks in ([], [1, 2, 3], list(range(1000, 1040))):
        assert tpages.prefix_hash(toks) == jpages.prefix_hash(toks)


def test_pools_hold_equal_state_through_one_script():
    kw = dict(num_pages=10, page_size=4, num_layers=2, num_kv_heads=1,
              head_dim=8)
    jp = jpages.PagePool(jpages.PagePoolConfig(**kw))
    tp = tpages.PagePool(tpages.PagePoolConfig(**kw), device="cpu")
    assert tuple(tp.k.shape) == tuple(jp.k.shape) == (2, 10, 4, 1, 8)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 50, n)) for n in (9, 13, 8, 17, 12)]
    prompts.append(prompts[1][:8] + [99, 98, 97])  # a shared prefix
    held = []

    def both(fn):
        a, b = fn(jp), fn(tp)
        assert a == b
        assert _pool_state(jp) == _pool_state(tp)
        return a

    for toks in prompts:
        shared, covered = both(lambda p: p.lookup_prefix(toks))
        ids = list(shared)
        while len(ids) < -(-len(toks) // 4):
            ids.append(both(lambda p: p.alloc()))
        both(lambda p: p.register_prefix(toks, ids))
        held.append((toks, ids))
        if len(held) > 1:  # finish the oldest: its pages are retained
            old, old_ids = held.pop(0)
            both(lambda p: p.retain(old, old_ids))
    for toks, ids in held:
        both(lambda p: p.retain(toks, ids))
    # pressure: allocating past the free list evicts by LRU_VSS order
    while jp.retained:
        both(lambda p: p.alloc())
    with pytest.raises(MemoryError):
        jp.alloc()
    with pytest.raises(MemoryError):
        tp.alloc()


def test_pool_writes_stay_on_the_device_and_match_reference():
    kw = dict(num_pages=6, page_size=4, num_layers=2, num_kv_heads=2,
              head_dim=8)
    jp = jpages.PagePool(jpages.PagePoolConfig(**kw))
    tp = tpages.PagePool(tpages.PagePoolConfig(**kw), device="cpu")
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    jp.write_run(k, v, [3, 0, 5], 10)
    tp.write_run(torch.from_numpy(k), torch.from_numpy(v), [3, 0, 5], 10)
    kt = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    vt = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    pids, offs = np.array([1, 0, 2]), np.array([0, 3, 1])
    jp.write_token((kt, vt), pids, offs)
    for layer in range(2):
        tp.write_layer_token(layer, torch.from_numpy(kt[layer]),
                             torch.from_numpy(vt[layer]),
                             torch.from_numpy(pids), torch.from_numpy(offs))
    for a, b in ((jp.k, tp.k), (jp.v, tp.v)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


# -- the engines -------------------------------------------------------------

def _capture(eng, jax_engine):
    """Record each decode round's logits by request id."""
    steps = {}
    real = eng._decode

    def wrapped(*args):
        rids = [a.req.rid for a in eng.active]
        out = real(*args)
        logits = out[0] if jax_engine else out
        arr = (np.asarray(logits, np.float32) if jax_engine
               else logits.float().numpy())
        for i, rid in enumerate(rids):
            steps.setdefault(rid, []).append(arr[i])
        return out

    eng._decode = wrapped
    return steps


def _near_tie_or_equal(ta, la, tb, lb):
    """Token lists equal up to a step where they part as a near tie.
    Returns the number of near ties (0 or 1)."""
    for i, (a, b) in enumerate(zip(ta, tb)):
        d = float(np.abs(la[i] - lb[i]).max())
        assert d < LOGIT_TOL, f"step {i}: logits differ by {d}"
        if a != b:
            margin = float(la[i][a] - la[i][b])
            assert 0 <= margin <= 2 * d, (i, margin, d)
            return 1
    return 0


def _dense_teacher_forced(model, prompt, tokens):
    """The port's dense greedy path fed the engine's tokens: logits at
    each step (prefill of prompt[:-1], then one decode step per token)."""
    cache = TM.init_cache(model, 1, len(prompt) + len(tokens) + 4)
    TM.prefill(model, torch.tensor([prompt[:-1]]), cache)
    out, cur = [], prompt[-1]
    for tok in tokens:
        lg, cache = TM.decode_step(model, cache, torch.tensor([[cur]]))
        out.append(lg[0, 0].float().numpy())
        cur = tok
    return out


def _run(served, scenario, **eng_kw):
    jcfg, params, tcfg, model = served
    je = jengine.ServingEngine(jcfg, params, **eng_kw)
    te = tengine.ServingEngine(tcfg, model, **eng_kw)
    jl, tl = _capture(je, True), _capture(te, False)
    ops.reset_plain_counts()
    jdone, tdone, prompts = scenario(je), scenario(te), {}
    for rid, req in tdone.items():
        prompts[rid] = req.prompt
    assert sorted(jdone) == sorted(tdone)
    assert je.metrics == te.metrics
    ties = 0
    for rid in tdone:
        jr, tr = jdone[rid], tdone[rid]
        assert jr.dedup_pages == tr.dedup_pages, rid
        assert len(tr.out) == len(jr.out) == tr.max_new
        ties += _near_tie_or_equal(jr.out, jl[rid], tr.out, tl[rid])
        # the port's engine against the port's dense greedy path
        dense = _dense_teacher_forced(model, tr.prompt, tr.out)
        ties += _near_tie_or_equal(
            [int(np.argmax(x)) for x in dense], dense, tr.out, tl[rid])
    # the paged attention ran once per layer per decode round, on the
    # CPU through its plain version
    assert ops.plain_counts()["paged_attention"] == (
        te.metrics["decode_steps"] * tcfg.num_layers)
    return jdone, tdone, te, ties


def test_paged_matches_dense(served):
    prompt = list(range(40, 80))

    def scenario(eng):
        eng.submit(prompt, max_new=8)
        return eng.run()

    _, tdone, _, ties = _run(served, scenario, page_size=8, num_pages=64,
                             max_batch=4)
    assert ties <= 1 and len(tdone[0].out) == 8


def test_prefix_dedup_shares_pages(served):
    prompt = list(range(100, 140))

    def scenario(eng):
        eng.submit(prompt, max_new=4)
        done = dict(eng.run())
        eng.submit(prompt, max_new=4)  # identical prompt → full dedup
        done.update(eng.run())
        eng.submit(prompt[:32] + [7, 7, 7, 7], max_new=4)
        done.update(eng.run())
        return done

    _, tdone, te, _ = _run(served, scenario, page_size=8, num_pages=64,
                           max_batch=4)
    # the identical prompt shares the full pages of prompt[:-1] (39
    # tokens: 4 pages of 8).  Not the fifth: the reference retains a run
    # as prompt[:-1] + out, so the position that holds the fed last prompt
    # token is hashed as the first generated one (copied, as the
    # reference does it)
    assert tdone[1].dedup_pages == 4
    assert tdone[2].dedup_pages == 4  # 32 tokens / page 8
    assert te.metrics["dedup_tokens"] == 32 + 32


def test_batched_decode_matches_sequential(served):
    prompts = [list(range(10, 30)), list(range(200, 230)),
               list(range(55, 75))]

    def scenario(eng):
        for p in prompts:
            eng.submit(p, max_new=5)
        return eng.run()

    _, tdone, te, ties = _run(served, scenario, page_size=8, num_pages=128,
                              max_batch=4)
    assert te.metrics["decode_steps"] == 5
    assert ties <= len(prompts)


def test_pool_eviction_under_pressure(served):
    def scenario(eng):
        for i in range(6):  # each run retains pages; pool must recycle
            eng.submit(list(range(i * 31, i * 31 + 24)), max_new=4)
        return eng.run()

    _, tdone, te, _ = _run(served, scenario, page_size=8, num_pages=24,
                           max_batch=2)
    assert len(tdone) == 6
    assert te.pool.pages_in_use <= te.pool.cfg.num_pages


def test_engine_refuses_non_dense_archs_and_defaults_to_cuda(served):
    _jcfg, _params, tcfg, model = served
    with pytest.raises(ValueError, match="dense"):
        tengine.ServingEngine(tconfigs.smoke_config("recurrentgemma_2b"),
                              model)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpages.PagePool(tpages.PagePoolConfig(
            num_pages=2, page_size=4, num_layers=1, num_kv_heads=1,
            head_dim=8))
