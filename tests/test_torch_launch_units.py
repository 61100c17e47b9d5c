"""Launch-layer units of the port (``repro_torch.launch``,
``repro_torch.models.sharding``), ported from ``test_launch_units.py``,
with differentials against the reference at full width for all ten
archs: the cells, the abstract train state, the batch and cache specs,
the parameter specs, the specs fitted to both production meshes and
their per-device bytes, and the roofline's parameter and FLOP counts.

The reference's fitting (``ShardCtx._fit``) and ``sharded_bytes`` read
only ``axis_names``, ``shape`` and ``devices.shape`` of a mesh and
``.spec`` of a sharding, so stand-ins give its numbers here without 256
devices (tests run on one).  The port's side builds its meshes on
torch's fake process group.  Every comparison is exact.
"""
import os
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as JRF
from repro.launch import specs as JSP
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models import sharding as JSH
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.base import SHAPES, shapes_for
from repro_torch.launch import roofline as RF
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.steps import TrainHyper, abstract_train_state
from repro_torch.models import model as M
from repro_torch.models.sharding import fitted_specs, spec_for
from repro_torch.tree import leaf_paths


def _reference_cells():
    """``repro.launch.dryrun.cells``; importing that module sets the
    forced device count in ``XLA_FLAGS`` for later processes, so the
    variable is restored (jax is already initialised here)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cells
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return list(cells())


def _jpaths(tree):
    """{"a/b/c": leaf} of a reference pytree (dict keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def _sig(leaf):
    return tuple(int(d) for d in leaf.shape), str(leaf.dtype).replace(
        "torch.", "")


class StandInMesh:
    """What the reference's ``_fit`` and ``sharded_bytes`` read of a
    mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices = types.SimpleNamespace(shape=shape)


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


# -- the reference's units, on the port -----------------------------------

def test_cell_enumeration_counts():
    from repro_torch.launch.dryrun import cells

    all_cells = list(cells())
    assert len(all_cells) == 64  # 32 arch×shape × 2 meshes
    singles = [c for c in all_cells if not c[2]]
    assert len(singles) == 32
    long_cells = {c[0] for c in all_cells if c[1] == "long_500k"}
    assert long_cells == {"recurrentgemma_2b", "xlstm_1_3b"}


def test_cells_equal_reference():
    from repro_torch.launch.dryrun import cells

    assert list(cells()) == _reference_cells()


def test_batch_specs_per_family():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        b = SP.batch_specs(cfg, SHAPES["train_4k"])
        assert b["tokens"].shape == (256, 4096)
        assert b["tokens"].device.type == "meta"
        if cfg.family == "audio":
            assert "frames" in b
        if cfg.family == "vlm":
            assert "patches" in b
        d = SP.batch_specs(cfg, SHAPES["decode_32k"])
        assert d["tokens"].shape == (128, 1)
        assert "frames" not in d and "patches" not in d


def test_cache_specs_shapes():
    cfg = get_config("qwen3_32b")
    cache = SP.cache_specs(cfg, 8, 1024)
    assert len(cache["layers"]) == 64
    k = cache["layers"][0]["k"]
    assert k.shape == (8, 1024, 8, 128) and k.device.type == "meta"
    c8 = SP.cache_specs(cfg, 8, 1024, kv_int8=True)
    assert c8["layers"][0]["k"].dtype == torch.int8
    assert "kscale" in c8["layers"][0]


def test_param_spec_rules():
    assert spec_for("groups/0_attn/attn/wq", (64, 512, 4, 16), True)[0] \
        is None
    assert spec_for("embed", (1000, 64), False) == ("model", "data")
    assert spec_for("tail_0_attn/mlp/wd", (128, 64), False) == (
        "model", "data")
    assert spec_for("final_norm/scale", (64,), False) == (None,)


def test_abstract_init_matches_real_init():
    cfg = smoke_config("recurrentgemma-2b")
    abstract = M.init_model_abstract(cfg)
    real = M.reference_params(M.init_model(cfg, device="cpu",
                                           dtype=torch.float32))
    assert {p: _sig(x) for p, x in leaf_paths(abstract)} == \
        {p: _sig(x) for p, x in leaf_paths(real)}
    assert all(x.device.type == "meta" for _p, x in leaf_paths(abstract))


def test_roofline_math():
    r = RF.Roofline(
        flops_per_chip=RF.BF16_FLOPS,  # exactly one second of compute
        hbm_bytes_per_chip=RF.HBM_BYTES_PER_S / 2,
        ici_bytes_per_chip=0.0,
        model_flops_total=RF.BF16_FLOPS * 256 / 2,  # half of it useful
        chips=256,
    )
    assert r.dominant == "compute"
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.useful_flops_fraction - 0.5) < 1e-9
    assert abs(r.roofline_fraction - 0.5) < 1e-9


def test_h100_constants_and_links():
    assert (RF.BF16_FLOPS, RF.F32_OPS_PER_S, RF.HBM_BYTES_PER_S) == (
        989e12, 67e12, 3.35e12)
    assert RF.link_rate(8) == RF.NVLINK_BYTES_PER_S == 450e9
    assert RF.link_rate(16) == RF.IB_BYTES_PER_S == 50e9
    one_s = RF.Roofline(0.0, 0.0, 450e9, 1.0, 8, group=8)
    assert one_s.dominant == "collective" and one_s.collective_s == 1.0
    assert RF.Roofline(0.0, 0.0, 450e9, 1.0, 8, group=16).collective_s \
        == 9.0


# -- differentials against the reference, full width ----------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["plain", "bf16_params", "compress_grads"])
def test_abstract_train_state_equals_reference(arch, mode):
    kw = {} if mode == "plain" else {mode: True}
    port = abstract_train_state(get_config(arch), TrainHyper(**kw))
    ref = JS.abstract_train_state(jconfigs.get_config(arch),
                                  JS.TrainHyper(**kw))
    assert {p: _sig(x) for p, x in leaf_paths(port)} == \
        {p: _sig(x) for p, x in _jpaths(ref).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name in JSHAPES:
        got = {k: _sig(v) for k, v in SP.batch_specs(cfg, SHAPES[name])
               .items()}
        want = {k: _sig(v) for k, v in JSP.batch_specs(jcfg, JSHAPES[name])
                .items()}
        assert got == want, name
    for int8 in (False, True):
        port = SP.cache_specs(cfg, 4, 64, kv_int8=int8)
        ref = JSP.cache_specs(jcfg, 4, 64, kv_int8=int8)
        model = M.init_model(cfg, device="meta")
        for li, c in enumerate(port["layers"]):
            key, g = M._layer_key(model.plan, li)
            rc = ref["groups"][key] if g is not None else ref[key]
            want = {k: (tuple(v.shape[1:]) if g is not None
                        else tuple(v.shape), str(v.dtype))
                    for k, v in rc.items()}
            assert {k: _sig(v) for k, v in c.items()} == want, (li, key)
        assert _sig(port["pos"]) == _sig(ref["pos"])


def test_cache_rules_are_the_references():
    for dp in ("data", ("pod", "data")):
        for n, r, f in JSP._CACHE_RULES:
            assert SP.cache_spec(n, r, dp) == f(dp)
        assert SP.cache_spec("unknown", 3, dp) == (dp, None, None)


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes, each on a fake group of its size
    (made and destroyed per mesh; the spec arithmetic outlives it)."""
    out = {}
    for name, multi in (("single", False), ("multi", True)):
        with fake_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            out[name] = mesh
    return out


def _ref_fitted(params, mesh_name):
    ctx = JSH.ShardCtx(StandInMesh(*MESHES[mesh_name]))
    specs = JSH.param_specs(params)
    return jax.tree_util.tree_map(
        lambda leaf, spec: P(*(ctx._fit(d, s)
                               for d, s in zip(leaf.shape, tuple(spec)))),
        params, specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_fitted_and_bytes_equal_reference(arch, meshes):
    """Spec for spec and byte for byte at (16, 16) and (2, 16, 16): the
    rule specs, the specs fitted to each mesh, ``sharded_bytes`` of the
    parameters and of the train state."""
    from repro_torch.models.sharding import param_shardings, param_specs

    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    port = M.init_model_abstract(cfg)
    ref = JM.init_model_abstract(jcfg)
    got = dict(leaf_paths(param_specs(port)))
    want = {p: tuple(s) for p, s in _jpaths(JSH.param_specs(ref)).items()}
    assert got == want
    hyper = TrainHyper(bf16_params=True, compress_grads=True)
    state = abstract_train_state(cfg, hyper)
    jstate = JS.abstract_train_state(jcfg, JS.TrainHyper(
        bf16_params=True, compress_grads=True))
    for name, mesh in meshes.items():
        fitted = dict(leaf_paths(fitted_specs(port, mesh)))
        jfit = _ref_fitted(ref, name)
        assert fitted == {p: tuple(s) for p, s in _jpaths(jfit).items()}, \
            name
        stand = StandInMesh(*MESHES[name])
        jsh = jax.tree_util.tree_map(
            lambda s: types.SimpleNamespace(spec=s), jfit,
            is_leaf=lambda x: isinstance(x, P))
        assert SP.sharded_bytes(port, param_shardings(port, mesh), mesh) \
            == JSP.sharded_bytes(ref, jsh, stand)
        # the train state: params, m, v, master, ef by the params' specs
        p_sh = jax.tree_util.tree_map(
            lambda s: types.SimpleNamespace(spec=s), _ref_fitted(
                jstate["params"], name), is_leaf=lambda x: isinstance(x, P))
        scalar = types.SimpleNamespace(spec=P())
        jst_sh = {"params": p_sh, "step": scalar, "ef": p_sh,
                  "opt": {"m": p_sh, "v": p_sh, "count": scalar,
                          "master": p_sh}}
        assert SP.sharded_bytes(state, SP.state_shardings(state, mesh),
                                mesh) == JSP.sharded_bytes(jstate, jst_sh,
                                                           stand)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_flop_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    port = M.init_model_abstract(cfg)
    ref = JM.init_model_abstract(jcfg)
    assert RF.count_params(port) == JRF.count_params(ref)
    assert RF.active_params(cfg, port) == JRF.active_params(jcfg, ref)
    for shape in shapes_for(cfg):
        assert RF.model_flops(cfg, port, shape, shape.kind) == \
            JRF.model_flops(jcfg, ref, JSHAPES[shape.name], shape.kind)


def test_default_microbatches_is_the_references():
    from repro_torch.launch.dryrun import default_microbatches

    for shape in SHAPES.values():
        for dp in (16, 32):
            assert default_microbatches(shape, dp) == max(
                1, shape.global_batch // dp)
