"""The port's dry run (``repro_torch.launch.dryrun``) on fake meshes:
every arch's smoke config traces its train, prefill and decode step on a
(2, 2) and a (2, 2, 2) mesh of torch's fake process group (tensors on
the meta device), and each record's numbers are sound: the resident
bytes are ``sharded_bytes`` of the tree laid out, FLOPs, HBM bytes and
link bytes are counted, and a sharded mesh moves bytes on its links.  A
fixture makes the fake default group and destroys it around each test,
so no other test sees it."""
import pytest

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.steps import TrainHyper, abstract_train_state
from repro_torch.models import model as M
from repro_torch.models.sharding import param_shardings

KINDS = ("train", "prefill", "decode")
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}


@pytest.fixture(params=list(MESHES))
def mesh(request):
    shape = MESHES[request.param]
    n = 1
    for s in shape:
        n *= s
    with fake_group(n):
        yield make_mesh(shape, device_type="cpu")


def _resident(cfg, shape, mesh, n_micro):
    if shape.kind == "train":
        st = abstract_train_state(cfg, TrainHyper(num_microbatches=n_micro))
        return specs.sharded_bytes(st, specs.state_shardings(st, mesh), mesh)
    params = M.init_model_abstract(cfg)
    cache = specs.cache_specs(cfg, shape.global_batch, shape.seq_len)
    return (specs.sharded_bytes(params, param_shardings(params, mesh), mesh)
            + specs.sharded_bytes(cache, specs.cache_shardings(cache, mesh),
                                  mesh))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_traces(arch, kind, mesh):
    cfg = smoke_config(arch)
    shape = ShapeSpec(kind, 32, 8, kind)
    rec = dryrun.trace(cfg, shape, mesh)
    r = rec["roofline"]
    assert rec["chips"] == mesh.size()
    assert rec["resident_bytes_per_chip"] == _resident(
        cfg, shape, mesh, rec["num_microbatches"])
    assert rec["ops_per_chip"] > 0 and r["flops_per_chip"] > 0
    assert r["hbm_bytes_per_chip"] > 0 and r["ici_bytes_per_chip"] > 0
    # at smoke widths 6·N·D counts the embedding lookup as matmul work,
    # so the useful fraction may pass 1; chip_smoke.py holds it in (0, 1]
    # at the published widths
    assert r["useful_flops_fraction"] > 0
    assert rec["params_total"] >= rec["params_active"] > 0


OPTIONS = {
    "constrain_scanned_params": dict(constrain_scanned_params=True),
    "sp_carry+save_tp": dict(sp_carry=True, remat_policy="save_tp"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek_moe_16b"])
def test_sharding_options_trace(arch, option, mesh):
    """The train step's sharding options trace and change what they
    should against the default step on the same mesh."""
    cfg = smoke_config(arch)
    shape = ShapeSpec("train", 32, 8, "train")
    base = dryrun.trace(cfg, shape, mesh)
    rec = dryrun.trace(cfg, shape, mesh, **OPTIONS[option])
    r, b = rec["roofline"], base["roofline"]
    assert rec["resident_bytes_per_chip"] == base["resident_bytes_per_chip"]
    if option == "constrain_scanned_params":
        # each group's parameters are at their rule placements already:
        # the constraints run (their ops are counted) and move nothing
        assert rec["ops_per_chip"] > base["ops_per_chip"]
        assert r["flops_per_chip"] == b["flops_per_chip"]
        assert r["ici_bytes_per_chip"] == b["ici_bytes_per_chip"]
    else:
        # the carry between groups is split over "model" on its sequence
        # axis (scattered after each group, gathered in the next), and
        # "save_tp" keeps the tagged outputs instead of recomputing them
        rs = "reduce-scatter"
        assert rec["collectives"][rs] > base["collectives"][rs]
        assert r["flops_per_chip"] < b["flops_per_chip"]


def test_cells_cli_prints_ok_and_fail_lines(capsys):
    """The reference's CLI lines: one ``OK`` per traced cell and the
    count (a smoke config stands in for the published one)."""
    real = dryrun.get_config
    dryrun.get_config = smoke_config
    try:
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "qwen3-32b", "--shape", "decode_32k",
                         "--mesh", "single"])
    finally:
        dryrun.get_config = real
    out = capsys.readouterr().out
    assert e.value.code == 0
    assert out.startswith("OK   qwen3_32b × decode_32k × single:")
    assert "1 cells OK, 0 failed" in out
