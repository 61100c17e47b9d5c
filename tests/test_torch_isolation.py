"""The port stands alone: ``src/repro_torch`` and the chip scripts import
neither ``jax`` (nor ``jaxlib`` or ``ml_dtypes``) nor the JAX package
``repro`` (``repro_torch`` is not ``repro``), the package works with
them blocked (stores written and read, one on ``tiered:remote``; a smoke
LM served, and a recurrent and an encoder-decoder smoke LM prefilled and
stepped; the video service answering one read; two train steps of a
smoke LM and a checkpoint of its state saved and restored; a sharded
step on a (1, 1) gloo mesh and a decode step traced on a fake (2, 2)
mesh), and without
a card the default device raises instead of running on the CPU."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_breakdown.py",
    REPO / "chip_cublas_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    root = module.split(".")[0]
    return root in FORBIDDEN


def test_forbidden_matcher_separates_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.codec.tvc")
    assert _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_joint_compression_imports_nothing_of_the_store():
    """The store drives joint compression and imports it; joint
    compression reaches the store only through the object it is handed."""
    path = REPO / "src" / "repro_torch" / "core" / "joint.py"
    assert "repro_torch.core.store" not in set(_imported_modules(path))
    assert "store" not in {
        alias.name for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.ImportFrom)
        and node.module == "repro_torch.core" for alias in node.names}


def test_package_works_with_jax_and_reference_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.modules["ml_dtypes"] = None
        sys.path.insert(0, {str(REPO / "src")!r})
        import importlib, pkgutil
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch import codec
        from repro_torch.configs import vss_paper
        assert len(vss_paper.DATASETS) == 7 and vss_paper.CONFIG.gamma == 2.0
        from repro_torch.core import VSS, VSSConfig
        clip = np.random.default_rng(0).integers(
            0, 256, (5, 16, 24, 3)).astype(np.uint8)
        blob = codec.serialize_gop(codec.encode_gop(clip, "lossless",
                                                    device="cpu"))
        out = codec.decode_gop(codec.deserialize_gop(blob), device="cpu")
        assert np.array_equal(out, clip)
        vss = VSS({str(tmp_path / "s")!r},
                  config=VSSConfig(device="cpu", backend="memory"))
        vss.write("v", clip, codec="tvc-ll")
        assert np.array_equal(vss.read("v").frames, clip)
        vss.close()
        # the write-back tier over the loopback object server, with its
        # journal, and the metrics server, all the port's own
        cfg = VSSConfig(device="cpu", backend="tiered:remote")
        vss = VSS({str(tmp_path / "r")!r}, config=cfg)
        vss.write("v", clip, codec="tvc-ll")
        url = vss.start_metrics_server().url
        import urllib.request
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert b"vss_cache_writeback" in r.read()
        vss.close()
        vss = VSS({str(tmp_path / "r")!r}, config=cfg)
        assert np.array_equal(vss.read("v").frames, clip)
        vss.close()
        import torch
        from repro_torch.configs import smoke_config
        from repro_torch.models import model as M
        from repro_torch.serving import ServingEngine
        cfg = smoke_config("qwen3-32b")
        lm = M.init_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        eng = ServingEngine(cfg, lm, page_size=8, num_pages=16)
        rid = eng.submit(list(range(3, 23)), max_new=3)
        out = eng.run()[rid].out
        assert len(out) == 3 and eng.metrics["decode_steps"] == 3
        # the dense-cache path of a recurrent and an encoder-decoder family
        for arch, extra in (("xlstm-1.3b", {{}}), ("whisper-large-v3", {{
                "frames": torch.zeros((1, 16, 32))}})):
            lm = M.init_model(smoke_config(arch), device="cpu",
                              generator=torch.Generator().manual_seed(0))
            cache = M.init_cache(lm, 1, 12)
            M.prefill(lm, torch.arange(3, 11)[None], cache, **extra)
            logits, cache = M.decode_step(lm, cache, torch.tensor([[5]]))
            assert logits.shape == (1, 1, 512) and int(cache["pos"][0]) == 9
        # the video service over a CPU store: one read, one segment
        import json
        from repro_torch.serving.config import boot_from_json
        vss, svc = boot_from_json({{
            "root": {str(tmp_path / "svc")!r},
            "store": {{"device": "cpu", "backend": "local"}}}})
        vss.write("v", clip, codec="hevc")
        req = urllib.request.Request(
            svc.url + "/v1/read", method="POST",
            data=json.dumps({{"name": "v", "codec": "hevc"}}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            manifest = json.loads(r.read())
        with urllib.request.urlopen(
                svc.url + manifest["segments"][0]["url"], timeout=30) as r:
            seg = codec.deserialize_gop(r.read())
        assert np.array_equal(codec.decode_gop(seg, device="cpu"),
                              vss.read("v", cache=False).frames)
        svc.close()
        vss.close()
        # two train steps of a smoke LM, and a checkpoint of its state
        from repro_torch.launch.steps import (
            TrainHyper, init_train_state, make_train_step)
        from repro_torch.train.checkpoint import CheckpointManager
        from repro_torch.tree import leaves
        cfg = smoke_config("phi3-mini-3.8b")
        hyper = TrainHyper(num_microbatches=2, warmup_steps=1,
                           total_steps=4, bf16_params=True)
        state = init_train_state(0, cfg, hyper, device="cpu")
        step = make_train_step(cfg, hyper)
        rng = np.random.default_rng(0)
        batch = {{k: rng.integers(0, 512, (2, 8)).astype(np.int32)
                 for k in ("tokens", "labels")}}
        for _ in range(2):
            state, metrics = step(state, batch)
        assert int(state["step"]) == 2 and np.isfinite(float(
            metrics["loss"]))
        ck = CheckpointManager({str(tmp_path / "ck")!r}, device="cpu",
                               derived_reprs=("bf16",))
        ck.save(2, state)
        back, at = ck.restore(like=init_train_state(0, cfg, hyper,
                                                    device="meta"))
        assert at == 2
        for a, b in zip(leaves(state), leaves(back)):
            b = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
            assert a.dtype == b.dtype and torch.equal(a, b)
        ck.close()
        # the launch layer: a sharded step on a (1, 1) gloo mesh, and a
        # decode step traced on a fake (2, 2) mesh under the op counter
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import (
            fake_group, host_group, make_host_mesh, make_mesh)
        from repro_torch.launch.specs import distribute_state, full_state
        from repro_torch.models.sharding import ShardCtx
        with host_group("cpu"):
            mesh = make_host_mesh("cpu")
            state = init_train_state(0, cfg, hyper, device="cpu")
            sharded = make_train_step(cfg, hyper, ShardCtx(mesh))
            new, _m = sharded(distribute_state(state, mesh), batch)
            assert int(full_state(new)["step"]) == 1
        with fake_group(4):
            rec = dryrun.trace(cfg, ShapeSpec("d", 16, 4, "decode"),
                               make_mesh((2, 2), device_type="cpu"))
            assert rec["roofline"]["ici_bytes_per_chip"] > 0
        assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro",
                                           "ml_dtypes")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_default_device_raises_without_cuda(tmp_path):
    import torch

    from repro_torch.core import VSS, VSSConfig

    assert VSSConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        VSS(str(tmp_path / "s"))
    assert not (tmp_path / "s").exists()  # raised before touching disk
    # the recurrent layers' decode states, built on their own
    from repro_torch.models import recurrent as R

    for make in (lambda **kw: R.rglru_init_state(2, 8, **kw),
                 lambda **kw: R.mlstm_init_state(2, R.MLstmCfg(16, 2), **kw),
                 lambda **kw: R.slstm_init_state(2, R.SLstmCfg(16, 2), **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert all(t.device.type == "cpu"
                   for t in make(device="cpu").values())


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_training_entry_points_raise_without_cuda(tmp_path):
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import TrainHyper, init_train_state
    from repro_torch.train import CheckpointManager, Trainer

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg, hyper = smoke_config("phi3-mini-3.8b"), TrainHyper()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(0, cfg, hyper)
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path / "ck"))  # its default store
    ck = CheckpointManager(str(tmp_path / "ck_cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, hyper, pipeline=None, ckpt=ck)
    Trainer(cfg, hyper, pipeline=None, ckpt=ck, device="cpu")
    # a mesh is on the card unless the caller asks for the host, and a
    # trainer never moves to its mesh's device on its own
    from repro_torch.launch.mesh import (
        fake_group, host_group, make_mesh, make_production_mesh)
    with fake_group(256):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()
    with host_group("cpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 1))
        mesh = make_mesh((1, 1), device_type="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, hyper, pipeline=None, ckpt=ck, mesh=mesh)
        with pytest.raises(ValueError, match="'meta'"):
            Trainer(cfg, hyper, pipeline=None, ckpt=ck, mesh=mesh,
                    device="meta")
        t = Trainer(cfg, hyper, pipeline=None, ckpt=ck, device="meta")
        with pytest.raises(ValueError, match="'meta'"):
            t.resume(mesh=mesh)
        assert t.mesh is None
        Trainer(cfg, hyper, pipeline=None, ckpt=ck, mesh=mesh, device="cpu")
        # nor is a state copied onto a mesh of another device
        from repro_torch.launch.mesh import _mesh
        from repro_torch.launch.specs import distribute_state
        state = init_train_state(0, cfg, hyper, device="cpu")
        with pytest.raises(ValueError, match="'cpu' given to a mesh on"
                           " 'meta'"):
            distribute_state(state, _mesh("meta", (1, 1),
                                          ("data", "model")))
    ck.close()
