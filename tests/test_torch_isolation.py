"""The port stands alone: ``src/repro_torch`` and the chip scripts import
neither ``jax`` nor the JAX package ``repro`` (``repro_torch`` is not
``repro``), the package works with both blocked (stores written and
read, one on ``tiered:remote``; a smoke LM served), and without a card the default device raises
instead of running on the CPU."""
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
    REPO / "chip_mse_variants.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


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


def test_package_works_with_jax_and_reference_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(REPO / "src")!r})
        import importlib, pkgutil
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch import codec
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
        assert not any(k == "jax" or k.startswith("jax.") or k == "repro"
                       or k.startswith("repro.")
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


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
