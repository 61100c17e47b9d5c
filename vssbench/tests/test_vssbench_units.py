"""Traffic generators are deterministic for a seed, the roofline byte
counts match a count by hand, and nothing under ``vssbench/`` imports JAX
or the JAX package (``reference/`` not the program either)."""
import ast
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vssbench import harness, rooflines
from vssbench.reference import tvc as ref_tvc
from vssbench.reference import view as ref_view
from vssbench.traffic import frames, view_reads

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "vssbench"
SEED = 2 ** 40 + 123
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import BENCH, FULL  # noqa: E402


def _run(cell, seed=SEED, seconds=1.0):
    return harness.Run(cell, seed=seed, seconds=seconds, trace=False,
                       device="cpu", bench=FULL)


def _take(run, n):
    n_frames = int(run.config["seconds"] * run.config["fps"])
    return list(itertools.islice(view_reads.requests(run, n_frames, "w"), n))


@pytest.mark.parametrize("cell", ["vroad-2k-long-reads",
                                  "vroad-2k-short-reads"])
def test_read_traffic_is_deterministic_for_a_seed(cell):
    a, b = _run(cell), _run(cell)
    try:
        assert _take(a, 60) == _take(b, 60)
        other = _take(_run(cell, SEED + 1), 60)
        if a.traffic.get("order", "seeded") == "fixed":
            assert _take(a, 60) == other  # the seed draws only the scene
        else:
            assert _take(a, 60) != other
    finally:
        for r in (a, b):
            r.cleanup()


@pytest.mark.parametrize("cell", ["vroad-2k-long-reads",
                                  "vroad-2k-short-reads"])
def test_two_seeds_read_the_same_blocks_in_another_order(cell):
    a, b = _run(cell), _run(cell, SEED + 9)
    block = a.traffic["block"]
    n_frames = int(a.config["seconds"] * a.config["fps"])
    gop = a.config["gop_frames"]

    def reads(run):
        out = []
        for p in _take(run, 3 * block):
            f0 = p["f0"] % gop if cell.endswith("short-reads") else p["f0"]
            out.append((f0, p["f1"] - p["f0"], p["codec"], p["scale"]))
        return out

    try:
        ra, rb = reads(a), reads(b)
        if a.traffic.get("order", "seeded") == "fixed":
            # one sequence for every seed; blocks drawn afresh, in the
            # mix's shares, and the warm-up's apart from the window's
            assert ra == rb
            assert ra[:block] != ra[block:2 * block]
            warm = list(itertools.islice(
                view_reads.requests(a, n_frames, "warm"), block))
            assert [(p["f0"], p["f1"]) for p in warm] != \
                [(f0, f0 + n) for f0, n, _, _ in ra[:block]]
            for k in range(3):
                blk = ra[k * block:(k + 1) * block]
                assert sorted(r[2:] for r in blk) == \
                    sorted(r[2:] for r in ra[:block])
        else:
            assert ra != rb
            for k in range(3):
                blk = slice(k * block, (k + 1) * block)
                assert sorted(ra[blk]) == sorted(rb[blk]) == \
                    sorted(ra[:block])
        lo, hi = a.traffic["length_frames"]
        for p in _take(a, block):
            assert lo <= p["f1"] - p["f0"] <= hi and p["f1"] <= n_frames
    finally:
        a.cleanup(), b.cleanup()


def test_zipf_slots_favour_recent_seconds():
    slots = view_reads._zipf_slots(20, 1.1, 20)
    assert slots.count(19) > slots.count(0)
    assert all(0 <= s < 20 for s in slots)


def test_frames_are_deterministic_for_a_seed():
    def draw(seed):
        sc = frames.make_scene(54, 96, cameras=2, overlap=0.3, seed=seed,
                               device="cpu")
        return frames.render(sc, 0, 4, camera=1)

    a, b, c = draw(5), draw(5), draw(6)
    assert a.shape == (4, 54, 96, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    # moving content: consecutive frames differ, but not like noise
    d = (a[1:].float() - a[:-1].float()).abs().mean().item()
    assert 0.5 < d < 40


def test_subseeds_take_seeds_past_32_bits():
    r = _run("vroad-4k-ingest", seed=2 ** 31 + 12345)
    try:
        s = r.subseed("scene")
        assert 0 <= s < 2 ** 63 and s != _run("vroad-4k-ingest").subseed(
            "scene")
    finally:
        r.cleanup()


@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840)])
def test_roofline_bytes_match_a_count_by_hand(h, w):
    plane = 3 * h * w
    iframe = torch.empty((3, h, w), dtype=torch.float32, device="meta")
    resid = torch.empty((29, 3, h, w), dtype=torch.int8, device="meta")
    frames = torch.empty((30, 3, h, w), dtype=torch.float32, device="meta")
    # decode: f32 I-frame + 29 int8 residual planes in, 30 f32 frames out
    by_hand = 4 * plane + 29 * plane + 30 * 4 * plane
    assert rooflines.io_bytes((iframe, resid), (frames,)) == by_hand
    # encode: 30 f32 frames in, f32 I-frame + 29 int8 planes out; the
    # scalars among the arguments hold no bytes
    by_hand = 30 * 4 * plane + 4 * plane + 29 * plane
    assert rooflines.io_bytes((frames, 8.0, -128, 127), (iframe, resid)) \
        == by_hand
    if h == 1080:  # 0.9518e9 bytes: 0.2841 ms at 3.35 TB/s (§6's table)
        assert abs(rooflines.bound_seconds(by_hand) - 2.8413e-4) < 1e-7


def test_reference_codec_round_trips_its_own_blob():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (5, 6, 8, 3), dtype=np.uint8))
    t = ref_tvc.tier("h264")
    iframe, resid, recon = ref_tvc.encode(x, t)
    blob = ref_tvc.blob(iframe, resid, t, x.shape)
    codec, shape, offsets, payload = ref_tvc.parse(blob)
    assert codec == "tvc-med" and shape == tuple(x.shape)
    back = ref_tvc.decode_payload(codec, shape, offsets, payload, "cpu")
    assert torch.equal(back, recon)
    assert (recon.int() - x.int()).abs().max() <= 4


def test_reference_box_mean_rounds_half_to_even():
    x = torch.tensor([[[[1], [2]], [[1], [2]]]], dtype=torch.uint8)
    assert ref_view.box_mean(x, 2).item() == 2  # 1.5 -> 2
    x = torch.tensor([[[[2], [3]], [[2], [3]]]], dtype=torch.uint8)
    assert ref_view.box_mean(x, 2).item() == 2  # 2.5 -> 2


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert not roots & {"jax", "jaxlib", "flax", "repro"}, path
    if "reference" in path.parts:
        assert "repro_torch" not in roots, path


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in harness.forbidden_modules()


def test_the_command_prints_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, str(ROOT / "vssbench" / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_entry_is_timed_by_its_kernels_names_on_the_device():
    """By what the entry launched, whatever its kernels are called."""
    from vssbench import devtrace

    ev = devtrace._Event
    events = [
        ev("vss.kernel.delta_encode", False, 0, 2500, corr=900, thread=1),
        ev("vss.kernel.delta_decode", False, 9000, 9600, corr=901, thread=2),
        # launched inside delta_encode's range, on its thread
        ev("cudaLaunchKernel", False, 100, 200, corr=7, thread=1),
        ev("fused_codec_v2(float const*)", True, 300, 2300, corr=7),
        # a copy launched after the range closed
        ev("cudaMemcpyAsync", False, 2600, 2700, corr=8, thread=1),
        ev("Memcpy HtoD (Pageable -> Device)", True, 2700, 9000, corr=8),
        # inside the time of delta_encode's range, on another thread
        ev("cuLaunchKernelEx", False, 150, 250, corr=9, thread=3),
        ev("delta_encode_kernel", True, 2300, 2400, corr=9),
        # no launch event; linked to delta_decode's range
        ev("delta_decode_kernel<short>", True, 9100, 9600, corr=10,
           linked=901),
    ]
    got = devtrace._entry_seconds(events)
    assert got == {"delta_encode": 2e-6, "delta_decode": 5e-7}
