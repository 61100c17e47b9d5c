"""The joint cell's program against its reference, on the CPU.

At ``configs/vss_paper.py``'s Visual Road 1K-75 scale (160x96, 75 %
overlap, seed 104): the objects ``apply_joint_compression`` stores equal
``reference/joint.py``'s encoding of the slices the program's homography
cuts, and both sides read back as the reference rebuilds them, within
the cell's limits.  Then the cell itself, shrunk (to the traffic's
``MIN_FRAME``, 320x180: at 160x96 the feature stage's homography is
1.00 px off this pair's true one, over the cell's ``h_error_px``; the
rehearsal's sound run holds the shift within it): each fault planted
under the timed path fails its own check.  The runs skip the look for a
card and the check of loaded modules, as the rehearsals do."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vssbench import harness
from vssbench.reference import joint as ref_joint
from vssbench.reference import tvc as ref_tvc

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import FULL, PKG  # noqa: E402
from test_vssbench_rehearsal import SEED, SHRINK  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
# (the joint cell's reference warps a 320x180 GOP op by op)
torch.set_num_threads(1)

CELL = "vroad-1k-75-joint"
LIMITS = json.loads((PKG / "workloads" / f"{CELL}.json").read_text())[
    "limits"]
TAU_DB = json.loads((PKG / "configs" / "vroad-1k-75.json").read_text())[
    "joint"]["tau_db"]
TIER = ref_tvc.tier("h264")
GOP = 30


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """The 1K-75 pair, two GOPs a camera, through the joint pass."""
    from repro_torch.configs.vss_paper import DATASETS
    from repro_torch.core.config import VSSConfig
    from repro_torch.core.store import VSS
    from repro_torch.data.video import synthesize_overlapping_pair

    d = next(d for d in DATASETS if d.name == "vroad-1k-75")
    left, right, _ = synthesize_overlapping_pair(
        2 * GOP, width=d.width, height=d.height, overlap=d.overlap,
        seed=d.seed)
    vss = VSS(str(tmp_path_factory.mktemp("vss")),
              config=VSSConfig(device="cpu"))
    for name, frames in (("cam_l", left), ("cam_r", right)):
        vss.write(name, frames, fps=30.0, codec="h264", gop_frames=GOP)
    ids = vss.apply_joint_compression(["cam_l", "cam_r"], tau_db=TAU_DB)
    clips = {"cam_l": left, "cam_r": right}
    yield vss, ids, clips
    vss.close()


def _recon(clip, i):
    return ref_tvc.encode(torch.from_numpy(clip[i * GOP:(i + 1) * GOP]),
                          TIER)[2]


def _side(vss, gop_id):
    g = vss.catalog.get_gop(gop_id)
    return vss.catalog.get_physical(g.physical_id).logical, \
        g.start_frame // GOP


def test_the_pass_stores_the_references_slices_and_reads_them_back(stored):
    vss, ids, clips = stored
    assert ids
    width, height = 160, 96
    for jid in ids:
        rec = vss.catalog.get_joint(jid)
        assert not rec["duplicate"]
        (a, i), (b, j) = _side(vss, rec["gop_a"]), _side(vss, rec["gop_b"])
        fa, fb = _recon(clips[a], i), _recon(clips[b], j)
        want_a, want_b = [], []
        for seg in rec["segments"]:
            h = np.asarray(seg["h"]).reshape(3, 3).astype(np.float32)
            cols = ref_joint.partition_columns(h, width, height)
            assert cols == (seg["x_f"], seg["x_g"])
            s, n = seg["start"], seg["num_frames"]
            cut = ref_joint.slices(fa[s:s + n], fb[s:s + n], *cols)
            recon = {}
            for part in ref_joint.PARTS:
                blob, recon[part] = ref_joint.encode(cut[part], TIER)
                assert vss.backend.get(seg["paths"][part]) == blob, part
            composite = torch.cat([recon["left"], recon["overlap"]], dim=2)
            want_a.append(composite)
            want_b.append(ref_joint.side_b(composite, recon["right"], h,
                                           cols[1]))
        got_a = torch.from_numpy(vss.read(
            a, t=(i, i + 1), cache=False).frames.copy())
        got_b = torch.from_numpy(vss.read(
            b, t=(j, j + 1), cache=False).frames.copy())
        assert torch.equal(got_a, torch.cat(want_a))
        diff = (got_b.to(torch.int16) - torch.cat(want_b).to(torch.int16))
        assert int(diff.abs().max()) <= LIMITS["side_b_pixel_diff_max"]
        assert ref_joint.psnr_min(got_b, fb) >= TAU_DB


HMATS = {
    "shift": [[1.0, 0.0, 40.25], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    "affine": [[1.02, 0.03, 38.0], [0.01, 0.99, -1.5], [0.0, 0.0, 1.0]],
    "projective": [[1.01, 0.02, 41.5], [0.004, 1.0, 0.7],
                   [2e-5, 1e-5, 1.0]],
}


@pytest.mark.parametrize("name", sorted(HMATS))
def test_the_references_warp_and_partition_are_the_programs(name):
    from repro_torch.core import joint
    from repro_torch.kernels import ref

    h = np.asarray(HMATS[name], np.float32)
    frames = np.random.default_rng(5).integers(
        0, 256, (3, 96, 160, 3)).astype(np.uint8)
    cols = joint.partition_columns(h, 160, 96)
    assert ref_joint.partition_columns(h, 160, 96) == cols
    planar = torch.from_numpy(frames).permute(0, 3, 1, 2).contiguous()
    want = ref.warp(planar, torch.from_numpy(h), (96, cols[1]))
    want = np.clip(np.round(want.numpy()), 0, 255).astype(np.uint8)
    got = ref_joint.warp(torch.from_numpy(frames), h, (96, cols[1]))
    assert np.array_equal(got.numpy(), want.transpose(0, 2, 3, 1))


def test_the_corner_error_of_the_true_shift_is_zero():
    h = np.asarray(HMATS["shift"])
    assert ref_joint.corner_error(h, 160, 96, 40.25) == 0.0
    assert ref_joint.corner_error(h, 160, 96, 32.25) == pytest.approx(8.0)


def test_blas_threads_holds_every_pool_and_gives_it_back():
    from vssbench.traffic import camera_joint

    pools = camera_joint._openblas_pools()
    assert pools  # numpy's OpenBLAS

    def widths():
        return [lib[affix.format("get_num_threads")]()
                for lib, affix in pools]

    before = widths()
    with camera_joint.blas_threads(1) as held:
        assert held == len(pools) and widths() == [1] * len(pools)
    assert widths() == before


def _checks(**kw):
    r = harness.execute(CELL, seed=SEED, seconds=0.4, trace=False,
                        device="cpu", shrink=SHRINK, bench=FULL,
                        own_process=False, **kw)
    return r["correct"], {k: v["value"] for k, v in r["checks"].items()}


def test_a_flipped_byte_in_a_joint_stream_is_caught(monkeypatch):
    from repro_torch.obs.instrument import InstrumentedBackend

    real = InstrumentedBackend.put

    def flipped(self, key, data):
        if key.startswith("_joint/") and key.endswith("_right.tvc"):
            data = data[:-1] + bytes([data[-1] ^ 0x01])
        real(self, key, data)

    monkeypatch.setattr(InstrumentedBackend, "put", flipped)
    correct, checks = _checks()
    assert not correct and checks["joint_streams_differing"] > 0


def test_a_homography_recorded_8_px_off_is_caught(monkeypatch):
    from repro_torch.core import joint

    real = joint._joint_compress

    def shifted(*a, **kw):
        res, outcome = real(*a, **kw)
        for seg in res.segments if res is not None else ():
            seg.h = seg.h + np.array([[0, 0, 8], [0, 0, 0], [0, 0, 0]],
                                     np.float32)
        return res, outcome

    monkeypatch.setattr(joint, "_joint_compress", shifted)
    correct, checks = _checks()
    assert not correct and checks["h_error_px"] > LIMITS["h_error_px"]


def test_a_gop_left_out_is_caught(monkeypatch):
    from repro_torch.core import store

    real = store.VSSWriter.append

    def dropped(self, frames):
        if self.name != "cam1":  # the warm-up's writer and camera 0 write
            real(self, frames)

    monkeypatch.setattr(store.VSSWriter, "append", dropped)
    correct, checks = _checks()
    assert not correct and checks["gops_missing"] > 0
