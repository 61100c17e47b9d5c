"""Joint compression (§5.1) in the port against the reference, on the CPU.

The same seeded inputs go through both packages: the warp and histogram
plain versions against ``repro.kernels.ref`` (and the Pallas kernels in
interpret mode), feature matching, fingerprints and the candidate
search, Algorithm 1, and whole stores.  Everything is exact except the
warp against the Pallas kernel, whose bilinear tail associates
differently from the oracle (atol 5e-2, the reference's own).  The CUDA
kernels run only on the card; ``chip_smoke.py`` holds each against its
plain version there and drives this path at 1920x1080."""
import json
import os
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeatures
from repro.core import fingerprint as jfingerprint
from repro.core import joint as jjoint
from repro.core.config import VSSConfig as JConfig
from repro.core.store import VSS as JVSS
from repro.core.store import resample as jresample
from repro.data.video import synthesize_overlapping_pair
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import features as tfeatures
from repro_torch.core import fingerprint as tfingerprint
from repro_torch.core import joint as tjoint
from repro_torch.core.config import VSSConfig as TConfig
from repro_torch.core.quality import exact_psnr
from repro_torch.core.store import VSS as TVSS
from repro_torch.kernels import _build, ops, ref

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)

HMAT = np.array([[1.02, 0.03, 2.0], [0.01, 0.99, -1.5], [2e-5, 1e-5, 1.0]],
                np.float32)
# the third row crosses 0 inside the output: source coordinates there
# are huge, infinite or NaN (the int32 conversion saturates, NaN -> 0)
Z_CROSSING = np.array([[0.5, 0.3, -40.0], [0.1, 2.0, 5.0],
                       [-0.013, 0.021, 0.3]], np.float32)
ZERO_FILL = np.array([[1.0, 0.0, 90.0], [0.0, 1.0, -20.0], [0.0, 0.0, 1.0]],
                     np.float32)


def _img(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float32)


def _pair_h(seed=1, width=160, height=96):
    return synthesize_overlapping_pair(1, width=width, height=height,
                                       seed=seed)[2]


def _same_warp(a, b):
    """Equal values, NaN where the other has NaN (a source coordinate of
    0/0 or inf - inf makes the bilinear weights NaN in both packages)."""
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- warp -----------------------------------------------------------------

WARP_CASES = {
    # the shapes of tests/test_kernels.py::test_warp_matches_oracle
    "32x160": ((32, 160), (32, 160), HMAT),
    "24x136->16x128": ((24, 136), (16, 128), HMAT),
    "64x256->40x200": ((64, 256), (40, 200), HMAT),
    "pair-inverse": ((96, 160), None, "pair_inv"),
    "pair-forward-overlap": ((96, 160), (96, 80), "pair"),
    "zero-fill": ((17, 130), (13, 97), ZERO_FILL),
    "z-crosses-0": ((40, 200), (64, 256), Z_CROSSING),
}


def _warp_hmat(which):
    if isinstance(which, str):
        h = _pair_h()
        return np.linalg.inv(h) if which == "pair_inv" else h
    return which


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_plain_matches_reference(case):
    (h, w), out_shape, which = WARP_CASES[case]
    img = _img(h * w, 3, h, w)
    hinv = _warp_hmat(which)
    want = jref.warp(jnp.asarray(img), jnp.asarray(hinv, jnp.float32),
                     out_shape=out_shape)
    got = ref.warp(torch.from_numpy(img), torch.from_numpy(
        np.asarray(hinv, np.float32)), out_shape)
    _same_warp(got.numpy(), want)
    if case == "z-crosses-0":
        assert np.isnan(got.numpy()).any()  # the case reaches 0/0 and inf


def test_warp_coordinate_row_is_one_fused_multiply_add():
    """The reference's 3x3 product rounds each row as fma(m1, y, m0*x) +
    m2; the plain (m0*x + m1*y) + m2 differs in many values, which is why
    ``ref.fma_f32`` exists."""
    h = np.linalg.inv(_pair_h(seed=1, width=480, height=270)).astype(
        np.float32)
    ys, xs = np.mgrid[0:270, 0:480].astype(np.float32)
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pts = np.stack([xs, ys, np.ones_like(xs)])
    want = np.asarray(jnp.asarray(h) @ jnp.asarray(pts))
    mismatches = 0
    for r in range(3):
        fused = ref.fma_f32(torch.tensor(h[r, 1]), torch.from_numpy(ys),
                            torch.tensor(h[r, 0]) * torch.from_numpy(xs))
        np.testing.assert_array_equal((fused + float(h[r, 2])).numpy(),
                                      want[r])
        plain = (h[r, 0] * xs + h[r, 1] * ys) + h[r, 2]
        mismatches += int((plain != want[r]).sum())
    assert mismatches > 0


@pytest.mark.parametrize("a,b,c,want", [
    # a*b = 4098 + 2**-12, halfway between two f32: the addend breaks the
    # tie, though it is lost when the sum is first rounded to f64
    (4097.0, 1 + 2 ** -12, 2 ** -60, 4098 + 2 ** -11),
    (4097.0, 1 + 2 ** -12, -(2 ** -60), 4098.0),
    (4097.0, 1 + 2 ** -12, 0.0, 4098.0),  # a true tie: to even
    # the f32 product 3 * f32(1/3) rounds to 1; the fused one keeps 2**-25
    (3.0, float(np.float32(1 / 3)), -1.0, 2 ** -25),
])
def test_fma_f32_rounds_once(a, b, c, want):
    got = ref.fma_f32(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    assert got.dtype == torch.float32 and float(got) == want


def test_int32_conversion_saturates_like_xla():
    x = torch.tensor([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5],
                     dtype=torch.float32)
    got = ref.to_int32_saturating(x).tolist()
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32)).tolist()
    assert got == want == [0, 2 ** 31 - 1, -(2 ** 31), 2 ** 31 - 1,
                           -(2 ** 31), 2, -2]


def test_warp_plain_matches_pallas_interpret():
    img = _img(7, 3, 64, 256)
    want = jops.warp(jnp.asarray(img), jnp.asarray(HMAT), out_shape=(40, 128),
                     use_pallas=True)
    got = ops.warp(torch.from_numpy(img), HMAT, out_shape=(40, 128))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_warp_frames_axis_equals_single_frame_calls(dtype):
    frames = torch.from_numpy(_img(8, 4, 3, 24, 40)).to(dtype)
    batched = ops.warp(frames, Z_CROSSING, out_shape=(20, 44))
    assert batched.shape == (4, 3, 20, 44) and batched.dtype == torch.float32
    for t in range(4):
        _same_warp(batched[t].numpy(),
                   ops.warp(frames[t], Z_CROSSING, out_shape=(20, 44)).numpy())


# -- histogram ------------------------------------------------------------

@pytest.mark.parametrize("n,c,h,w,bins", [
    (1, 3, 16, 130, 16), (4, 3, 33, 128, 32), (2, 1, 8, 256, 8),
    (2, 3, 17, 130, 7),
])
def test_histogram_plain_matches_reference(n, c, h, w, bins):
    x = _img(n * h + bins, n, c, h, w)
    want = np.asarray(jref.histogram(jnp.asarray(x), bins=bins))
    got = ops.histogram(torch.from_numpy(x), bins=bins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == n * c * h * w
    if w % 128 == 0:
        np.testing.assert_array_equal(got, np.asarray(jops.histogram(
            jnp.asarray(x), bins=bins, use_pallas=True)))


def test_histogram_out_of_range_values_like_reference():
    x = _img(3, 1, 2, 4, 8)
    x[0, 0, 0, :6] = [-1.5, -0.3, 255.9, 1e10, np.nan, -np.inf]
    for vmax in (255.0, 100.0):
        np.testing.assert_array_equal(
            ref.histogram(torch.from_numpy(x), bins=16, vmax=vmax).numpy(),
            np.asarray(jref.histogram(jnp.asarray(x), bins=16, vmax=vmax)))


# -- features, fingerprints, candidate search -----------------------------

def test_features_match_reference(overlap_pair):
    left, right, _h = overlap_pair
    for seed in (0, 1):
        a = jfeatures.estimate_homography(left[0], right[0], seed=seed)
        b = tfeatures.estimate_homography(left[0], right[0], seed=seed)
        np.testing.assert_array_equal(a, b)
    assert (jfeatures.count_correspondences(left[0], right[0])
            == tfeatures.count_correspondences(left[0], right[0]))


def test_fingerprint_and_candidate_pairs_match_reference(overlap_pair, clip):
    left, right, _h = overlap_pair
    other = synthesize_overlapping_pair(2, width=160, height=96, seed=5)[0]
    cams = {1: left[:2], 2: right[:2], 3: other}
    for frames in cams.values():
        np.testing.assert_array_equal(
            tfingerprint.gop_fingerprint(frames, device="cpu"),
            jfingerprint.gop_fingerprint(frames))
    j = jfingerprint.CandidateIndex()
    t = tfingerprint.CandidateIndex(device="cpu")
    for key, frames in cams.items():
        j.add_gop(key, frames)
        t.add_gop(key, frames)
    assert [c.members for c in t.birch.clusters] == [
        c.members for c in j.birch.clusters]
    assert t.find_pairs() == j.find_pairs()


# -- Algorithm 1 ----------------------------------------------------------

def _pan_pair():
    left, right, _h = synthesize_overlapping_pair(
        6, width=160, height=96, overlap=0.5, seed=1, pan_speed=4.0)
    return left, right


def _same_result(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (b.duplicate, b.reversed) == (a.duplicate, a.reversed)
    assert (b.psnr_f, b.psnr_g) == (a.psnr_f, a.psnr_g)
    assert len(b.segments) == len(a.segments)
    for sa, sb in zip(a.segments, b.segments):
        assert (sb.start, sb.num_frames, sb.x_f, sb.x_g) == (
            sa.start, sa.num_frames, sa.x_f, sa.x_g)
        np.testing.assert_array_equal(sb.h, sa.h)
        for part in ("left", "overlap", "right"):
            np.testing.assert_array_equal(getattr(sb, part),
                                          getattr(sa, part))


@pytest.mark.parametrize("case", ["mean", "unprojected", "reversed", "pan"])
def test_joint_compress_frames_matches_reference(overlap_pair, case):
    left, right, _h = overlap_pair
    f, g, merge = left[:6], right[:6], "mean"
    if case == "unprojected":
        merge = "unprojected"
    elif case == "reversed":
        f, g = g, f  # g lies left of f: Algorithm 1 swaps the pair
    elif case == "pan":
        f, g = _pan_pair()
    a = jjoint.joint_compress_frames(f, g, merge=merge, tau_db=24.0)
    before = _build.plain_counts().get("warp", 0)
    b = tjoint.joint_compress_frames(f, g, merge=merge, tau_db=24.0,
                                     device="cpu")
    _same_result(a, b)
    if case == "reversed":
        # every candidate H maps g's left edge to a negative column of f,
        # so partition_columns rejects it before any warp and Algorithm 1
        # aborts: the reference never reaches its swap for such a pair,
        # and the port copies that
        assert b is None
        return
    assert _build.plain_counts().get("warp", 0) > before
    assert b is not None
    if case == "pan":
        # the pan drifts the homography: the verify step fails, H is
        # re-estimated and the GOP splits into a second segment
        assert len(b.segments) >= 2


def test_warp_frames_matches_reference(overlap_pair):
    left, _right, h = overlap_pair
    for hinv, out_hw in ((np.linalg.inv(h), None), (h, (96, 70)),
                         (Z_CROSSING, (50, 90))):
        np.testing.assert_array_equal(
            tjoint.warp_frames(left[:3], hinv, out_hw, device="cpu"),
            jjoint.warp_frames(left[:3], hinv, out_hw))


# -- stores ---------------------------------------------------------------

def _jstore(root):
    return JVSS(str(root), config=JConfig(backend="local"))


def _tstore(root):
    return TVSS(str(root), config=TConfig(backend="local", device="cpu"))


def _joint_rows(root):
    con = sqlite3.connect(os.path.join(root, "catalog.sqlite"))
    try:
        joint = con.execute("SELECT * FROM joint ORDER BY id").fetchall()
        gops = con.execute("SELECT * FROM gop ORDER BY id").fetchall()
    finally:
        con.close()
    return joint, gops


def _objects(root):
    base = os.path.join(root, "objects")
    out = {}
    for d, _dirs, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), base)] = fh.read()
    return out


def _store_case(case, overlap_pair, clip):
    """The cameras, codec and merge of each store-level case."""
    left, right, _h = overlap_pair
    if case == "duplicate":
        return {"a": clip[:12], "b": clip[:12].copy()}, "mean"
    if case == "mixed-resolution":
        # b at half resolution: Algorithm 1 upscales it by exactly 2 (the
        # bilinear weights are 1/4 and 3/4, so both packages' sums are
        # exact) and records g_scale for the read back.  a has the same
        # blur, or its corners find no match in the upscaled b.
        def half(x):
            x = x.reshape(12, 48, 2, 80, 2, 3).mean((2, 4))
            return np.round(x).astype(np.uint8)
        return {"a": jresample(half(left), (160, 96)), "b": half(right)}, \
            "mean"
    return {"a": left, "b": right}, case


STORE_CASES = ["mean", "unprojected", "duplicate", "mixed-resolution"]


@pytest.mark.parametrize("case", STORE_CASES)
def test_store_joint_compression_matches_reference(tmp_path, overlap_pair,
                                                   clip, case):
    cams, merge = _store_case(case, overlap_pair, clip)
    roots, ids, reads = [], [], []
    for make, name in ((_jstore, "j"), (_tstore, "t")):
        vss = make(tmp_path / name)
        for cam, frames in cams.items():
            vss.write(cam, frames, fps=30.0, codec="tvc-hi", gop_frames=6)
        if case == "mixed-resolution":
            # across a 2x scale the candidate search finds no matching
            # corners, so the pair goes to Algorithm 1 directly
            gops = [vss.catalog.gops_for(vss.catalog.get_original_id(c))[0]
                    for c in cams]
            joint = jjoint if name == "j" else tjoint
            jid = joint.jointly_compress_gops(
                vss, gops[0].gop_id, gops[1].gop_id, merge=merge,
                tau_db=24.0)
            ids.append([jid] if jid is not None else [])
        else:
            ids.append(vss.apply_joint_compression(list(cams), merge=merge,
                                                   tau_db=24.0))
        reads.append([vss.read(cam, codec="rgb", cache=False).frames
                      for cam in cams])
        vss.close()
        roots.append(str(tmp_path / name))
    assert ids[0] and ids[1] == ids[0]
    assert _joint_rows(roots[1]) == _joint_rows(roots[0])
    assert _objects(roots[1]) == _objects(roots[0])
    for a, b in zip(*reads):
        np.testing.assert_array_equal(b, a)
    joint = _joint_rows(roots[1])[0]
    if case == "duplicate":
        assert all(row[7] == 1 for row in joint)  # pointer, no pixels
    else:
        segs = json.loads(joint[0][4])
        assert segs and all(len(s["h"]) == 9 for s in segs)
    if case == "mixed-resolution":
        assert joint[0][5] == 2.0  # g_scale
        assert reads[1][1].shape == cams["b"].shape


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_joint_store_cross_opens(tmp_path, overlap_pair, writer):
    left, right, _h = overlap_pair
    first, second = ((_jstore, _tstore) if writer == "reference"
                     else (_tstore, _jstore))
    root = tmp_path / "s"
    vss = first(root)
    vss.write("cam_l", left, fps=30.0, codec="tvc-hi", gop_frames=6)
    vss.write("cam_r", right, fps=30.0, codec="tvc-hi", gop_frames=6)
    assert vss.apply_joint_compression(["cam_l", "cam_r"], merge="mean",
                                       tau_db=24.0)
    want = [vss.read(c, codec="rgb", cache=False).frames
            for c in ("cam_l", "cam_r")]
    vss.close()
    vss = second(root)
    for cam, frames in zip(("cam_l", "cam_r"), want):
        np.testing.assert_array_equal(
            vss.read(cam, codec="rgb", cache=False).frames, frames)
    vss.close()


# -- the behaviours of tests/test_joint.py, on the port ----------------------

@pytest.fixture()
def tvss(tmp_path):
    store = _tstore(tmp_path / "vss")
    yield store
    store.close()


def _write_pair(vss, left, right, gop=6):
    vss.write("cam_l", left, fps=30.0, codec="tvc-hi", gop_frames=gop)
    vss.write("cam_r", right, fps=30.0, codec="tvc-hi", gop_frames=gop)


def test_port_joint_compression_saves_storage_and_recovers(tvss,
                                                           overlap_pair):
    left, right, _ = overlap_pair
    _write_pair(tvss, left, right)
    before = (tvss.catalog.total_bytes("cam_l")
              + tvss.catalog.total_bytes("cam_r"))
    assert tvss.apply_joint_compression(["cam_l", "cam_r"], merge="mean",
                                        tau_db=24.0)
    after = (tvss.catalog.total_bytes("cam_l")
             + tvss.catalog.total_bytes("cam_r"))
    assert after < before
    rl = tvss.read("cam_l", codec="rgb", cache=False).frames
    rr = tvss.read("cam_r", codec="rgb", cache=False).frames
    assert exact_psnr(rl, left) >= 24.0
    assert exact_psnr(rr, right) >= 24.0


def test_port_unprojected_merge_keeps_left_lossless(tvss, overlap_pair):
    left, right, _ = overlap_pair
    _write_pair(tvss, left, right)
    assert tvss.apply_joint_compression(["cam_l", "cam_r"],
                                        merge="unprojected", tau_db=24.0)
    rl = tvss.read("cam_l", codec="rgb", cache=False).frames
    rr = tvss.read("cam_r", codec="rgb", cache=False).frames
    assert exact_psnr(rl, left) >= exact_psnr(rr, right) - 1.0
    assert exact_psnr(rl, left) >= 30.0


def test_port_duplicate_frames_become_pointer(tvss, clip):
    tvss.write("cam_a", clip[:12], fps=30.0, codec="tvc-hi", gop_frames=6)
    tvss.write("cam_b", clip[:12].copy(), fps=30.0, codec="tvc-hi",
               gop_frames=6)
    jids = tvss.apply_joint_compression(["cam_a", "cam_b"], merge="mean")
    assert jids
    assert tvss.catalog.get_joint(jids[0])["duplicate"]
    rb = tvss.read("cam_b", codec="rgb", cache=False).frames
    assert exact_psnr(rb, clip[:12]) >= 40.0


def test_port_disjoint_videos_not_joined(tvss):
    a = synthesize_overlapping_pair(6, width=96, height=64, seed=3)[0]
    b = synthesize_overlapping_pair(6, width=96, height=64, seed=99)[0]
    tvss.write("cam_a", a, fps=30.0, codec="tvc-hi", gop_frames=6)
    tvss.write("cam_b", b, fps=30.0, codec="tvc-hi", gop_frames=6)
    for j in tvss.apply_joint_compression(["cam_a", "cam_b"], merge="mean",
                                          tau_db=24.0):
        assert tvss.catalog.get_joint(j) is not None
    ra = tvss.read("cam_a", codec="rgb", cache=False).frames
    assert exact_psnr(ra, a) >= 24.0


def test_port_homography_estimation_accuracy(overlap_pair):
    left, right, h_true = overlap_pair
    h_est = tfeatures.estimate_homography(left[0], right[0])
    assert h_est is not None
    pts = np.array([[10, 10, 1], [80, 40, 1], [30, 70, 1]], np.float32).T
    p_true = h_true @ pts
    p_est = h_est @ pts
    p_true /= p_true[2]
    p_est /= p_est[2]
    assert np.abs(p_true - p_est).max() < 3.0
