"""The joint pass's feature memo in the port, on the CPU.

A pass computes each frame's corners and descriptors once
(`features.FeatureMemo`) and hands them to every correspondence count
and homography search that needs the frame.  Nothing it decides may
change: the homographies, the counts, the outcomes and the stored bytes
equal those of the same calls without a memo, and the reference's.
Each lookup counts in ``vss_joint_features_total{outcome}``: ``computed``
once for each distinct frame of the pass, ``reused`` for the rest."""
import hashlib

import numpy as np
import pytest
import torch

from repro.core import features as jfeatures
from repro_torch.configs.vss_paper import DATASETS
from repro_torch.core import features, joint
from repro_torch.core.config import VSSConfig
from repro_torch.core.store import VSS
from repro_torch.data.video import synthesize_overlapping_pair
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

VROAD_1K_75 = next(d for d in DATASETS if d.name == "vroad-1k-75")
OUTCOMES = ("joint", "duplicate", "abort", "no_h")


@pytest.fixture(scope="module")
def wide_pair():
    """One frame of a seeded 75 % pair at the joint cell's 960x540."""
    left, right, _ = synthesize_overlapping_pair(
        1, width=960, height=540, overlap=0.75, seed=29)
    return left[0], right[0]


@pytest.fixture(scope="module")
def cams():
    """Two GOPs a camera of the 1K-75 pair at its CPU scale, and two more
    for appends after a first pass."""
    d = VROAD_1K_75
    left, right, _ = synthesize_overlapping_pair(
        120, width=d.width, height=d.height, overlap=d.overlap, seed=d.seed)
    return left, right


def _searches_without_a_memo(monkeypatch):
    """Makes every `estimate_homography` of a search drop the memo's
    matches and detect and match both frames on its own, as each of a
    search's 8 calls did before the memo."""
    real = features.estimate_homography

    def on_its_own(f, g, *, seed=0, points=None, **kw):
        return real(f, g, seed=seed, **kw)

    monkeypatch.setattr(features, "estimate_homography", on_its_own)


@pytest.mark.parametrize("size", ["960x540", "160x96"])
def test_a_search_with_a_memo_finds_the_same_h(size, wide_pair,
                                               overlap_pair, monkeypatch):
    f, g = wide_pair if size == "960x540" else (overlap_pair[0][0],
                                                overlap_pair[1][0])
    height, width = f.shape[:2]
    memo = features.FeatureMemo()
    memoed = joint._estimate_h_verified(f, g, width, height, "cpu",
                                        features=memo)
    # the reversed search of Algorithm 1 reuses both frames' features
    again = joint._estimate_h_verified(g, f, width, height, "cpu",
                                       features=memo)
    own = joint._estimate_h_verified(g, f, width, height, "cpu",
                                     features=features.FeatureMemo())
    _searches_without_a_memo(monkeypatch)
    plain = joint._estimate_h_verified(f, g, width, height, "cpu",
                                       features=features.FeatureMemo())
    assert plain is not None
    np.testing.assert_array_equal(memoed, plain)
    plain_again = joint._estimate_h_verified(
        g, f, width, height, "cpu", features=features.FeatureMemo())
    np.testing.assert_array_equal(again, plain_again)
    np.testing.assert_array_equal(own, plain_again)


@pytest.mark.parametrize("size", ["960x540", "160x96"])
def test_the_memo_s_first_200_rows_are_a_200_corner_detect(
        size, wide_pair, overlap_pair):
    f, g = wide_pair if size == "960x540" else (overlap_pair[0][0],
                                                overlap_pair[1][0])
    for img in (f, g):
        keypoints, descriptors = features.frame_features(img)
        assert keypoints.shape[1] == 2
        assert descriptors.shape == (len(keypoints),
                                     (2 * features.PATCH) ** 2)
        # bit for bit what the separate detect and describe give
        np.testing.assert_array_equal(
            keypoints, features.detect_corners(img, features.SEARCH_CORNERS))
        np.testing.assert_array_equal(descriptors,
                                      features.describe(img, keypoints))
        few = features.detect_corners(img)  # the count's 200
        np.testing.assert_array_equal(keypoints[:len(few)], few)
        np.testing.assert_array_equal(descriptors[:len(few)],
                                      features.describe(img, few))
    memo = features.FeatureMemo()
    n = features.count_correspondences(
        f, g, features=(memo.lookup(f), memo.lookup(g)))
    assert n == features.count_correspondences(f, g)
    assert n == jfeatures.count_correspondences(f, g)


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_from_precomputed_features_equals_the_reference(
        seed, overlap_pair):
    f, g = overlap_pair[0][0], overlap_pair[1][0]
    memo = features.FeatureMemo()
    points = features.match_points(memo.lookup(f), memo.lookup(g))
    h = features.estimate_homography(f, g, seed=seed, points=points)
    assert h is not None
    np.testing.assert_array_equal(
        h, jfeatures.estimate_homography(f, g, seed=seed))
    np.testing.assert_array_equal(
        h, features.estimate_homography(f, g, seed=seed))


def test_a_lookup_counts_computed_then_reused(overlap_pair):
    reg = MetricsRegistry()
    counters = {o: reg.counter("lookups", labels={"outcome": o})
                for o in features.MEMO_OUTCOMES}
    memo = features.FeatureMemo(counters)
    f = overlap_pair[0][0]
    first = memo.lookup(f)
    # an equal frame in another array (a second decode) is the same key
    second = memo.lookup(f.copy())
    assert second is first
    memo.lookup(overlap_pair[0][1])
    assert reg.value("lookups", {"outcome": "computed"}) == 2
    assert reg.value("lookups", {"outcome": "reused"}) == 1


# -- the store's pass -----------------------------------------------------

def _store(root, writes):
    vss = VSS(str(root), config=VSSConfig(device="cpu",
                                          registry=MetricsRegistry()))
    _write(vss, writes)
    return vss


def _write(vss, writes):
    for name, frames in writes.items():
        vss.write(name, frames, fps=30.0, codec="h264", gop_frames=30)


def _counts(vss):
    reg = vss.registry
    out = {o: reg.value("vss_joint_pairs_total", {"outcome": o})
           for o in OUTCOMES}
    out["candidates"] = reg.value("vss_joint_candidates_total")
    out["gops"] = reg.value("vss_joint_gops_total")
    return out


def _lookups(vss):
    return {o: vss.registry.value("vss_joint_features_total",
                                  {"outcome": o})
            for o in features.MEMO_OUTCOMES}


def _stored(vss, names):
    cat = vss.catalog
    gops = [g for n in names for p in cat.physicals_for(n)
            for g in cat.gops_for(p.physical_id)]
    records = sorted({g.joint_ref for g in gops if g.joint_ref is not None})
    return ([cat.total_bytes(n) for n in names],
            [(g.gop_id, g.nbytes, g.joint_ref) for g in gops],
            [cat.get_joint(j) for j in records])


class _Lookups:
    """Records, by content, the frames a pass looks up (both frames of
    each count and of each homography search), and counts the feature
    computations it makes."""

    def __init__(self, monkeypatch):
        self.frames, self.n, self.computed = set(), 0, 0
        count = features.count_correspondences
        search = joint._estimate_h_verified
        compute = features.frame_features

        def on_compute(img, *a, **kw):
            self.computed += 1
            return compute(img, *a, **kw)

        def on_count(f, g, **kw):
            self._see(f, g)
            return count(f, g, **kw)

        def on_search(fi, gi, *a, **kw):
            self._see(fi, gi)
            return search(fi, gi, *a, **kw)

        monkeypatch.setattr(features, "frame_features", on_compute)
        monkeypatch.setattr(features, "count_correspondences", on_count)
        monkeypatch.setattr(joint, "_estimate_h_verified", on_search)

    def _see(self, *imgs):
        for img in imgs:
            self.n += 1
            self.frames.add(hashlib.sha256(
                np.ascontiguousarray(img).tobytes()).hexdigest())


@pytest.mark.parametrize("tau_db", [24.0, 1000.0])  # joined / aborted
def test_a_pass_with_the_memo_stores_what_one_without_it_does(
        tmp_path, cams, monkeypatch, tau_db):
    left, right = cams
    writes = {"cam_l": left[:60], "cam_r": right[:60]}
    names = list(writes)
    with_memo = _store(tmp_path / "memo", writes)
    try:
        seen = _Lookups(monkeypatch)
        ids = with_memo.apply_joint_compression(names, tau_db=tau_db)
        got = _counts(with_memo), _stored(with_memo, names)
        lookups = _lookups(with_memo)
    finally:
        with_memo.close()
    monkeypatch.undo()
    # the memo disabled: every lookup computes the frame's features anew
    monkeypatch.setattr(features.FeatureMemo, "lookup",
                        lambda memo, img: features.frame_features(img))
    plain = _store(tmp_path / "plain", writes)
    try:
        plain_seen = _Lookups(monkeypatch)
        plain_ids = plain.apply_joint_compression(names, tau_db=tau_db)
        assert (ids, got) == (plain_ids,
                              (_counts(plain), _stored(plain, names)))
    finally:
        plain.close()
    assert got[0]["candidates"] >= 2
    assert got[0]["joint" if tau_db == 24.0 else "abort"] >= 1
    assert (plain_seen.n, plain_seen.frames) == (seen.n, seen.frames)
    assert plain_seen.computed == seen.n
    # one computation a distinct frame, every other lookup a reuse
    assert seen.computed == len(seen.frames)
    assert lookups == {"computed": len(seen.frames),
                       "reused": seen.n - len(seen.frames)}
    assert lookups["reused"] > lookups["computed"]


def test_the_counter_is_registered_with_the_pass(tmp_path, cams):
    left, right = cams
    vss = _store(tmp_path / "vss", {"cam_l": left[:30],
                                    "cam_r": right[:30]})
    try:
        assert "vss_joint_features_total" not in (
            vss.registry.render_prometheus())
        vss.apply_joint_compression(["cam_l", "cam_r"])
        text = vss.registry.render_prometheus()
        for outcome in features.MEMO_OUTCOMES:
            assert f'vss_joint_features_total{{outcome="{outcome}"}}' in text
        assert set(vss.joint_counters().features) == set(
            features.MEMO_OUTCOMES)
    finally:
        vss.close()


def test_a_second_pass_computes_its_frames_afresh(tmp_path, cams,
                                                  monkeypatch):
    """The memo lives for one pass: after new appends, a second pass
    computes every frame it looks up again, those of GOPs the first pass
    left apart as well as the new GOPs'."""
    left, right = cams
    first = {"cam_l": left[:60], "cam_r": right[:60]}
    vss = _store(tmp_path / "vss", first)
    try:
        vss.apply_joint_compression(list(first), tau_db=1000.0)  # aborts
        before = _lookups(vss)
        assert before["computed"] >= 4
        _write(vss, {"cam_l2": left[60:], "cam_r2": right[60:]})
        seen = _Lookups(monkeypatch)
        vss.apply_joint_compression(
            ["cam_l", "cam_r", "cam_l2", "cam_r2"], tau_db=1000.0)
        after = _lookups(vss)
        keyframes = {hashlib.sha256(np.ascontiguousarray(x).tobytes())
                     .hexdigest() for x in (left[0], left[30], left[60],
                                            left[90], right[0], right[30],
                                            right[60], right[90])}
        assert keyframes <= seen.frames
        assert after["computed"] - before["computed"] == len(seen.frames)
        assert after["reused"] - before["reused"] == (
            seen.n - len(seen.frames))
    finally:
        vss.close()
