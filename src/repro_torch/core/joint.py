"""Joint physical-video compression — §5.1 / Algorithm 1.

Given two overlapping GOPs F and G, VSS stores the overlap only once:

  1. estimate H (maps g-coords → f-coords) from matched features,
  2. if ‖H − I‖ ≤ ε the GOPs are (near-)duplicates: G becomes a pointer
     to F (no pixels stored at all),
  3. otherwise partition each frame into a non-overlapping *left* slice
     of f, the *overlap* (merged via `unprojected` — keep f's pixels —
     or `mean` — average f with the warped g), and a non-overlapping
     *right* slice of g; encode the three slices as separate TVC
     streams,
  4. verify recovery: rebuild f' and g' and compare PSNR against the
     inputs; below the abort threshold the homography is re-estimated
     once (dynamic cameras, §5.1.2) and the GOP is segmented at the
     re-estimation point (new keyframe per homography change); a second
     failure aborts joint compression for the pair,
  5. mixed resolutions: G is upscaled to F's size first and the scale
     recorded for reconstruction (§5.1.2).

Reads reverse the process: side-a GOPs are [left ++ overlap]; side-b
GOPs re-project the composite through H and append the right slice.

Spans (``repro_torch.obs.span``): ``vss.joint.estimate`` around each
homography search (the first and a re-estimate), ``vss.joint.verify``
around the per-frame warp, PSNR and slicing loop, ``vss.joint.encode``
around the slices' encodes and puts and ``vss.joint.reconstruct`` around
a read's rebuild of one GOP (the last two are phases: the codec's spans
nest in them).  Inside a rebuild, ``vss.joint.rebuild_warp`` covers the
warp of side b's composite (upload, ``ops.warp``, the float32 download
and the host's round, clip and cast) and ``vss.joint.rebuild_concat``
the joins (the composite, side b's, the segments').  Each pair
Algorithm 1 runs on counts once in the store's
``vss_joint_pairs_total{outcome}`` (`OUTCOMES`), and each pair stored
jointly adds its two GOPs to ``vss_joint_gops_total``.  Each rebuilt GOP
counts once in ``vss_joint_rebuilds_total{side}`` (`SIDES`) and its
frames in ``vss_joint_rebuild_frames_total``.

A rebuild fetches its segment objects through the source it is given:
the store's backend outside a read (`VSS.gop_frames`), the read's own
GOP loader inside one, so the read's fetch spans and counters hold them.

A store's pass hands one `features.FeatureMemo` to the candidate search
and to every search here, so a frame's corners and descriptors are
computed once a pass; each lookup counts in
``vss_joint_features_total{outcome=computed|reused}``.  A search then
matches each direction once and runs every RANSAC seed on those matches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import codec as _codec
from repro_torch.core import features as F
from repro_torch.core.quality import exact_psnr
from repro_torch.core.resize import resample
from repro_torch.core.types import JOINT_ABORT_DB
from repro_torch.kernels import ops
from repro_torch.obs.trace import span

DUPLICATE_EPS = 0.1  # ‖H−I‖ cutoff (prototype ε = 1/10)
# what Algorithm 1 made of a pair: stored jointly, a pointer to its
# duplicate, aborted by the verify step, or no usable homography
JOINT, DUPLICATE, ABORT, NO_H = "joint", "duplicate", "abort", "no_h"
OUTCOMES = (JOINT, DUPLICATE, ABORT, NO_H)
# which GOP of a record a rebuild gave: f, g, or g as a pointer to f
SIDES = ("a", "b", DUPLICATE)


class JointCounters(NamedTuple):
    """A store's joint counters (``VSS.joint_counters``)."""

    pairs: Dict[str, object]  # outcome -> vss_joint_pairs_total{outcome}
    candidates: object  # vss_joint_candidates_total
    gops: object  # vss_joint_gops_total
    features: Dict[str, object]  # outcome -> vss_joint_features_total
    rebuilds: Dict[str, object]  # side -> vss_joint_rebuilds_total{side}
    rebuild_frames: object  # vss_joint_rebuild_frames_total


# ---------------------------------------------------------------------------
# frame-level machinery
# ---------------------------------------------------------------------------

def warp_frames(frames: np.ndarray, hmat_inv: np.ndarray,
                out_hw: Optional[Tuple[int, int]] = None, *,
                device: str = "cuda") -> np.ndarray:
    """Warp (T,H,W,C) uint8 through hmat_inv (dst→src), bilinear.  The
    whole GOP goes to ``device`` as uint8 and through one ``ops.warp``
    (on ``"cuda"`` one kernel launch); each frame's result is what a
    warp of that frame alone gives.  Rounding (half to even), clipping
    and the uint8 cast stay on the host, as in the reference."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    planar = torch.movedim(x, -1, 1).contiguous()  # (T, C, H, W) uint8
    w = ops.warp(planar, hmat_inv, out_shape=out_hw)
    out = w.cpu().numpy().transpose(0, 2, 3, 1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def partition_columns(
    h: np.ndarray, width: int, height: int
) -> Optional[Tuple[int, int]]:
    """(x_f, x_g): g's left edge in f-coords; f's right edge in g-coords."""
    mid = height / 2.0
    xf = F.project(h, np.array([[0.0, mid]], np.float32))[0, 0]
    xg = F.project(
        np.linalg.inv(h), np.array([[float(width), mid]], np.float32)
    )[0, 0]
    x_f = int(round(xf))
    x_g = int(round(xg))
    if not (0 < x_f <= width) or not (0 < x_g <= width):
        return None  # no usable overlap geometry (Algorithm 1: return ∅)
    return x_f, x_g


def merge_overlap(
    f_over: np.ndarray, g_warped_over: np.ndarray, merge: str
) -> np.ndarray:
    if merge == "unprojected":
        return f_over
    if merge == "mean":
        return (
            (f_over.astype(np.float32) + g_warped_over.astype(np.float32))
            / 2.0
        ).round().clip(0, 255).astype(np.uint8)
    raise ValueError(f"unknown merge function {merge!r}")


def reconstruct_pair(
    left: np.ndarray,  # (T, H, x_f, C)
    overlap: np.ndarray,  # (T, H, W - x_f, C)
    right: np.ndarray,  # (T, H, W - x_g, C)
    h: np.ndarray,
    x_g: int,
    *,
    device: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Recover (f', g') from stored slices."""
    f_comp = np.concatenate([left, overlap], axis=2)
    # g'(x) = f_comp(H @ x) for columns < x_g
    g_over = warp_frames(f_comp, h, out_hw=(f_comp.shape[1], x_g),
                         device=device)
    g_rec = np.concatenate([g_over, right], axis=2)
    return f_comp, g_rec


@dataclasses.dataclass
class JointSegment:
    start: int
    num_frames: int
    h: np.ndarray  # (3,3) g→f
    x_f: int
    x_g: int
    left: np.ndarray  # (T, H, x_f, C)
    overlap: np.ndarray
    right: np.ndarray


@dataclasses.dataclass
class JointResult:
    segments: List[JointSegment]
    duplicate: bool
    reversed: bool  # True when (F, G) were swapped (H translation < 0)
    psnr_f: float  # recovered quality, side f
    psnr_g: float


def _photometric_score(fi, gi, h, width, height, device) -> float:
    """min(recovered PSNR of f, g) under candidate H for one frame —
    the verify-step metric, used to pick among RANSAC candidates (a
    periodic-texture alias scores terribly here even when its feature
    inlier count looks fine)."""
    cols = partition_columns(h, width, height)
    if cols is None:
        return -1.0
    x_f, x_g = cols
    g_in_f = warp_frames(gi[None], np.linalg.inv(h), device=device)[0]
    o = merge_overlap(fi[:, x_f:], g_in_f[:, x_f:], "mean")
    f_rec, g_rec = reconstruct_pair(
        fi[None, :, :x_f], o[None], gi[None, :, x_g:], h, x_g,
        device=device,
    )
    return min(exact_psnr(f_rec[0], fi), exact_psnr(g_rec[0], gi))


def _estimate_h_verified(fi, gi, width, height, device, *,
                         features: F.FeatureMemo, seeds=(0, 1, 2, 3)):
    """Best-of-K candidates by photometric verification. Candidates come
    from several RANSAC seeds in both match directions (forward H(g→f)
    and inverted H(f→g)⁻¹) — repeated-texture aliases survive feature
    voting but score terribly photometrically.  Both frames' features
    come from the ``features`` memo, and each direction is matched once
    for all seeds."""
    with span("vss.joint.estimate"):
        fa, fb = features.lookup(fi), features.lookup(gi)
        fwd, rev = F.match_points(fa, fb), F.match_points(fb, fa)
        cands = []
        for seed in seeds:
            h = F.estimate_homography(fi, gi, seed=seed, points=fwd)
            if h is not None:
                cands.append(h)
            h_rev = F.estimate_homography(gi, fi, seed=seed, points=rev)
            if h_rev is not None:
                try:
                    inv = np.linalg.inv(h_rev)
                    cands.append((inv / inv[2, 2]).astype(np.float32))
                except np.linalg.LinAlgError:
                    pass
        best_h, best_s = None, -1.0
        for h in cands:
            if np.linalg.norm(h - np.eye(3)) <= DUPLICATE_EPS:
                return h  # duplicate short-circuits: exactness beats score
            s = _photometric_score(fi, gi, h, width, height, device)
            if s > best_s:
                best_h, best_s = h, s
        return best_h


def joint_compress_frames(
    f_frames: np.ndarray,  # (T, H, W, C) uint8
    g_frames: np.ndarray,
    *,
    merge: str = "unprojected",
    tau_db: float = JOINT_ABORT_DB,
    seed: int = 0,
    device: str = "cuda",
    _reversed: bool = False,
) -> Optional[JointResult]:
    """Algorithm 1 (joint projection). Returns None on abort.  The warps
    run on ``device``; everything else is host numpy.  Its searches
    share one feature memo."""
    return _joint_compress(f_frames, g_frames, merge=merge, tau_db=tau_db,
                           seed=seed, device=device, _reversed=_reversed,
                           features=F.FeatureMemo())[0]


def _joint_compress(
    f_frames: np.ndarray,
    g_frames: np.ndarray,
    *,
    merge: str,
    tau_db: float,
    device: str,
    features: F.FeatureMemo,
    seed: int = 0,
    _reversed: bool = False,
) -> Tuple[Optional[JointResult], str]:
    """`joint_compress_frames` and its outcome (one of `OUTCOMES`);
    ``features`` is the pass's memo, handed to every search."""
    t, height, width, c = f_frames.shape
    if g_frames.shape != f_frames.shape:
        return None, NO_H
    h = _estimate_h_verified(f_frames[0], g_frames[0], width, height,
                             device, features=features)
    if h is None:
        return None, NO_H  # no homography found
    if h[0, 2] < 0 and not _reversed:
        # g extends to the left of f: reverse the transform
        return _joint_compress(
            g_frames, f_frames, merge=merge, tau_db=tau_db, seed=seed,
            device=device, _reversed=True, features=features,
        )
    if np.linalg.norm(h - np.eye(3)) <= DUPLICATE_EPS:
        # §5.1.1 duplicate frames: pointer, no pixels stored
        return JointResult([], True, _reversed, float("inf"),
                           float("inf")), DUPLICATE

    segments: List[JointSegment] = []
    psnr_f_all, psnr_g_all = [], []

    def open_segment(start: int, hmat: np.ndarray) -> Optional[JointSegment]:
        cols = partition_columns(hmat, width, height)
        if cols is None:
            return None
        x_f, x_g = cols
        return JointSegment(
            start, 0, hmat, x_f, x_g,
            np.zeros((0, height, x_f, c), np.uint8),
            np.zeros((0, height, width - x_f, c), np.uint8),
            np.zeros((0, height, width - x_g, c), np.uint8),
        )

    seg = open_segment(0, h)
    if seg is None:
        return None, NO_H
    i = 0
    reestimated_for_frame = False
    with span("vss.joint.verify"):
        while i < t:
            fi, gi = f_frames[i], g_frames[i]
            hinv = np.linalg.inv(seg.h)
            g_in_f = warp_frames(gi[None], hinv, device=device)[0]
            f_over = fi[:, seg.x_f :]
            o = merge_overlap(f_over, g_in_f[:, seg.x_f :], merge)
            left = fi[:, : seg.x_f]
            right = gi[:, seg.x_g :]
            # verify recovery quality (Algorithm 1 verify step)
            f_rec, g_rec = reconstruct_pair(
                left[None], o[None], right[None], seg.h, seg.x_g,
                device=device
            )
            pf = exact_psnr(f_rec[0], fi)
            pg = exact_psnr(g_rec[0], gi)
            if min(pf, pg) < tau_db:
                if not reestimated_for_frame:
                    # §5.1.2: re-estimate homography, start a new segment
                    h_new = _estimate_h_verified(fi, gi, width, height,
                                                 device, features=features)
                    reestimated_for_frame = True
                    if h_new is not None:
                        if seg.num_frames > 0:
                            segments.append(seg)
                        new_seg = open_segment(i, h_new)
                        if new_seg is not None:
                            seg = new_seg
                            continue
                return None, ABORT  # second failure: abort the pair
            reestimated_for_frame = False
            seg.left = np.concatenate([seg.left, left[None]])
            seg.overlap = np.concatenate([seg.overlap, o[None]])
            seg.right = np.concatenate([seg.right, right[None]])
            seg.num_frames += 1
            psnr_f_all.append(pf)
            psnr_g_all.append(pg)
            i += 1
    if seg.num_frames > 0:
        segments.append(seg)
    return JointResult(
        segments, False, _reversed,
        float(np.mean(psnr_f_all)), float(np.mean(psnr_g_all)),
    ), JOINT


# ---------------------------------------------------------------------------
# store-level integration
# ---------------------------------------------------------------------------

def jointly_compress_gops(
    store,
    gop_a_id: int,
    gop_b_id: int,
    *,
    merge: str = "unprojected",
    tau_db: float = JOINT_ABORT_DB,
    features: Optional[F.FeatureMemo] = None,
) -> Optional[int]:
    """Apply joint compression to two stored GOPs; returns joint id.

    Mixed resolutions are handled by upscaling the smaller GOP to the
    larger one's geometry first (§5.1.2); the scale is recorded so reads
    can downsample back.  ``features`` is the store pass's memo; a call
    for one pair alone makes its own.
    """
    features = features or F.FeatureMemo()
    cat = store.catalog
    ga = cat.get_gop(gop_a_id)
    gb = cat.get_gop(gop_b_id)
    if ga.joint_ref or gb.joint_ref:
        return None
    fa = store.gop_frames(ga)
    fb = store.gop_frames(gb)
    if fa.shape[0] != fb.shape[0]:
        return None
    g_scale = 1.0
    if fa.shape[1:3] != fb.shape[1:3]:
        # upscale the lower-resolution side to the higher (§5.1.2)
        if fa.shape[1] * fa.shape[2] < fb.shape[1] * fb.shape[2]:
            fa, fb = fb, fa
            ga, gb = gb, ga
            gop_a_id, gop_b_id = gop_b_id, gop_a_id
        g_scale = fa.shape[2] / fb.shape[2]
        fb = resample(fb, (fa.shape[2], fa.shape[1]), device=store.device)
    res, outcome = _joint_compress(fa, fb, merge=merge, tau_db=tau_db,
                                   device=store.device, features=features)
    counters = store.joint_counters()
    counters.pairs[outcome].inc()
    if res is None:
        return None
    if res.reversed:
        fa, fb = fb, fa
        ga, gb = gb, ga
        gop_a_id, gop_b_id = gop_b_id, gop_a_id

    pa = cat.get_physical(ga.physical_id)
    codec_name = pa.codec if pa.codec != "rgb" else "tvc-hi"

    if res.duplicate:
        joint_id = cat.add_joint(
            gop_a_id, gop_b_id, merge, [], nbytes=0, duplicate=True,
            g_scale=g_scale,
        )
        # b's pixels are freed; it becomes a pointer to a
        store.backend.delete(gb.path)
        cat.update_gop(gop_b_id, joint_ref=joint_id, nbytes=0)
        counters.gops.inc(2)
        return joint_id

    seg_meta = []
    total_bytes = 0
    a_bytes = 0
    joint_id = cat.add_joint(
        gop_a_id, gop_b_id, merge, [], nbytes=0, g_scale=g_scale
    )
    with span("vss.joint.encode"):
        for k, seg in enumerate(res.segments):
            paths = {}
            for part_name, arr in (
                ("left", seg.left), ("overlap", seg.overlap),
                ("right", seg.right),
            ):
                enc = _codec.encode_gop(arr, codec_name, device=store.device)
                key = f"_joint/{joint_id}_s{k}_{part_name}.tvc"
                data = _codec.serialize_gop(enc)
                store.backend.put(key, data)
                paths[part_name] = key
                total_bytes += len(data)
                if part_name in ("left", "overlap"):
                    a_bytes += len(data)
            seg_meta.append(
                {
                    "start": seg.start,
                    "num_frames": seg.num_frames,
                    "h": np.asarray(seg.h, np.float64).reshape(-1).tolist(),
                    "x_f": seg.x_f,
                    "x_g": seg.x_g,
                    "paths": paths,
                }
            )
    cat.set_joint_segments(joint_id, seg_meta, total_bytes)
    # original GOP objects are replaced by the joint pieces; byte
    # accounting assigns left+overlap to a, right to b
    b_bytes = total_bytes - a_bytes
    store.backend.delete(ga.path)
    store.backend.delete(gb.path)
    cat.update_gop(gop_a_id, joint_ref=joint_id, nbytes=a_bytes)
    cat.update_gop(gop_b_id, joint_ref=joint_id, nbytes=b_bytes)
    counters.gops.inc(2)
    return joint_id


def reconstruct_gop(store, gop, source) -> np.ndarray:
    """Rebuild a jointly-compressed GOP's frames, its objects fetched
    through ``source`` (``get`` and ``batch_get``): the backend, or a
    read's GOP loader (read path hook)."""
    with span("vss.joint.reconstruct"):
        frames, side = _reconstruct_gop(store, gop, source)
    counters = store.joint_counters()
    counters.rebuilds[side].inc()
    counters.rebuild_frames.inc(frames.shape[0])
    return frames


def _reconstruct_gop(store, gop, source) -> Tuple[np.ndarray, str]:
    cat = store.catalog
    rec = cat.get_joint(gop.joint_ref)
    side_a = rec["gop_a"] == gop.gop_id
    if rec["duplicate"]:
        side = DUPLICATE
        frames = store.gop_frames(cat.get_gop(rec["gop_a"]), source)
    else:
        side = "a" if side_a else "b"
        parts = [_segment_frames(store, seg, side_a, source)
                 for seg in rec["segments"]]
        with span("vss.joint.rebuild_concat"):
            frames = np.concatenate(parts, axis=0)
    if not side_a and rec["g_scale"] != 1.0:
        s = rec["g_scale"]
        frames = resample(
            frames,
            (int(round(frames.shape[2] / s)),
             int(round(frames.shape[1] / s))),
            device=store.device,
        )
    return frames, side


def _segment_frames(store, seg, side_a: bool, source) -> np.ndarray:
    """One joint segment's frames of side a ([left ++ overlap]) or of
    side b (the composite re-projected through H, ++ right)."""
    parts = ["left", "overlap"] if side_a else ["left", "overlap", "right"]
    blobs = source.batch_get([seg["paths"][p] for p in parts])
    decoded = {
        p: _codec.decode_gop(_codec.deserialize_gop(b), device=store.device)
        for p, b in zip(parts, blobs)
    }
    with span("vss.joint.rebuild_concat"):
        f_comp = np.concatenate([decoded["left"], decoded["overlap"]],
                                axis=2)
    if side_a:
        return f_comp
    h = np.asarray(seg["h"], np.float64).reshape(3, 3).astype(np.float32)
    with span("vss.joint.rebuild_warp"):
        g_over = warp_frames(f_comp, h,
                             out_hw=(f_comp.shape[1], seg["x_g"]),
                             device=store.device)
    with span("vss.joint.rebuild_concat"):
        return np.concatenate([g_over, decoded["right"]], axis=2)
