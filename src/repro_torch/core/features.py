"""Feature detection, matching and homography estimation (§5.1.1).

The paper uses SIFT [Lowe'99] + Lowe's ratio test + homography
estimation. SIFT is CPU-library code with no TPU analogue, so we keep
the *pipeline* (detect keypoints → describe → ratio-match → robustly
estimate H) but swap the detector for Harris corners and the descriptor
for normalized intensity patches — both plain array math. Homography
estimation is DLT + RANSAC.  A copy of ``repro.core.features``: host
numpy, the same on every device.

All functions take (H, W, C) uint8 frames.  A `FeatureMemo` keeps each
frame's corners and descriptors (`frame_features`) for one joint pass,
computed once, inside whichever span (a count's, a search's) first
looks the frame up.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

HARRIS_K = 0.04
NMS_RADIUS = 4
PATCH = 8  # descriptor patch half-size → (2*PATCH)² dims
LOWE_RATIO = 0.8  # Lowe's ratio disambiguation (§5.1.3)
FEATURE_DIST = 400.0  # paper's d=400 Euclidean cutoff
MIN_MATCHES = 20  # paper's m=20 correspondences
SEARCH_CORNERS = 300  # corners a frame brings to a homography search
COUNT_CORNERS = 200  # corners a frame brings to a correspondence count

# (N, 2) float32 keypoints, strongest first, and their (N, (2*PATCH)²)
# float32 descriptors (`frame_features`)
Features = Tuple[np.ndarray, np.ndarray]


def to_gray(img: np.ndarray) -> np.ndarray:
    return img[..., :3].astype(np.float32) @ np.array(
        [0.299, 0.587, 0.114], np.float32
    )


def _box3(x: np.ndarray) -> np.ndarray:
    """3x3 box filter with edge replication."""
    p = np.pad(x, 1, mode="edge")
    return (
        p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
        + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
        + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
    ) / 9.0


def harris_response(gray: np.ndarray) -> np.ndarray:
    gy, gx = np.gradient(gray)
    ixx = _box3(gx * gx)
    iyy = _box3(gy * gy)
    ixy = _box3(gx * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - HARRIS_K * tr * tr


def detect_corners(
    img: np.ndarray, max_corners: int = 200, border: int = PATCH + 1
) -> np.ndarray:
    """Returns (N, 2) float32 (x, y) keypoints, strongest first."""
    return _corners(to_gray(img), max_corners, border)


def _corners(gray: np.ndarray, max_corners: int, border: int) -> np.ndarray:
    r = harris_response(gray)
    # non-max suppression over a (2*NMS_RADIUS+1)² window
    h, w = r.shape
    rmax = r.copy()
    for dy in range(-NMS_RADIUS, NMS_RADIUS + 1):
        for dx in range(-NMS_RADIUS, NMS_RADIUS + 1):
            if dx == 0 and dy == 0:
                continue
            shifted = np.roll(np.roll(r, dy, axis=0), dx, axis=1)
            rmax = np.maximum(rmax, shifted)
    peaks = (r >= rmax) & (r > 0)
    peaks[:border] = peaks[-border:] = False
    peaks[:, :border] = peaks[:, -border:] = False
    ys, xs = np.nonzero(peaks)
    if len(xs) == 0:
        return np.zeros((0, 2), np.float32)
    scores = r[ys, xs]
    order = np.argsort(-scores)[:max_corners]
    return np.stack([xs[order], ys[order]], axis=1).astype(np.float32)


def describe(img: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    """Normalized intensity-patch descriptors, (N, (2*PATCH)²) float32."""
    return _describe(to_gray(img), keypoints)


def _describe(gray: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    descs = []
    for x, y in keypoints:
        xi, yi = int(round(x)), int(round(y))
        patch = gray[yi - PATCH : yi + PATCH, xi - PATCH : xi + PATCH]
        v = patch.reshape(-1)
        v = v - v.mean()
        n = np.linalg.norm(v)
        descs.append(v / n if n > 1e-6 else v)
    return (
        np.stack(descs).astype(np.float32)
        if descs
        else np.zeros((0, (2 * PATCH) ** 2), np.float32)
    )


def frame_features(
    img: np.ndarray, max_corners: int = SEARCH_CORNERS
) -> Features:
    """A frame's (keypoints, descriptors): `detect_corners` and `describe`
    on one grayscale conversion.  Row k of either depends only on the
    k-th strongest corner, so the first n rows are what ``max_corners=n``
    gives."""
    gray = to_gray(img)
    keypoints = _corners(gray, max_corners, PATCH + 1)
    return keypoints, _describe(gray, keypoints)


def match_descriptors(
    da: np.ndarray, db: np.ndarray, ratio: float = LOWE_RATIO,
    max_dist: float = FEATURE_DIST, mutual: bool = True,
) -> List[Tuple[int, int]]:
    """Lowe-ratio matching; ambiguous correspondences are rejected
    (paper §5.1.3)."""
    if len(da) == 0 or len(db) == 0:
        return []
    # normalized descriptors → Euclidean via dot products
    d2 = (
        (da * da).sum(1)[:, None]
        - 2.0 * da @ db.T
        + (db * db).sum(1)[None, :]
    )
    d2 = np.maximum(d2, 0)
    # mutual best match (symmetric check): repeated texture (lane dashes,
    # window grids) aliases one-directional matches; requiring a↔b mutual
    # nearest kills most of them before the ratio test
    best_ab = np.argmin(d2, axis=1)
    best_ba = np.argmin(d2, axis=0)
    matches = []
    for i in range(len(da)):
        order = np.argsort(d2[i])
        j0 = int(order[0])
        if mutual and best_ba[j0] != i:
            continue
        if len(order) >= 2:
            j1 = order[1]
            if not d2[i, j0] < (ratio ** 2) * d2[i, j1]:
                continue
        if d2[i, j0] <= max_dist:
            matches.append((i, j0))
    return matches


def dlt_homography(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares H with dst ~ H @ src (points (N,2), N ≥ 4)."""
    n = len(src)
    if n < 4:
        return None
    # normalize for conditioning
    def norm(pts):
        c = pts.mean(0)
        s = np.sqrt(2.0) / max(np.linalg.norm(pts - c, axis=1).mean(), 1e-9)
        t = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (pts - c) * s, t

    sp, ts = norm(src.astype(np.float64))
    dp, td = norm(dst.astype(np.float64))
    a = []
    for (x, y), (u, v) in zip(sp, dp):
        a.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        a.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    a = np.asarray(a)
    try:
        _, _, vt = np.linalg.svd(a)
    except np.linalg.LinAlgError:
        return None
    h = vt[-1].reshape(3, 3)
    h = np.linalg.inv(td) @ h @ ts
    if abs(h[2, 2]) < 1e-12:
        return None
    return (h / h[2, 2]).astype(np.float32)


def project(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1), pts.dtype)], axis=1)
    q = p @ h.T
    return q[:, :2] / np.maximum(np.abs(q[:, 2:]), 1e-9) * np.sign(q[:, 2:])


def ransac_homography(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    iters: int = 300,
    thresh_px: float = 3.0,
    seed: int = 0,
) -> Optional[np.ndarray]:
    n = len(src)
    if n < 4:
        return None
    rng = np.random.default_rng(seed)
    best_inliers: Optional[np.ndarray] = None
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        h = dlt_homography(src[idx], dst[idx])
        if h is None:
            continue
        err = np.linalg.norm(project(h, src) - dst, axis=1)
        inliers = err < thresh_px
        if best_inliers is None or inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    if best_inliers is None or best_inliers.sum() < 4:
        return None
    # iterated refit: refit on inliers, re-collect, refit again (2 rounds)
    h = dlt_homography(src[best_inliers], dst[best_inliers])
    for _ in range(2):
        if h is None:
            return None
        err = np.linalg.norm(project(h, src) - dst, axis=1)
        inliers = err < thresh_px
        if inliers.sum() < 4:
            break
        h = dlt_homography(src[inliers], dst[inliers])
    return h


def match_points(fa: Features, fb: Features) -> Tuple[np.ndarray,
                                                    np.ndarray]:
    """(src, dst): the keypoints of fb and of fa that match, row for row,
    as float32 (N, 2).  Mutual matches, or one-directional ratio matches
    where fewer than m are mutual."""
    (ka, da), (kb, db) = fa, fb
    matches = match_descriptors(da, db, mutual=True)
    if len(matches) < MIN_MATCHES:
        # mutual filtering can starve low-texture pairs; fall back to
        # one-directional ratio matches (RANSAC handles extra outliers)
        matches = match_descriptors(da, db, mutual=False)
    src = np.array([kb[j] for _, j in matches], np.float32).reshape(-1, 2)
    dst = np.array([ka[i] for i, _ in matches], np.float32).reshape(-1, 2)
    return src, dst


def estimate_homography(
    f: np.ndarray, g: np.ndarray, *, max_corners: int = SEARCH_CORNERS,
    seed: int = 0,
    points: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Optional[np.ndarray]:
    """H mapping g's pixel coordinates into f's (``f(H@x) ≈ g(x)``).

    ``points`` is ``match_points`` of the two frames' `frame_features`
    at ``max_corners``, where the caller has it; otherwise it is computed
    here.  Returns None when no confident homography exists (Algorithm 1
    then aborts joint compression for the pair).
    """
    if points is None:
        points = match_points(frame_features(f, max_corners),
                              frame_features(g, max_corners))
    src, dst = points  # g coords, f coords
    if len(src) < MIN_MATCHES:
        return None
    return ransac_homography(src, dst, seed=seed)


def count_correspondences(
    f: np.ndarray, g: np.ndarray, *,
    features: Optional[Tuple[Features, Features]] = None,
) -> int:
    """Number of unambiguous nearby feature correspondences (§5.1.3).
    ``features`` is the two frames' `frame_features` at
    `COUNT_CORNERS` corners or more, where the caller has them."""
    if features is None:
        features = (frame_features(f, COUNT_CORNERS),
                    frame_features(g, COUNT_CORNERS))
    fa, fb = ((k[:COUNT_CORNERS], d[:COUNT_CORNERS]) for k, d in features)
    return len(match_points(fa, fb)[0])


# what a `FeatureMemo` lookup did
COMPUTED, REUSED = "computed", "reused"
MEMO_OUTCOMES = (COMPUTED, REUSED)


class FeatureMemo:
    """Each frame's `frame_features`, computed once and handed to every
    later lookup of an equal frame: one joint pass's correspondence
    counts and homography searches share it.  Keyed by the frame's bytes,
    shape and dtype, since a pass decodes a GOP anew for each pair.
    ``counters`` (outcome -> a counter with ``inc``) counts each lookup
    under one of `MEMO_OUTCOMES`."""

    def __init__(self, counters: Optional[Dict[str, object]] = None):
        self._features: Dict[tuple, Features] = {}
        self._counters = counters or {}

    def lookup(self, img: np.ndarray) -> Features:
        img = np.ascontiguousarray(img)
        key = (img.shape, img.dtype.str,
               hashlib.blake2b(img, digest_size=16).digest())
        found = self._features.get(key)
        outcome = REUSED
        if found is None:
            outcome = COMPUTED
            found = self._features[key] = frame_features(img)
        if outcome in self._counters:
            self._counters[outcome].inc()
        return found
