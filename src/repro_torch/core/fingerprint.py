"""Joint-compression candidate search — §5.1.3 / Figure 9.

Brute-forcing all O(n²) GOP pairs is prohibitive, so VSS:
  (i)   fingerprints each fragment with a color histogram,
  (ii)  clusters fingerprints incrementally (BIRCH — we implement the
        clustering-feature (CF) core of BIRCH: each cluster keeps
        (n, linear-sum, square-sum) so insertion/radius are O(1) and the
        structure absorbs streaming GOPs, which is what the paper uses
        BIRCH for; the CF-tree's branching hierarchy is unnecessary at
        our cluster counts and is omitted),
  (iii) picks the tightest cluster and searches inside it for GOP pairs
        sharing ≥ m unambiguous feature correspondences (Lowe-ratio
        disambiguated, distance ≤ d),
  (iv)  hands surviving pairs to Algorithm 1.

Spans (``repro_torch.obs.span``): ``vss.joint.fingerprint`` around each
GOP's fingerprint, ``vss.joint.correspond`` around each pair's feature
count.  The index looks up each counted keyframe's features in a
`features.FeatureMemo` (the pass's, or one of its own), so a keyframe's
corners and descriptors are computed at its first count, inside that
count's span, and every later count of it only matches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.kernels import ops
from repro_torch.obs.trace import span

HIST_BINS = 16


def gop_fingerprint(frames: np.ndarray, bins: int = HIST_BINS, *,
                    device: str = "cuda") -> np.ndarray:
    """L1-normalized per-channel color histogram of a GOP's first frame.
    ``device`` counts it: ``"cuda"`` (the default) launches the histogram
    kernel on the uint8 frame, ``"cpu"`` runs its plain version."""
    with span("vss.joint.fingerprint"):
        x = torch.from_numpy(np.ascontiguousarray(frames[:1])).to(device)
        planar = torch.movedim(x, -1, 1).contiguous()  # (1, C, H, W) uint8
        hist = ops.histogram(planar, bins=bins).cpu().numpy()[0]  # (C, bins)
        v = hist.reshape(-1).astype(np.float32)
        return v / max(v.sum(), 1.0)


@dataclasses.dataclass
class CF:
    """BIRCH clustering feature: (n, linear sum, square sum)."""

    n: int
    ls: np.ndarray
    ss: float
    members: List[int]  # GOP keys

    @property
    def centroid(self) -> np.ndarray:
        return self.ls / self.n

    @property
    def radius(self) -> float:
        # sqrt(E[|x|²] − |E[x]|²)
        c = self.centroid
        val = self.ss / self.n - float(c @ c)
        return float(np.sqrt(max(val, 0.0)))

    def add(self, key: int, x: np.ndarray) -> None:
        self.n += 1
        self.ls = self.ls + x
        self.ss += float(x @ x)
        self.members.append(key)


class BirchLite:
    """Incremental CF clustering with an absorption threshold."""

    def __init__(self, threshold: float = 0.15):
        self.threshold = threshold
        self.clusters: List[CF] = []

    def insert(self, key: int, x: np.ndarray) -> int:
        best, best_d = None, float("inf")
        for i, cf in enumerate(self.clusters):
            d = float(np.linalg.norm(cf.centroid - x))
            if d < best_d:
                best, best_d = i, d
        if best is not None and best_d <= self.threshold:
            self.clusters[best].add(key, x)
            return best
        self.clusters.append(CF(1, x.copy(), float(x @ x), [key]))
        return len(self.clusters) - 1

    def smallest_radius_cluster(self, min_size: int = 2) -> Optional[CF]:
        cands = [c for c in self.clusters if c.n >= min_size]
        if not cands:
            return None
        return min(cands, key=lambda c: c.radius)

    def clusters_by_radius(self, min_size: int = 2) -> List[CF]:
        return sorted(
            (c for c in self.clusters if c.n >= min_size),
            key=lambda c: c.radius,
        )


class CandidateIndex:
    """Streaming GOP index → joint-compression candidate pairs."""

    def __init__(
        self,
        *,
        birch_threshold: float = 0.15,
        min_matches: int = F.MIN_MATCHES,
        device: str = "cuda",
        features: Optional[F.FeatureMemo] = None,
    ):
        self.birch = BirchLite(birch_threshold)
        self.frames: Dict[int, np.ndarray] = {}  # key → first frame
        self.min_matches = min_matches
        self.device = device
        self.features = features or F.FeatureMemo()

    def add_gop(self, key: int, frames: np.ndarray) -> None:
        fp = gop_fingerprint(frames, device=self.device)
        self.birch.insert(key, fp)
        self.frames[key] = frames[0]

    def find_pairs(
        self, max_clusters: int = 4, exclude: Optional[set] = None
    ) -> List[Tuple[int, int, int]]:
        """Returns (key_a, key_b, n_correspondences), best-first.

        Walks clusters tightest-radius-first (Figure 9 step ii) and,
        within each, counts unambiguous feature correspondences between
        member pairs; pairs with ≥ m matches survive.
        """
        exclude = exclude or set()
        out: List[Tuple[int, int, int]] = []
        for cf in self.birch.clusters_by_radius()[:max_clusters]:
            members = cf.members
            for i in range(len(members)):
                for j in range(i + 1, len(members)):
                    a, b = members[i], members[j]
                    if (a, b) in exclude or (b, a) in exclude:
                        continue
                    fa, fb = self.frames[a], self.frames[b]
                    with span("vss.joint.correspond"):
                        feats = (self.features.lookup(fa),
                                 self.features.lookup(fb))
                        n = F.count_correspondences(fa, fb, features=feats)
                    if n >= self.min_matches:
                        out.append((a, b, n))
        out.sort(key=lambda t: -t[2])
        return out
