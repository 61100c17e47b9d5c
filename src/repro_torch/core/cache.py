"""GOP-page caching with the LRU_VSS eviction policy — §4.

Pages are GOPs, not whole videos; the sequence number of page f_i is

    LRU_VSS(f_i) = LRU(f_i) + γ·p(f_i) − ζ·r(f_i) + b(f_i)

  p: position offset min(i, n−i) — protects the middle of a physical
     video so eviction nibbles at the ends instead of shattering it into
     many fragments (reads are exponential in fragment count),
  r: redundancy rank — the number of strictly higher-quality cached
     covers of the same spatiotemporal region (more redundant → evict
     sooner),
  b: baseline-quality guard — +∞ when f_i is the *only* remaining ≥τ
     cover of its region (the lossless cover can never be evicted).

Defaults γ=2, ζ=1, τ=40 dB, exactly the prototype's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from repro_torch.core.catalog import Catalog
from repro_torch.core.types import GopMeta, PhysicalMeta, mse_to_psnr, tile_keys

INF = float("inf")


@dataclasses.dataclass
class CachePolicy:
    gamma: float = 2.0  # position weight
    zeta: float = 1.0  # redundancy weight
    tau_db: float = 40.0  # lossless threshold
    use_vss_offsets: bool = True  # False → ordinary LRU (baseline)
    # Beyond-paper: only count a higher-quality cover as "making this
    # page redundant" when it is a genuine service substitute (same
    # codec). The paper's r evicts format-matched views first under
    # pressure because the pristine original covers them — yet those
    # views are exactly the pages the §3 cost model wants (pass-through
    # beats transcode). Off by default (paper-faithful).
    cost_aware_redundancy: bool = False

    def sequence_numbers(
        self, catalog: Catalog, logical: str
    ) -> Dict[int, float]:
        """LRU_VSS sequence number per GOP id (lower = evict first)."""
        physicals = catalog.physicals_for(logical)
        gops_by_phys: Dict[int, List[GopMeta]] = {
            p.physical_id: catalog.gops_for(p.physical_id) for p in physicals
        }
        phys_by_id = {p.physical_id: p for p in physicals}
        seqs: Dict[int, float] = {}
        for p in physicals:
            gops = gops_by_phys[p.physical_id]
            n = len(gops)
            for i, g in enumerate(gops):
                seq = float(g.lru_seq)
                if self.use_vss_offsets:
                    seq += self.gamma * min(i, n - i)
                    seq -= self.zeta * self._redundancy_rank(
                        p, g, physicals, gops_by_phys
                    )
                seq += self._baseline_guard(p, g, physicals, gops_by_phys)
                seqs[g.gop_id] = seq
        return seqs

    # -- offsets -----------------------------------------------------------
    def _covers(
        self, other: PhysicalMeta, gops: List[GopMeta], p: PhysicalMeta,
        g: GopMeta,
    ) -> bool:
        """Does `other` (with its live GOPs) spatiotemporally cover g?

        Coverage requires at least g's sampling density: mse_bound is
        tracked at each view's *own* resolution (§3.2 semantics), so a
        downsampled view — whatever its bound says — can never
        reproduce g's detail and must not count as a cover (otherwise
        the baseline guard could let eviction destroy the only
        full-resolution copy).
        """
        if other.scale < p.scale - 1e-9:
            return False
        if other.fps < p.fps - 1e-9:
            return False
        t0 = g.start_time(p.fps, p.t_start)
        t1 = g.end_time(p.fps, p.t_start)
        if not (other.covers_roi(p.roi) and other.covers_time(t0, t1)):
            return False
        # coverage must be by *live* GOPs (mid-video evictions leave gaps)
        f0 = other.frame_at(t0)
        f1 = other.frame_at(t1)
        covered = 0
        for og in gops:
            s = max(og.start_frame, f0)
            e = min(og.start_frame + og.num_frames, f1)
            covered += max(0, e - s)
        return covered >= (f1 - f0)

    def _redundancy_rank(
        self, p: PhysicalMeta, g: GopMeta, physicals, gops_by_phys
    ) -> int:
        rank = 0
        for other in physicals:
            if other.physical_id == p.physical_id:
                continue
            if self.cost_aware_redundancy and other.codec != p.codec:
                continue  # not a service substitute: transcode ≫ pass-through
            if other.mse_bound < p.mse_bound and self._covers(
                other, gops_by_phys[other.physical_id], p, g
            ):
                rank += 1
        return rank

    def _baseline_guard(
        self, p: PhysicalMeta, g: GopMeta, physicals, gops_by_phys
    ) -> float:
        if mse_to_psnr(p.mse_bound) < self.tau_db:
            return 0.0  # not part of the ≥τ cover
        for other in physicals:
            if other.physical_id == p.physical_id:
                continue
            if mse_to_psnr(other.mse_bound) >= self.tau_db and self._covers(
                other, gops_by_phys[other.physical_id], p, g
            ):
                return 0.0  # another ≥τ cover exists
        return INF


class CacheManager:
    """Budget enforcement: evict lowest-sequence GOP pages until within
    the per-logical-video storage budget (set at creation, §4)."""

    def __init__(self, catalog: Catalog, policy: Optional[CachePolicy] = None,
                 *, backend=None):
        self.catalog = catalog
        self.policy = policy or CachePolicy()
        self.backend = backend  # StorageBackend owning the GOP payloads

    def over_budget_bytes(self, logical: str) -> int:
        return self.catalog.total_bytes(logical) - self.catalog.get_budget(
            logical
        )

    def maybe_evict(self, logical: str) -> List[int]:
        """Evict until within budget. Returns evicted GOP ids.

        Sequence numbers (and in particular the baseline-quality guard b)
        are recomputed after every eviction: evicting a page can make the
        *other* ≥τ cover of that region the only one left, flipping its
        guard to +∞ — a one-shot ordering would let alternating
        evictions destroy the lossless cover.
        """
        evicted: List[int] = []
        while self.over_budget_bytes(logical) > 0:
            seqs = self.policy.sequence_numbers(self.catalog, logical)
            candidates = [(s, g) for g, s in seqs.items() if s != INF]
            if not candidates:
                break  # only protected pages remain
            _, gop_id = min(candidates)
            g = self.catalog.get_gop(gop_id)
            self._delete_gop(g)
            self.catalog.delete_gop(gop_id)
            evicted.append(gop_id)
            # drop physical videos that lost all pages — except the
            # original's metadata row, which defines the logical video's
            # temporal bounds / roi / fps even with zero live GOPs
            if not self.catalog.gops_for(g.physical_id):
                if self.catalog.get_original_id(logical) != g.physical_id:
                    self.catalog.delete_physical(g.physical_id)
        return evicted

    def evict_for_batch(self, logicals: Iterable[str]) -> Dict[str, List[int]]:
        """Batch admission accounting: after ``read_batch`` admits many
        results, run ONE budget-enforcement pass per distinct logical
        video instead of one per admission.  LRU_VSS sequence numbers —
        the expensive part (redundancy ranks and baseline guards over
        every physical) — are recomputed per *pass*, so N same-video
        admissions cost one recompute cascade, not N."""
        return {
            name: self.maybe_evict(name)
            for name in dict.fromkeys(logicals)
        }

    def _delete_gop(self, g: GopMeta) -> None:
        if g.joint_ref is not None:
            # jointly-compressed pieces are shared with the partner GOP:
            # only delete the region files once the *last* referent goes
            refs = self.catalog.gops_with_joint_ref(g.joint_ref)
            if len(refs) <= 1:
                rec = self.catalog.get_joint(g.joint_ref)
                for seg in rec.get("segments", []):
                    for key in seg["paths"].values():
                        self.backend.delete(key)
            return
        try:
            p = self.catalog.get_physical(g.physical_id)
        except KeyError:
            p = None
        if p is not None and p.tiles != (1, 1):
            # a tiled GOP is rows*cols objects under one catalog path
            for key in tile_keys(g.path, p.tiles):
                self.backend.delete(key)
            return
        self.backend.delete(g.path)
