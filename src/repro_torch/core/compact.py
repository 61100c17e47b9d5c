"""Physical video compaction — §5.3.

Caching (and deferred compression) leaves behind pairs of cached videos
with contiguous time and identical spatial/physical configuration, e.g.
entries at [0, 90) and [90, 120). Read planning is (in the worst case)
exponential in fragment count, so VSS periodically and non-quiescently
merges each contiguous pair into a unified representation: the second
video's GOP objects are re-keyed under the first video (copy-on-merge
through the storage backend — backends need no rename/link primitive),
the catalog rows are moved, and the second video is dropped.
"""
from __future__ import annotations


from repro_torch.core.catalog import Catalog
from repro_torch.core.types import PhysicalMeta, mse_to_psnr


def _compatible(a: PhysicalMeta, b: PhysicalMeta, tol: float) -> bool:
    # quality bounds are *measured* (sampled exact MSE, §3.2) so two views
    # of the same configuration differ slightly; compare in dB (the unit
    # admission decisions are made in) and keep the conservative bound
    close_bound = (
        abs(mse_to_psnr(a.mse_bound) - mse_to_psnr(b.mse_bound)) <= 2.0
        or (a.mse_bound == 0.0 and b.mse_bound == 0.0)
    )
    return (
        a.width == b.width
        and a.height == b.height
        and a.fps == b.fps
        and a.codec == b.codec
        and a.roi == b.roi
        and not a.is_original
        and not b.is_original
        and abs(a.t_end - b.t_start) < tol
        and close_bound
    )


def compact_once(catalog: Catalog, logical: str, backend) -> int:
    """Merge one contiguous pair; returns number of pairs merged (0/1)."""
    physicals = sorted(
        catalog.physicals_for(logical), key=lambda p: (p.t_start, p.t_end)
    )
    for a in physicals:
        tol = 0.5 / max(a.fps, 1.0)
        for b in physicals:
            if a.physical_id == b.physical_id:
                continue
            if not _compatible(a, b, tol):
                continue
            _merge(catalog, a, b, backend)
            return 1
    return 0


def compact(catalog: Catalog, logical: str, backend, max_pairs: int = 64) -> int:
    total = 0
    for _ in range(max_pairs):
        merged = compact_once(catalog, logical, backend)
        if not merged:
            break
        total += merged
    return total


def _merge(catalog: Catalog, a: PhysicalMeta, b: PhysicalMeta, backend):
    """Append b's GOPs to a (re-key objects, then drop b's copies §5.3).

    The whole merge is batched through the backend: one ``batch_get``
    of b's objects, one ``batch_put`` under the merged keys (sharded
    backends fan both out), then the catalog rows move in one
    transaction and the old keys retire.  Publish-before-index order is
    preserved batch-wide — a crash anywhere in between leaves orphans
    for the scavenger, never a dangling catalog row.
    """
    a_gops = catalog.gops_for(a.physical_id)
    b_gops = catalog.gops_for(b.physical_id)
    next_idx = (max(g.index for g in a_gops) + 1) if a_gops else 0
    frame_offset = int(round((b.t_start - a.t_start) * a.fps))
    new_keys = [
        f"{a.logical}/{a.physical_id}/{next_idx + j}.tvc"
        for j in range(len(b_gops))
    ]
    blobs = backend.batch_get([g.path for g in b_gops])
    backend.batch_put(list(zip(new_keys, blobs)))
    catalog.add_gops([
        (a.physical_id, next_idx + j, frame_offset + g.start_frame,
         g.num_frames, g.nbytes, new_keys[j], g.lru_seq)
        for j, g in enumerate(b_gops)
    ])
    for g in b_gops:
        catalog.delete_gop(g.gop_id)
        backend.delete(g.path)
    catalog.extend_physical_time(a.physical_id, b.t_end)
    if b.mse_bound > a.mse_bound:
        catalog.set_physical_bound(a.physical_id, b.mse_bound)
    catalog.delete_physical(b.physical_id)
