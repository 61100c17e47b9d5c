"""Startup scavenger + replica scrubber — reconcile objects and catalog.

The write protocol is: (1) put the payload (atomic temp + replace),
(2) insert the catalog row.  SQLite commits are atomic, so after a
crash exactly three illegal states can exist, and each has one owner:

  * an in-flight temp artifact (crash during step 1)
      → `sweep_temps` removes it;
  * an object no catalog row references (crash between 1 and 2, or a
    row deleted whose delete(key) never ran)
      → orphan, removed;
  * a catalog row whose object is missing or fails validation (an
    operator-level fault: disk loss, manual truncation — the atomic
    protocol itself never produces this)
      → the row is dropped so reads plan around the hole, exactly like
        a cache-evicted GOP; committed siblings stay readable.

One benign mismatch is repaired rather than dropped: a crash between
the deferred compressor's `put` and its catalog `nbytes` update leaves
a valid (smaller, zstd-wrapped) object with a stale size — the row's
size is corrected in place.

`scrub` is the replicated-placement counterpart (`ReplicatedBackend`
runs it both at startup `recover` and behind `VSS.scrub()`): the
generic scavenge can't see a single lost replica — `stat`/`get` fall
back to a surviving copy, so the backend looks whole right up until
the LAST copy dies.  The scrubber walks the catalog per replica
instead: every copy of every referenced object is fetched and
validated with `validate_gop_bytes`, under-replicated or torn or
divergent objects are re-replicated from a healthy copy, orphan and
misplaced replicas are pruned per child, and a row is dropped only
when every placement slot was *verified* empty — a down child's slots
are skipped (counted, never condemned), so one dead volume can't turn
into catalog data loss.
"""
from __future__ import annotations

from repro_torch.storage.base import (
    ObjectNotFound,
    RecoveryReport,
    ScrubReport,
    StorageBackend,
)


def tile_keys(path, tiles):
    # lazy import: storage must stay importable without repro_torch.core, but
    # tile-key layout has exactly one definition (repro_torch.core.types)
    from repro_torch.core.types import tile_keys as _tk

    return _tk(path, tiles)


def validate_gop_bytes(data: bytes) -> bool:
    """True iff ``data`` parses as one complete GOP object (optionally
    deferred-wrapped).  Truncated compressed payloads fail to inflate,
    which is what makes this a real end-of-object integrity check."""
    from repro_torch import codec as _codec
    from repro_torch.codec import tvc as _tvc
    from repro_torch.core.deferred import is_wrapped, unwrap_bytes

    try:
        if is_wrapped(data):
            data = unwrap_bytes(data)
        enc = _codec.deserialize_gop(data)
        t, h, w, c = enc.shape
        if enc.codec == _tvc.RGB:
            return len(enc.payload) == t * h * w * c
        tier = _tvc.TIERS[enc.codec]
        raw = _tvc._raw_payload(enc)  # v1 single-stream or v2 chunked
        isz = h * w * c
        expected = isz + (t - 1) * isz * (tier.resid_bits // 8)
        return len(raw) == expected
    except Exception:
        return False


def scavenge(backend: StorageBackend, catalog, *,
             collect_orphans: bool = True) -> RecoveryReport:
    """``collect_orphans=False`` skips the final unreferenced-key sweep.
    Orphan deletion is only safe while nothing is publishing: the write
    protocol is put-then-index, so a concurrent publisher's object is
    briefly an "orphan" that deleting would turn into an
    indexed-but-missing GOP.  Startup recovery (single-threaded) always
    collects; an online scrub must not."""
    report = RecoveryReport()
    report.temps_removed = backend.sweep_temps()

    tiles_of = _tiled_physicals(catalog)
    referenced = set(catalog.all_joint_segment_paths())
    for g in catalog.all_gops():
        if g.joint_ref is not None:
            continue  # payload lives in the joint record's segment objects
        tiles = tiles_of.get(g.physical_id)
        if tiles is not None:
            keys = tile_keys(g.path, tiles)
            referenced.update(keys)
            _scavenge_tiled(backend, catalog, g, keys, report)
            continue
        referenced.add(g.path)
        try:
            st = backend.stat(g.path)
        except ObjectNotFound:
            _drop_gop(catalog, g)
            report.gops_dropped += 1
            continue
        if st.nbytes == g.nbytes:
            continue
        data = backend.get(g.path)
        if validate_gop_bytes(data):
            catalog.update_gop(g.gop_id, nbytes=len(data),
                               zwrapped=_looks_wrapped(data))
            report.gops_repaired += 1
        else:
            backend.delete(g.path)
            _drop_gop(catalog, g)
            report.gops_dropped += 1

    if collect_orphans:
        for key in backend.list():
            if key not in referenced:
                backend.delete(key)
                report.orphans_removed += 1
    return report


def _tiled_physicals(catalog):
    """{physical_id: (rows, cols)} for every tiled physical video —
    their GOP rows map to rows*cols tile objects, not one object."""
    return {
        p.physical_id: p.tiles
        for p in catalog.all_physicals()
        if p.tiles != (1, 1)
    }


def _scavenge_tiled(backend, catalog, g, keys, report) -> None:
    """Scavenge one tiled GOP: the row is whole iff EVERY tile object
    exists and validates; a valid set with stale sizes is repaired in
    place (nbytes + tile_sizes), anything else drops the row and its
    surviving tiles (a GOP missing one tile cannot be stitched)."""
    import json as _json

    sizes = []
    for key in keys:
        try:
            sizes.append(backend.stat(key).nbytes)
        except ObjectNotFound:
            sizes = None
            break
    if sizes is not None and tuple(sizes) == (g.tile_sizes or ()) \
            and sum(sizes) == g.nbytes:
        return
    if sizes is not None:
        datas = [backend.get(key) for key in keys]
        if all(validate_gop_bytes(d) for d in datas):
            catalog.update_gop(
                g.gop_id,
                nbytes=sum(len(d) for d in datas),
                tile_sizes=_json.dumps([len(d) for d in datas]),
            )
            report.gops_repaired += 1
            return
    for key in keys:
        backend.delete(key)  # idempotent on missing keys
    _drop_gop(catalog, g)
    report.gops_dropped += 1


# ---------------------------------------------------------------------------
# replica scrubber (ReplicatedBackend.recover / VSS.scrub)
# ---------------------------------------------------------------------------

def scrub(backend, catalog, *, collect_orphans: bool = False) -> ScrubReport:
    """Validate and self-heal every replica of every catalog object.

    ``backend`` is a `ReplicatedBackend` (anything exposing
    ``replicas_for``/``replica_get``/``replica_put``/``replica_delete``/
    ``replica_list``/``live_children``).  See the module docstring for
    the invariants; in short — repair from any healthy copy, prune what
    nothing references, skip (never condemn) what a down child makes
    unverifiable.

    Validation, repair and misplaced-replica pruning are safe against
    concurrent publishes (a catalog row's objects are durable before
    the row exists, and writers only ever touch a key's own replica
    set).  Deleting UNREFERENCED keys is not — a publisher mid
    put-then-index looks exactly like an orphan — so the orphan sweep
    runs only with ``collect_orphans=True`` (startup recovery, or an
    operator who has quiesced writes)."""
    report = ScrubReport()
    report.temps_removed = backend.sweep_temps()

    tiles_of = _tiled_physicals(catalog)
    referenced = set(catalog.all_joint_segment_paths())
    for g in catalog.all_gops():
        if g.joint_ref is not None:
            continue  # payload lives in the joint record's segment objects
        tiles = tiles_of.get(g.physical_id)
        if tiles is not None:
            keys = tile_keys(g.path, tiles)
            referenced.update(keys)
            _scrub_tiled(backend, catalog, g, keys, report)
            continue
        referenced.add(g.path)
        healthy, torn, missing, down = _probe(backend, g.path,
                                              validate=validate_gop_bytes)
        report.replicas_skipped += len(down)
        if not healthy:
            if down:
                continue  # a down child may hold the last good copy
            for ci in torn:
                backend.replica_delete(ci, g.path)
            _drop_gop(catalog, g)
            report.gops_dropped += 1
            continue
        # canonical copy: prefer the replica matching the row's recorded
        # size (a deferred rewrite that reached quorum is canonical even
        # while a straggler child still holds the older, larger object)
        canonical = next(
            (d for _ci, d in healthy if len(d) == g.nbytes), healthy[0][1]
        )
        if len(canonical) != g.nbytes:
            catalog.update_gop(g.gop_id, nbytes=len(canonical),
                               zwrapped=_looks_wrapped(canonical))
            report.gops_repaired += 1
        divergent = [ci for ci, d in healthy if d != canonical]
        for ci in (*missing, *torn, *divergent):
            backend.replica_put(ci, g.path, canonical)
            report.replicas_repaired += 1

    # joint segment objects are not standalone GOPs (no byte-level
    # validation applies) — repair by existence only
    for key in catalog.all_joint_segment_paths():
        healthy, torn, missing, down = _probe(backend, key, validate=None)
        report.replicas_skipped += len(down)
        if not healthy:
            continue  # unrepairable here; reads fall back / plan around
        data = healthy[0][1]
        for ci in (*missing, *torn):
            backend.replica_put(ci, key, data)
            report.replicas_repaired += 1

    # orphan + misplacement sweep, per child (the union-level sweep in
    # `scavenge` would miss a replica sitting on the wrong child)
    orphan_keys = set()
    for ci in backend.live_children():
        for key in backend.replica_list(ci):
            if key not in referenced:
                if collect_orphans:
                    backend.replica_delete(ci, key)
                    orphan_keys.add(key)
            elif ci not in backend.replicas_for(key):
                backend.replica_delete(ci, key)
                report.replicas_pruned += 1
    report.orphans_removed = len(orphan_keys)
    return report


def _scrub_tiled(backend, catalog, g, keys, report) -> None:
    """Scrub one tiled GOP's tile objects across replicas.

    Per tile: repair missing/torn/divergent replicas from a healthy
    copy (same invariants as the whole-object path).  The row is
    dropped only when some tile has NO healthy copy anywhere and no
    down child could still hold one — then every surviving tile of the
    GOP is pruned too (an incomplete tile set cannot be stitched)."""
    import json as _json

    canon_sizes, lost = [], False
    for i, key in enumerate(keys):
        healthy, torn, missing, down = _probe(backend, key,
                                              validate=validate_gop_bytes)
        report.replicas_skipped += len(down)
        if not healthy:
            if down:
                return  # a down child may hold the last good copy
            lost = True
            break
        want = g.tile_sizes[i] if (
            g.tile_sizes and i < len(g.tile_sizes)
        ) else None
        canonical = next(
            (d for _ci, d in healthy if len(d) == want), healthy[0][1]
        )
        canon_sizes.append(len(canonical))
        divergent = [ci for ci, d in healthy if d != canonical]
        for ci in (*missing, *torn, *divergent):
            backend.replica_put(ci, key, canonical)
            report.replicas_repaired += 1
    if lost:
        for key in keys:
            for ci in backend.replicas_for(key):
                try:
                    backend.replica_delete(ci, key)
                except Exception:
                    pass  # a down child's copy is swept by a later scrub
        _drop_gop(catalog, g)
        report.gops_dropped += 1
        return
    if tuple(canon_sizes) != (g.tile_sizes or ()) \
            or sum(canon_sizes) != g.nbytes:
        catalog.update_gop(
            g.gop_id,
            nbytes=sum(canon_sizes),
            tile_sizes=_json.dumps(canon_sizes),
        )
        report.gops_repaired += 1


def _probe(backend, key, validate=None):
    """Classify every placement slot of ``key``: (healthy [(ci, data)],
    torn [ci], missing [ci], down/unverifiable [ci])."""
    healthy, torn, missing, down = [], [], [], []
    for ci in backend.replicas_for(key):
        try:
            data = backend.replica_get(ci, key)
        except ObjectNotFound:
            missing.append(ci)
        except Exception:
            down.append(ci)  # unreachable child: unverifiable, not absent
        else:
            if validate is not None and not validate(data):
                torn.append(ci)
            else:
                healthy.append((ci, data))
    return healthy, torn, missing, down


def _looks_wrapped(data: bytes) -> bool:
    from repro_torch.core.deferred import is_wrapped

    return is_wrapped(data)


def _drop_gop(catalog, g) -> None:
    catalog.delete_gop(g.gop_id)
    if not catalog.gops_for(g.physical_id):
        # an empty original keeps its metadata row (it defines the
        # logical video's bounds), matching CacheManager.maybe_evict
        try:
            p = catalog.get_physical(g.physical_id)
        except KeyError:
            return
        if catalog.get_original_id(p.logical) != g.physical_id:
            catalog.delete_physical(g.physical_id)
