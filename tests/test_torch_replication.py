"""`ReplicatedBackend`: placement, quorum writes, fallback reads, scrub.

The backend-level tests drive the quorum/fallback machinery directly
(including a child dying MID-batch and a child marked down); the
VSS-level tests prove the §2 pipeline rides through degraded storage —
one lost child of three must never lose a GOP or fail a read — and
that the scrubber restores full replication afterwards.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.storage import (
    ChildDownError,
    HashRing,
    LocalFSBackend,
    MemoryBackend,
    ObjectNotFound,
    ReplicatedBackend,
    ReplicationError,
    make_backend,
    unwrap,
    validate_gop_bytes,
)
from repro import storage as jstorage
from repro_torch import storage as tstorage
from repro_torch.core.config import VSSConfig
from repro_torch.core.store import VSS as _PortVSS


# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)


def VSS(root, *, config=None, **kw):
    """The port's store on the CPU (its default device is CUDA)."""
    cfg = config if config is not None else VSSConfig()
    return _PortVSS(root, config=dataclasses.replace(cfg, device="cpu"),
                    **kw)


@pytest.fixture()
def rb(tmp_path):
    b = ReplicatedBackend.local(str(tmp_path / "objects"), 3)
    yield b
    b.close()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_ring_preference_distinct_and_anchored():
    ring = HashRing(5)
    for key in (f"v/{i}/0.tvc" for i in range(50)):
        prefs = ring.preference(key, 3)
        assert len(prefs) == len(set(prefs)) == 3
        assert prefs[0] == ring.owner(key)
    # preference is a pure function of the slot count
    again = HashRing(5)
    assert all(
        again.preference(f"k{i}", 3) == ring.preference(f"k{i}", 3)
        for i in range(20)
    )


def test_replicas_for_spreads_over_children(rb):
    used = set()
    for i in range(60):
        prefs = rb.replicas_for(f"v/{i}/0.tvc")
        assert len(prefs) == rb.replicas == 3
        used.update(prefs)
    assert used == {0, 1, 2}


def test_put_lands_on_every_replica(rb):
    rb.put("v/1/0.tvc", b"payload")
    rb.quiesce()
    assert rb.replica_count("v/1/0.tvc") == 3
    for ci in rb.replicas_for("v/1/0.tvc"):
        assert rb.replica_get(ci, "v/1/0.tvc") == b"payload"


# ---------------------------------------------------------------------------
# quorum writes
# ---------------------------------------------------------------------------

def test_degraded_put_meets_quorum(rb):
    rb.mark_child_down(0)
    rb.put("k", b"x")
    rb.quiesce()
    assert rb.get("k") == b"x"
    assert rb.replica_count("k") == 2  # the down child holds nothing
    assert rb.stats.degraded_writes >= 1


def test_put_without_quorum_raises(rb):
    rb.mark_child_down(0)
    rb.mark_child_down(1)
    with pytest.raises(ReplicationError):
        rb.put("k", b"x")
    rb.mark_child_up(0)
    rb.put("k", b"x")  # quorum restored (W=2 of the 2 live children)
    rb.quiesce()
    assert rb.get("k") == b"x"


def test_batch_put_quorum_and_degraded(rb):
    items = [(f"v/{i}/0.tvc", f"d{i}".encode()) for i in range(12)]
    rb.mark_child_down(2)
    rb.batch_put(items)  # every object still reaches W=2 live replicas
    assert rb.batch_get([k for k, _ in items]) == [d for _, d in items]
    rb.mark_child_down(1)
    with pytest.raises(ReplicationError):
        rb.batch_put([("under-quorum", b"x")])


def test_child_down_error_is_immediate(rb):
    rb.mark_child_down(1)
    with pytest.raises(ChildDownError):
        rb.replica_get(1, "anything")
    rb.mark_child_up(1)


# ---------------------------------------------------------------------------
# read fallback
# ---------------------------------------------------------------------------

def test_get_falls_back_past_dead_child(rb):
    rb.put("v/1/0.tvc", b"survives")
    rb.quiesce()
    before = rb.stats.fallback_reads
    rb.mark_child_down(rb.replicas_for("v/1/0.tvc")[0])
    assert rb.get("v/1/0.tvc") == b"survives"
    assert rb.stats.fallback_reads > before


def test_missing_everywhere_raises_object_not_found(rb):
    with pytest.raises(ObjectNotFound):
        rb.get("nope")
    rb.mark_child_down(0)  # a down child must not mask a plain miss
    with pytest.raises(ObjectNotFound):
        rb.stat("nope")


def test_unreachable_data_is_unavailable_not_missing(rb):
    """Durable data whose live copies all sit behind down children must
    raise ReplicationError, never ObjectNotFound: absence is only
    reported when enough slots were VERIFIED empty that a quorum write
    could not be hiding on the unreachable rest."""
    rb.mark_child_down(2)
    rb.put("k", b"x")  # quorum lands on children 0 and 1 only
    rb.quiesce()
    rb.mark_child_up(2)
    rb.mark_child_down(0)
    rb.mark_child_down(1)  # the only copies are now unreachable
    with pytest.raises(ReplicationError):
        rb.get("k")
    with pytest.raises(ReplicationError):
        rb.batch_get(["k"])
    rb.mark_child_up(0)
    assert rb.get("k") == b"x"  # back as soon as one copy is reachable


class DyingChild(LocalFSBackend):
    """A child that serves ``fail_after`` gets, then dies mid-flight —
    every later op raises like a yanked disk."""

    def __init__(self, root, fail_after):
        super().__init__(root)
        self.remaining = fail_after

    def get(self, key):
        if self.remaining <= 0:
            raise OSError("disk died")
        self.remaining -= 1
        return super().get(key)


def test_batch_get_survives_child_dying_mid_batch(tmp_path):
    dying = DyingChild(str(tmp_path / "c0"), fail_after=2)
    rb = ReplicatedBackend([
        dying,
        LocalFSBackend(str(tmp_path / "c1")),
        LocalFSBackend(str(tmp_path / "c2")),
    ])
    keys = [f"v/{i}/0.tvc" for i in range(16)]
    rb.batch_put([(k, k.encode()) for k in keys])
    # the dying child is first preference for 2 of these keys: let it
    # serve ONE, then die mid-sublist — the rest must fall back
    dying.remaining = 1
    assert rb.batch_get(keys) == [k.encode() for k in keys]
    assert rb.stats.fallback_reads > 0
    rb.close()


def test_batch_get_preserves_order_while_degraded(rb):
    keys = [f"v/{i}/0.tvc" for i in range(20)]
    rb.batch_put([(k, f"p{i}".encode()) for i, k in enumerate(keys)])
    rb.mark_child_down(1)
    got = rb.batch_get(list(reversed(keys)))
    assert got == [f"p{i}".encode() for i in reversed(range(20))]


def test_kind_for_answers_per_replica(tmp_path):
    rb = ReplicatedBackend([
        MemoryBackend(),
        LocalFSBackend(str(tmp_path / "c1")),
        LocalFSBackend(str(tmp_path / "c2")),
    ])
    rb.put("k", b"x")
    rb.quiesce()
    assert rb.kind_for("k") == "memory"  # fastest live replica serves
    rb.mark_child_down(0)
    assert rb.kind_for("k") == "localfs"  # degraded read priced as disk
    rb.mark_child_up(0)
    assert rb.kind_for("k") == "memory"  # memo invalidated on recovery
    assert rb.kind_for("missing-everywhere") == "replicated"
    rb.close()


# ---------------------------------------------------------------------------
# spec / fingerprint
# ---------------------------------------------------------------------------

def test_make_backend_replicated_specs(tmp_path):
    root = str(tmp_path / "o")
    b = make_backend("replicated", root)
    # make_backend wraps with telemetry; attribute access delegates
    assert unwrap(b, ReplicatedBackend) is not None
    assert len(b.children) == 3 and b.replicas == 3 and b.write_quorum == 2
    b5 = make_backend("replicated:5", root + "5")
    assert len(b5.children) == 5 and b5.replicas == 3 and b5.write_quorum == 2
    b532 = make_backend("replicated:5:3:3", root + "532")
    assert b532.replicas == 3 and b532.write_quorum == 3
    with pytest.raises(ValueError):
        make_backend("replicated:3:2:3", root)  # W > R
    for b_ in (b, b5, b532):
        b_.close()


def test_layout_fingerprint_pins_children_and_replicas(tmp_path):
    a = ReplicatedBackend.local(str(tmp_path / "a"), 3)
    b = ReplicatedBackend.local(str(tmp_path / "b"), 3, write_quorum=3)
    c = ReplicatedBackend.local(str(tmp_path / "c"), 4)
    assert a.layout_fingerprint() == b.layout_fingerprint()  # W is not layout
    assert a.layout_fingerprint() != c.layout_fingerprint()
    for b_ in (a, b, c):
        b_.close()


# ---------------------------------------------------------------------------
# VSS end-to-end: degraded operation + scrub
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_clip():
    from repro_torch.data.video import synthesize_road

    return synthesize_road(30, width=128, height=96, seed=3)


@pytest.fixture()
def rvss(tmp_path):

    store = VSS(str(tmp_path / "vss"),
                backend=ReplicatedBackend.local(
                    str(tmp_path / "vss" / "objects"), 3))
    yield store
    store.close()


def _gop_keys(vss, name):
    return [
        g.path
        for p in vss.catalog.physicals_for(name)
        for g in vss.catalog.gops_for(p.physical_id)
        if g.joint_ref is None
    ]


def test_vss_reads_survive_any_single_child_loss(rvss, short_clip):
    rvss.write("v", short_clip, fps=30.0, codec="tvc-hi", gop_frames=10)
    rvss.backend.quiesce()
    keys = _gop_keys(rvss, "v")
    assert keys and all(
        rvss.backend.replica_count(k) == 3 for k in keys
    )
    baseline = rvss.read("v", codec="rgb", cache=False).frames
    for victim in range(3):
        rvss.backend.mark_child_down(victim)
        out = rvss.read("v", codec="rgb", cache=False).frames
        assert np.array_equal(out, baseline)
        rvss.backend.mark_child_up(victim)


def test_vss_ingest_flows_while_degraded(rvss, short_clip):
    """Quorum writes keep the pipelined ingest path alive with a child
    down: windows publish, rows index, prefix reads work."""
    rvss.backend.mark_child_down(2)
    w = rvss.writer("cam", fps=30.0, codec="tvc-med", gop_frames=10)
    w.append(short_clip)
    w.close()
    out = rvss.read("cam", codec="rgb", cache=False).frames
    assert out.shape == short_clip.shape
    rvss.backend.mark_child_up(2)
    report = rvss.scrub()  # re-replicates what the dead child missed
    assert report.replicas_repaired > 0
    assert all(
        rvss.backend.replica_count(k) == 3 for k in _gop_keys(rvss, "cam")
    )


def test_crash_between_quorum_write_and_index_collects_all_replicas(
        tmp_path, short_clip):
    """Publish-then-index: a crash after the quorum write but before the
    catalog row leaves replicas on EVERY child — the startup scrub must
    collect the orphan from all of them."""

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="replicated:3")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    orphan = "v/9/0.tvc"
    vss.backend.put(orphan, b"published-but-never-indexed")
    vss.backend.quiesce()
    assert vss.backend.replica_count(orphan) == 3
    vss.catalog.close()  # crash: no clean-shutdown marker
    vss.backend.close()

    vss2 = VSS(root, backend="replicated:3")
    try:
        assert vss2.recovery.orphans_removed == 1
        assert all(
            not child.exists(orphan) for child in vss2.backend.children
        )
        out = vss2.read("v", codec="rgb", cache=False).frames
        assert out.shape == short_clip.shape
    finally:
        vss2.close()


def test_scrub_repairs_deliberately_corrupted_replica(rvss, short_clip):
    rvss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    rvss.backend.quiesce()
    key = _gop_keys(rvss, "v")[0]
    ci = rvss.backend.replicas_for(key)[1]
    good = rvss.backend.replica_get(ci, key)
    rvss.backend.replica_put(ci, key, good[: len(good) // 2])  # torn copy
    assert not validate_gop_bytes(rvss.backend.replica_get(ci, key))
    report = rvss.scrub()
    assert report.replicas_repaired == 1
    assert report.gops_dropped == 0
    assert rvss.backend.replica_get(ci, key) == good
    out = rvss.read("v", codec="rgb", cache=False).frames
    assert out.shape == short_clip.shape


def test_scrub_restores_replication_after_disk_replacement(rvss, short_clip):
    rvss.write("v", short_clip, fps=30.0, codec="tvc-hi", gop_frames=10)
    rvss.backend.quiesce()
    keys = _gop_keys(rvss, "v")
    child0 = rvss.backend.children[0]
    lost = [k for k in keys if 0 in rvss.backend.replicas_for(k)]
    shutil.rmtree(child0.root)  # the disk is replaced, empty
    os.makedirs(child0.root)
    report = rvss.scrub()
    assert report.replicas_repaired == len(lost) > 0
    assert report.gops_dropped == 0
    assert all(rvss.backend.replica_count(k) == 3 for k in keys)


def test_scrub_skips_unverifiable_slots_on_down_child(rvss, short_clip):
    """A down child's replicas are skipped, never condemned: no rows
    drop, and the scrub reports what it could not check."""
    rvss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    rvss.backend.quiesce()
    rvss.backend.mark_child_down(1)
    report = rvss.scrub()
    assert report.gops_dropped == 0
    assert report.replicas_skipped > 0
    assert not report.clean
    rvss.backend.mark_child_up(1)
    assert rvss.scrub().clean


def test_scrub_drops_row_only_when_every_slot_verified_empty(rvss,
                                                             short_clip):
    rvss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    rvss.backend.quiesce()
    key = _gop_keys(rvss, "v")[0]
    n_before = len(rvss.catalog.all_gops())
    for ci in rvss.backend.replicas_for(key):
        rvss.backend.replica_delete(ci, key)  # operator-level total loss
    report = rvss.scrub()
    assert report.gops_dropped == 1
    assert len(rvss.catalog.all_gops()) == n_before - 1
    # committed siblings (the later GOPs) stay readable
    out = rvss.read("v", t=(0.5, 1.0), codec="rgb", cache=False).frames
    assert out.shape[0] == 15


def test_scrub_prunes_misplaced_replica(tmp_path, short_clip):
    """R < N: a copy sitting on a child outside the key's placement set
    (ring change, delete racing a straggler) is pruned, and the
    legitimate replicas are untouched."""

    vss = VSS(str(tmp_path / "vss"), backend="replicated:4")  # R=3 of 4
    try:
        vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
        vss.backend.quiesce()
        key = _gop_keys(vss, "v")[0]
        stray = next(
            ci for ci in range(4)
            if ci not in vss.backend.replicas_for(key)
        )
        vss.backend.replica_put(stray, key, vss.backend.get(key))
        report = vss.scrub()
        assert report.replicas_pruned == 1
        assert not vss.backend.children[stray].exists(key)
        assert vss.backend.replica_count(key) == 3
    finally:
        vss.close()


def test_tiered_over_replicated_scrub_reaches_the_replicas(tmp_path,
                                                           short_clip):
    """`tiered:replicated` is env-selectable; scrub/recover must reach
    THROUGH the hot tier to the replica layer — a generic scavenge
    probing via the wrapper would be satisfied by read-fallback and
    never notice a lost replica."""

    vss = VSS(str(tmp_path / "vss"), backend="tiered:replicated:3")
    try:
        vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
        cold = vss.backend.cold
        cold.quiesce()
        key = _gop_keys(vss, "v")[0]
        victim = cold.replicas_for(key)[0]
        cold.replica_delete(victim, key)
        assert cold.replica_count(key) == 2
        report = vss.scrub()
        assert report.replicas_repaired == 1
        assert cold.replica_count(key) == 3
    finally:
        vss.close()


def test_online_scrub_never_collects_unreferenced_keys(rvss, short_clip):
    """Publishes are put-then-index, so to an ONLINE scrub a concurrent
    writer's freshly published window is indistinguishable from an
    orphan — the default scrub must leave unreferenced keys alone;
    collect_orphans=True (writes quiesced) collects them."""
    rvss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    rvss.backend.put("v/9/0.tvc", b"published-not-yet-indexed")
    rvss.backend.quiesce()
    report = rvss.scrub()
    assert report.orphans_removed == 0
    assert rvss.backend.exists("v/9/0.tvc")  # untouched
    report2 = rvss.scrub(collect_orphans=True)
    assert report2.orphans_removed == 1
    assert not rvss.backend.exists("v/9/0.tvc")


def test_replicated_store_reopens_under_same_layout(tmp_path, short_clip):

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="replicated:3")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.close()
    with pytest.raises(ValueError, match="storage layout"):
        VSS(root, backend="replicated:4")
    vss2 = VSS(root, backend="replicated:3")
    try:
        assert vss2.read("v", codec="rgb", cache=False).frames.shape \
            == short_clip.shape
    finally:
        vss2.close()


# ---------------------------------------------------------------------------
# the port against the reference: placement, fallback and scrub
# ---------------------------------------------------------------------------

def _child_files(root, n):
    return [sorted(os.listdir(os.path.join(root, f"replica{i}")))
            if os.path.isdir(os.path.join(root, f"replica{i}")) else []
            for i in range(n)]


@pytest.mark.parametrize("n,r,w", [(3, 3, 2), (3, 2, 2), (4, 3, 2),
                                   (5, 3, 3)])
def test_replica_placement_matches_reference(tmp_path, n, r, w):
    """Both packages place every key on the same children, in the same
    preference order, and lay the same files out under each child."""
    keys = [f"v/{i}/{j}.tvc" for i in range(10) for j in range(6)]
    roots, placed = [], []
    for S, name in ((jstorage, "j"), (tstorage, "t")):
        root = str(tmp_path / name)
        b = S.ReplicatedBackend.local(root, n, replicas=r, write_quorum=w)
        b.batch_put([(k, k.encode()) for k in keys])
        b.quiesce()
        placed.append([b.replicas_for(k) for k in keys])
        assert b.layout_fingerprint() == f"replicated:{n}:{r}"
        b.close()
        roots.append(root)
    assert placed[1] == placed[0]
    for i in range(n):
        got = [sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _dirs, files in os.walk(
                          os.path.join(root, f"replica{i}"))
                      for f in files) for root in roots]
        assert got[1] == got[0]


def test_fallback_reads_match_reference(tmp_path):
    """A child's directory lost: both packages read every key through
    the same number of fallbacks and see the same keys under-replicated."""
    keys = [f"v/{i}/0.tvc" for i in range(24)]
    got = []
    for S, name in ((jstorage, "j"), (tstorage, "t")):
        root = str(tmp_path / name)
        b = S.ReplicatedBackend.local(root, 3, replicas=2, write_quorum=2)
        b.batch_put([(k, k.encode() * 9) for k in keys])
        b.quiesce()
        shutil.rmtree(b.children[1].root)
        os.makedirs(b.children[1].root)
        values = [b.get(k) for k in keys]
        fallbacks = b.stats.fallback_reads
        lost = sorted(k for k in keys if b.replica_count(k) < 2)
        got.append((values, fallbacks, lost))
        b.close()
    assert got[1] == got[0]
    assert got[0][1] > 0 and got[0][2]


def test_store_scrub_after_child_loss_matches_reference(tmp_path,
                                                        short_clip):
    """The backends phase of the chip smoke test, on the CPU: a
    ``replicated:3:2:2`` store in each package loses one child's
    directory, reads through fallbacks, and the scrub restores every
    replica with the same report; frames equal before and after."""
    from repro.core.config import VSSConfig as JConfig
    from repro.core.store import VSS as JVSS

    got = []
    for make, config, S, name in ((JVSS, JConfig, jstorage, "j"),
                                  (VSS, VSSConfig, tstorage, "t")):
        vss = make(str(tmp_path / name),
                   config=config(backend="replicated:3:2:2"))
        try:
            vss.write("v", short_clip, fps=30.0, codec="tvc-hi",
                      gop_frames=10)
            rb = S.unwrap(vss.backend, S.ReplicatedBackend)
            rb.quiesce()
            before = vss.read("v", codec="rgb", cache=False).frames
            shutil.rmtree(rb.children[0].root)
            os.makedirs(rb.children[0].root)
            fb0 = rb.stats.fallback_reads
            degraded = vss.read("v", codec="rgb", cache=False).frames
            fallbacks = rb.stats.fallback_reads - fb0
            report = vss.scrub()
            counts = {k: rb.replica_count(k) for k in _gop_keys(vss, "v")}
            after = vss.read("v", codec="rgb", cache=False).frames
        finally:
            vss.close()
        assert np.array_equal(degraded, before)
        assert np.array_equal(after, before)
        assert fallbacks > 0 and set(counts.values()) == {2}
        got.append((before, fallbacks, report.replicas_repaired,
                    report.gops_dropped, counts))
    assert np.array_equal(got[1][0], got[0][0])
    assert got[1][1:] == got[0][1:]
    assert got[0][2] > 0
