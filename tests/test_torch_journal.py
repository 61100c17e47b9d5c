"""Write-back journal: format, watermark reclamation, and the chaos
gate — no acknowledged write is ever lost across a crash, a hot-tier
wipe, or a cold-tier outage (VSS §3 write-back + WAL durability).

`_crash` simulates a process death: the flusher stops, nothing is
flushed or closed, and the journal file is abandoned exactly as a
kill -9 would leave it (every acknowledged PUT is already fsync'd)."""
import os
import random

import pytest

from repro_torch.storage import (
    MemoryBackend,
    ObjectNotFound,
    TieredBackend,
    WriteBackJournal,
)
from repro import storage as jstorage
from repro_torch import storage as tstorage
from repro_torch.storage.journal import MAGIC, _HEADER


def _crash(tier):
    """Kill the tier mid-whatever: stop the flusher, skip every
    graceful-shutdown step (no flush, no journal close, no cold
    close).  What the journal fsync'd is all recovery gets."""
    with tier._cv:
        tier._stop = True
        tier._cv.notify_all()
    if tier._flusher is not None:
        tier._flusher.join(timeout=10.0)


class _OutageCold(MemoryBackend):
    """A cold tier that hard-fails every op while ``down`` (full
    network partition, not just write failures)."""

    def __init__(self):
        super().__init__()
        self.down = False

    def _check(self):
        if self.down:
            raise IOError("cold tier unreachable")

    def put(self, key, data):
        self._check()
        super().put(key, data)

    def get(self, key):
        self._check()
        return super().get(key)

    def stat(self, key):
        self._check()
        return super().stat(key)


class _CountingCold(MemoryBackend):
    """Counts uploads per key — the re-upload detector for the
    replay-idempotency contract."""

    def __init__(self):
        super().__init__()
        self.put_counts = {}

    def put(self, key, data):
        self.put_counts[key] = self.put_counts.get(key, 0) + 1
        super().put(key, data)


# ---------------------------------------------------------------------------
# journal unit tests: format, truncated tails, watermark reclamation
# ---------------------------------------------------------------------------

def test_journal_replay_returns_latest_uncommitted_puts(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d)
    j.append_put("a", b"old")
    j.append_puts([("a", b"new"), ("b", b"B")])  # one fsync for the group
    j.append_put("c", b"C")
    j.append_commit(["b"])
    j.append_delete("c")
    j.close()

    j2 = WriteBackJournal(d)
    assert j2.replay() == {"a": b"new"}  # latest value, settled keys gone
    assert j2.pending_keys() == ["a"]
    j2.close()


def test_journal_replay_stops_at_truncated_tail(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d)
    j.append_put("a", b"A" * 100)
    j.append_put("b", b"B" * 100)
    j.close()
    (seg,) = [n for n in os.listdir(d) if n.endswith(".vssj")]
    path = os.path.join(d, seg)
    os.truncate(path, os.path.getsize(path) - 37)  # tear the last record

    j2 = WriteBackJournal(d)
    assert j2.replay() == {"a": b"A" * 100}  # prefix survives the tear
    j2.close()


def test_journal_replay_stops_at_corrupt_record(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d)
    j.append_put("a", b"A" * 50)
    j.append_put("b", b"B" * 50)
    j.close()
    (seg,) = [n for n in os.listdir(d) if n.endswith(".vssj")]
    path = os.path.join(d, seg)
    # flip one payload byte inside the SECOND record
    offset = len(MAGIC) + _HEADER.size + len("a") + 50 + _HEADER.size + 2
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))

    j2 = WriteBackJournal(d)
    assert j2.replay() == {"a": b"A" * 50}  # crc catches the flip
    j2.close()


def test_journal_watermark_reclaims_fully_committed_segments(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d, segment_bytes=4096)
    payload = os.urandom(1500)
    for i in range(8):  # forces several rotations
        j.append_put(f"k{i}", payload)
    segs_before = [n for n in os.listdir(d) if n.endswith(".vssj")]
    assert len(segs_before) > 2
    j.append_commit([f"k{i}" for i in range(8)])
    # every sealed segment's pending count hit zero -> unlinked; only
    # the active segment (holding the COMMIT records) may remain
    segs_after = [n for n in os.listdir(d) if n.endswith(".vssj")]
    assert len(segs_after) <= 1
    j.close()
    assert not [n for n in os.listdir(d) if n.endswith(".vssj")]


def test_journal_empty_close_leaves_no_files(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d)
    j.append_put("k", b"x")
    j.append_commit(["k"])
    j.close()
    assert not [n for n in os.listdir(d) if n.endswith(".vssj")]


def test_journal_never_appends_to_preexisting_segment(tmp_path):
    d = str(tmp_path / "j")
    j = WriteBackJournal(d)
    j.append_put("a", b"A")
    j.close()
    j2 = WriteBackJournal(d)
    j2.replay()
    j2.append_put("b", b"B")  # must land in a NEW segment
    segs = sorted(n for n in os.listdir(d) if n.endswith(".vssj"))
    assert len(segs) == 2
    j2.close()


# ---------------------------------------------------------------------------
# the chaos gate: crash / wipe / outage, zero acknowledged writes lost
# ---------------------------------------------------------------------------

def _tier(cold, jdir, **kw):
    kw.setdefault("hot_bytes", 1 << 20)
    return TieredBackend(cold, write_back=True, journal_dir=jdir, **kw)


def test_chaos_crash_mid_outage_loses_no_acknowledged_write(tmp_path):
    """Kill the process mid-flush-retry during a cold-tier outage:
    every acknowledged write must be readable after recovery — first
    from the replayed journal while the cold tier is STILL down, then
    durably cold once it heals."""
    cold = _OutageCold()
    jdir = str(tmp_path / "journal")
    acked = {}

    t1 = _tier(cold, jdir)
    for i in range(4):  # healthy: these flush (or are flushing)
        k, v = f"pre/{i}", os.urandom(64)
        t1.put(k, v)
        acked[k] = v
    t1.flush()
    cold.down = True  # outage begins
    for i in range(6):  # acknowledged during the outage: journal-only
        k, v = f"out/{i}", os.urandom(64)
        t1.put(k, v)
        acked[k] = v
    _crash(t1)  # die mid-retry

    # recovery with the cold tier still down: the journal is the only
    # copy of the outage-era writes, and it must serve them
    t2 = _tier(cold, jdir)
    for k, v in acked.items():
        if k.startswith("out/"):
            assert t2.get(k) == v
    assert sorted(t2.dirty_keys()) == sorted(
        k for k in acked if k.startswith("out/"))
    with pytest.raises(RuntimeError):
        t2.flush()  # honest failure, not silent loss

    cold.down = False  # the outage heals
    assert t2.retry_failed() > 0
    t2.flush()
    t2._drop_hot()  # hot-tier wipe: cold must now hold everything
    for k, v in acked.items():
        assert t2.get(k) == v
        assert cold.get(k) == v
    t2.close()
    # a drained journal leaves nothing to replay
    t3 = _tier(cold, jdir)
    assert t3.dirty_keys() == []
    t3.close()


def test_chaos_repeated_crashes_keep_every_acknowledgement(tmp_path):
    """Crash, recover, write more, crash again — acknowledgements from
    every incarnation survive, overwrites keep last-write-wins."""
    cold = _OutageCold()
    cold.down = True  # nothing ever flushes until the very end
    jdir = str(tmp_path / "journal")
    acked = {}

    t = _tier(cold, jdir)
    for round_no in range(3):
        for i in range(4):
            k = f"k{i}"
            v = f"round{round_no}-{i}".encode() * 8
            t.put(k, v)
            acked[k] = v
        _crash(t)
        t = _tier(cold, jdir)
        for k, v in acked.items():
            assert t.get(k) == v, f"lost {k!r} after crash {round_no}"

    cold.down = False
    t.retry_failed()
    t.flush()
    t.close()
    for k, v in acked.items():
        assert cold.get(k) == v


def test_chaos_delete_is_not_resurrected_by_replay(tmp_path):
    """A journaled DELETE must win over the earlier journaled PUT:
    replay must not resurrect the object."""
    cold = MemoryBackend()
    jdir = str(tmp_path / "journal")
    t1 = _tier(cold, jdir)
    t1.put("k", b"doomed")
    t1.delete("k")
    _crash(t1)

    t2 = _tier(cold, jdir)
    assert t2.dirty_keys() == []
    with pytest.raises(ObjectNotFound):
        t2.get("k")
    t2.close()


# ---------------------------------------------------------------------------
# replay idempotency: flushed-but-uncommitted keys never re-upload
# ---------------------------------------------------------------------------

def test_replay_settles_flushed_but_uncommitted_keys_without_reupload(
        tmp_path):
    """The crash window between a successful cold put and the COMMIT
    append (which is deliberately not fsync'd) leaves a PUT record
    with no COMMIT.  Replay cross-checks the cold tier, finds the
    bytes already there, and settles the key WITHOUT a second upload
    and without re-dirtying it."""
    jdir = str(tmp_path / "journal")
    j = WriteBackJournal(jdir)
    j.append_put("k", b"payload")  # acknowledged; COMMIT lost to crash
    j.close()
    cold = _CountingCold()
    cold.put("k", b"payload")  # ...but the flush itself landed
    cold.put_counts.clear()

    t = _tier(cold, jdir)
    assert t.get("k") == b"payload"
    assert t.dirty_keys() == []  # settled at replay, not re-queued
    t.flush()
    assert cold.put_counts.get("k", 0) == 0  # never re-uploaded
    t.close()
    # the settle wrote a COMMIT, so the next replay finds nothing
    t2 = _tier(cold, jdir)
    assert t2.dirty_keys() == []
    t2.close()


def test_replay_requeues_when_cold_copy_is_stale(tmp_path):
    """Same window, but the cold copy predates the acknowledged value
    (the crash hit before the NEWER flush landed): replay must keep
    the key dirty and the newer bytes must win."""
    jdir = str(tmp_path / "journal")
    j = WriteBackJournal(jdir)
    j.append_put("k", b"v2-newer")
    j.close()
    cold = _CountingCold()
    cold.put("k", b"v1-stale")
    cold.put_counts.clear()

    t = _tier(cold, jdir)
    assert t.get("k") == b"v2-newer"
    t.flush()
    assert cold.get("k") == b"v2-newer"  # the upload DID happen
    assert cold.put_counts.get("k") == 1  # ...exactly once
    t.close()


# ---------------------------------------------------------------------------
# property-style interleaving: put / flush / outage / crash scripts
# ---------------------------------------------------------------------------

def _drive(script):
    """Run a put/flush/down/up/crash script against a journaled
    write-back tier and check the gate invariant: after the dust
    settles, the cold tier holds the LAST acknowledged value of every
    key that was ever acknowledged (and never deleted)."""
    import tempfile

    cold = _CountingCold()
    acked = {}
    seq = 0
    with tempfile.TemporaryDirectory() as jdir:
        t = _tier(cold, jdir, hot_bytes=1 << 16)
        try:
            for op, arg in script:
                if op == "put":
                    k = f"k{arg}"
                    seq += 1
                    v = f"{k}@{seq}".encode() * 4
                    t.put(k, v)
                    acked[k] = v
                elif op == "delete":
                    k = f"k{arg}"
                    t.delete(k)
                    acked.pop(k, None)
                elif op == "flush":
                    t.flush()
                elif op == "crash":
                    _crash(t)
                    t = _tier(cold, jdir, hot_bytes=1 << 16)
                    for k, v in acked.items():
                        assert t.get(k) == v, f"{k!r} lost at crash"
            _crash(t)
            t = _tier(cold, jdir, hot_bytes=1 << 16)
            t.flush()
        finally:
            t.close()
    for k, v in acked.items():
        assert cold.get(k) == v, f"{k!r} not durable at the end"


_OPS = ("put", "put", "put", "flush", "crash", "delete")


try:  # property-based when the wheel is present, seeded sweep otherwise
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=15, deadline=None)
    @given(st.lists(
        st.tuples(st.sampled_from(_OPS), st.integers(0, 3)),
        max_size=14,
    ))
    def test_journal_interleavings_never_lose_acknowledged_writes(script):
        _drive(script)

except ImportError:  # deterministic sweep fallback (same invariant)
    def test_journal_interleavings_never_lose_acknowledged_writes():
        for seed in range(8):
            rng = random.Random(seed)
            script = [
                (rng.choice(_OPS), rng.randrange(4))
                for _ in range(rng.randrange(1, 14))
            ]
            _drive(script)


# ---------------------------------------------------------------------------
# the port against the reference: one segment format, replayable both ways
# ---------------------------------------------------------------------------

def _segments(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _journal_script(S, d):
    """A seeded run of appends small enough to rotate segments, with
    commits that let the watermark reclaim some of them."""
    rng = random.Random(11)
    j = S.WriteBackJournal(d, segment_bytes=4096)
    keys = [f"v/{i}/0.tvc" for i in range(6)]
    for _ in range(80):
        op = rng.choice(("put", "put", "puts", "commit", "delete"))
        if op == "put":
            j.append_put(rng.choice(keys), rng.randbytes(rng.randrange(400)))
        elif op == "puts":
            j.append_puts([(k, rng.randbytes(rng.randrange(300)))
                           for k in rng.sample(keys, 3)])
        elif op == "commit":
            j.append_commit(rng.sample(keys, 2))
        else:
            j.append_delete(rng.choice(keys))
    files = _segments(d)  # before close: close reclaims drained segments
    pending = j.pending_keys()
    j.close()
    return files, pending


def _down_cold(S, cold_root):
    """A LocalFS cold tier of package ``S`` that refuses every upload
    while ``down``."""

    class Switch(S.LocalFSBackend):
        down = True

        def put(self, key, data):
            if self.down:
                raise IOError("cold tier unreachable")
            super().put(key, data)

    return Switch(cold_root)


def _outage_tier(S, cold_root, jdir):
    """A write-back tier whose cold tier refuses every upload: nothing
    is committed, so the journal holds every acknowledged write."""
    return S.TieredBackend(_down_cold(S, cold_root), write_back=True,
                           journal_dir=jdir, hot_bytes=1 << 20)


def _acked_puts(tier):
    rng = random.Random(5)
    acked = {}
    for i in range(24):
        k = f"v/{rng.randrange(8)}/{i % 3}.tvc"
        if i % 7 == 6:
            tier.delete(k)
            acked.pop(k, None)
            continue
        v = rng.randbytes(rng.randrange(1, 700))
        if i % 5 == 4:
            tier.batch_put([(k, v), (k + ".b", v[::-1])])
            acked[k + ".b"] = v[::-1]
        else:
            tier.put(k, v)
        acked[k] = v
    return acked


@pytest.mark.parametrize("via", ["journal", "tiered"])
def test_segments_identical_to_reference(tmp_path, via):
    """The same appends give the same segment files, byte for byte:
    names, magic, record headers, crc32s and payloads."""
    got = []
    for S, name in ((jstorage, "j"), (tstorage, "t")):
        d = str(tmp_path / name)
        if via == "journal":
            files, pending = _journal_script(S, d)
        else:
            tier = _outage_tier(S, str(tmp_path / f"{name}-cold"), d)
            _acked_puts(tier)
            _crash(tier)
            files, pending = _segments(d), sorted(tier.dirty_keys())
        assert files and all(b.startswith(MAGIC) for b in files.values())
        got.append((files, pending))
    assert got[1] == got[0]


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_crashed_journal_replays_in_other_package(tmp_path, writer, reader):
    """A write-back tier of one package dies with no close while its
    cold tier is down; a tier of the other package on the same journal
    serves every acknowledged write at once, and lands them all on the
    cold tier when it flushes."""
    W = {"reference": jstorage, "port": tstorage}[writer]
    R = {"reference": jstorage, "port": tstorage}[reader]
    jdir, cold_root = str(tmp_path / "journal"), str(tmp_path / "cold")
    t1 = _outage_tier(W, cold_root, jdir)
    acked = _acked_puts(t1)
    _crash(t1)

    # the cold tier stays down until the replayed state is checked: a
    # live flusher would otherwise settle keys while they are counted
    cold = _down_cold(R, cold_root)
    t2 = R.TieredBackend(cold, write_back=True, journal_dir=jdir,
                         hot_bytes=1 << 20)
    assert sorted(t2.dirty_keys()) == sorted(acked)
    for k, v in acked.items():
        assert t2.get(k) == v
    cold.down = False
    t2.retry_failed()
    t2.flush()
    t2.close()
    assert sorted(cold.list()) == sorted(acked)
    for k, v in acked.items():
        assert cold.get(k) == v
    # drained: a tier of the writer's package finds nothing to replay
    t3 = W.TieredBackend(W.LocalFSBackend(cold_root), write_back=True,
                         journal_dir=jdir)
    assert t3.dirty_keys() == []
    t3.close()
