"""`repro_torch.storage`: backend conformance, sharding, tiering, recovery."""
import dataclasses
import os
import random
import ssl
import subprocess
import threading

import numpy as np
import pytest
import torch

from repro_torch.storage import (
    FaultInjectingBackend,
    LocalFSBackend,
    MemoryBackend,
    ObjectNotFound,
    ObjectServer,
    RangeNotSatisfiable,
    RemoteBackend,
    ReplicatedBackend,
    ShardedBackend,
    TieredBackend,
    make_backend,
    unwrap,
)
from repro import storage as jstorage
from repro_torch import storage as tstorage
from repro_torch.storage.localfs import TEMP_MARKER
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
def vss(tmp_path):
    """The port's counterpart of conftest's reference store."""
    store = VSS(str(tmp_path / "vss"))
    yield store
    store.close()

# every backend configuration runs the identical conformance suite —
# including the remote client against a live loopback object server
# (plain, and TLS + signed-request auth), and a (quiet) fault wrapper
# proving the chaos shim preserves the contract
BACKEND_SPECS = ("memory", "local", "local:fsync", "sharded2", "sharded4",
                 "tiered", "replicated3", "replicated4r3", "remote",
                 "remotes", "tiered_remote", "fault_wrapped")

_TLS_SECRET = b"conformance-suite-secret"


def mint_tls_cert(dirpath):
    """Self-signed localhost cert via the openssl CLI (no extra deps)."""
    os.makedirs(dirpath, exist_ok=True)
    cert = os.path.join(dirpath, "cert.pem")
    key = os.path.join(dirpath, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True,
    )
    return cert, key


def _make(spec, root, S=tstorage):
    """One conformance row over the storage package ``S``: the port's by
    default, the reference's for the differential cases."""
    if spec == "memory":
        return S.MemoryBackend()
    if spec == "local":
        return S.LocalFSBackend(root)
    if spec == "local:fsync":
        return S.LocalFSBackend(root, fsync=True)
    if spec == "sharded2":
        return S.ShardedBackend.local(root, 2)
    if spec == "sharded4":
        return S.ShardedBackend.local(root, 4)
    if spec == "tiered":
        return S.TieredBackend(S.LocalFSBackend(root), hot_bytes=1 << 20)
    if spec == "replicated3":
        return S.ReplicatedBackend.local(root, 3)
    if spec == "replicated4r3":
        return S.ReplicatedBackend.local(root, 4, replicas=3, write_quorum=2)
    if spec == "remote":
        return S.RemoteBackend.self_hosted(root, backoff_base=0.01)
    if spec == "remotes":
        # the untrusted-network composition: TLS on the wire + HMAC
        # signed requests, through the `remotes:<url>` spec grammar
        cert, key = mint_tls_cert(root + "-tls")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        server = S.ObjectServer(S.LocalFSBackend(root), secret=_TLS_SECRET,
                                ssl_context=ctx)
        b = S.make_backend(f"remotes:{server.url.split('://', 1)[1]}", root,
                           secret=_TLS_SECRET, ca_file=cert)
        S.unwrap(b, S.RemoteBackend)._server = server  # close() owns it
        return b
    if spec == "tiered_remote":
        return S.make_backend("tiered:remote", root)
    if spec == "fault_wrapped":
        return S.FaultInjectingBackend(S.MemoryBackend(), seed=0)
    raise AssertionError(spec)


@pytest.fixture(params=BACKEND_SPECS)
def backend(request, tmp_path):
    b = _make(request.param, str(tmp_path / "objects"))
    yield b
    b.close()


# ---------------------------------------------------------------------------
# conformance suite — every backend, same contract (one class, fixture-
# driven; chaos tests in test_faults.py build on the same guarantees)
# ---------------------------------------------------------------------------

class TestBackendConformance:
    def test_put_get_roundtrip(self, backend):
        backend.put("v/1/0.tvc", b"alpha")
        assert backend.get("v/1/0.tvc") == b"alpha"
        backend.put("v/1/0.tvc", b"beta")  # overwrite
        assert backend.get("v/1/0.tvc") == b"beta"

    def test_missing_key_raises(self, backend):
        with pytest.raises(ObjectNotFound):
            backend.get("nope")
        with pytest.raises(ObjectNotFound):
            backend.stat("nope")

    def test_delete_idempotent(self, backend):
        backend.put("k", b"x")
        backend.delete("k")
        backend.delete("k")  # second delete is a no-op
        assert not backend.exists("k")
        backend.delete("never-existed")  # deleting the unknown too

    def test_stat_sizes(self, backend):
        backend.put("a", b"12345")
        assert backend.stat("a").nbytes == 5

    def test_stat_list_consistency(self, backend):
        """list() names exactly the live keys and stat() agrees with
        the stored payload after interleaved puts and deletes."""
        sizes = {f"v/{i}": i + 1 for i in range(8)}
        for k, n in sizes.items():
            backend.put(k, b"z" * n)
        backend.delete("v/3")
        del sizes["v/3"]
        assert sorted(backend.list("v/")) == sorted(sizes)
        for k, n in sizes.items():
            assert backend.stat(k).nbytes == n
            assert len(backend.get(k)) == n

    def test_batch_get_preserves_order(self, backend):
        keys = [f"v/1/{i}.tvc" for i in range(20)]
        for i, k in enumerate(keys):
            backend.put(k, f"payload-{i}".encode())
        got = backend.batch_get(list(reversed(keys)))
        assert got == [f"payload-{i}".encode() for i in reversed(range(20))]

    def test_batch_get_dedupes_repeated_keys(self, backend):
        """A key appearing N times in one batch answers N times, in
        position — the §3 planner dedupes fetches above this seam, so
        repeats must at minimum stay correct below it."""
        backend.put("a", b"A")
        backend.put("b", b"B")
        assert backend.batch_get(["a", "b", "a", "a", "b"]) == [
            b"A", b"B", b"A", b"A", b"B",
        ]

    def test_batch_get_missing_raises(self, backend):
        backend.put("a", b"x")
        with pytest.raises(ObjectNotFound):
            backend.batch_get(["a", "missing"])

    def test_batch_put_roundtrip(self, backend):
        items = [(f"v/1/{i}.tvc", f"payload-{i}".encode())
                 for i in range(20)]
        backend.batch_put(items)
        assert backend.batch_get([k for k, _ in items]) \
            == [d for _, d in items]
        backend.batch_put([("v/1/0.tvc", b"overwritten")])  # overwrite ok
        assert backend.get("v/1/0.tvc") == b"overwritten"

    def test_batch_put_empty_noop(self, backend):
        backend.batch_put([])
        assert backend.list() == []

    def test_list_prefix(self, backend):
        backend.put("v/1/0.tvc", b"x")
        backend.put("v/2/0.tvc", b"y")
        backend.put("w/1/0.tvc", b"z")
        assert sorted(backend.list("v/")) == ["v/1/0.tvc", "v/2/0.tvc"]
        assert sorted(backend.list()) \
            == ["v/1/0.tvc", "v/2/0.tvc", "w/1/0.tvc"]

    def test_atomic_put_visibility(self, backend):
        """Overwrite atomicity under concurrency: a reader hammering a
        key while a writer overwrites it sees only complete values —
        never a torn mix, never a disappearing key."""
        old, new = b"o" * 4096, b"n" * 8192
        backend.put("k", old)
        stop = threading.Event()
        bad = []

        def reader():
            while not stop.is_set():
                try:
                    v = backend.get("k")
                except Exception as exc:  # pragma: no cover - fail below
                    bad.append(repr(exc))
                    return
                if v != old and v != new:
                    bad.append(f"torn read of {len(v)} bytes")
                    return

        t = threading.Thread(target=reader)
        t.start()
        try:
            for i in range(20):
                backend.put("k", new if i % 2 == 0 else old)
        finally:
            stop.set()
            t.join(timeout=30.0)
        assert not bad, bad

    def test_kind_for_names_a_priced_tier(self, backend):
        from repro_torch.core.cost import DEFAULT_IO_TABLE

        backend.put("k", b"x")
        assert backend.kind_for("k") in DEFAULT_IO_TABLE

    def test_get_range_slices(self, backend):
        data = bytes(range(256)) * 5
        backend.put("r", data)
        assert backend.get_range("r", 0, 10) == data[:10]
        assert backend.get_range("r", 100, 50) == data[100:150]
        assert backend.get_range("r", len(data) - 1, 1) == data[-1:]
        # a range past the end truncates to the tail (HTTP 206 semantics)
        assert backend.get_range("r", 1000, 10**6) == data[1000:]

    def test_get_range_rejects_bad_args(self, backend):
        backend.put("r", b"0123456789")
        for start, length in ((-1, 5), (0, 0), (0, -3)):
            with pytest.raises(ValueError):
                backend.get_range("r", start, length)
        # start at/past the end is the storage twin of HTTP 416 — every
        # backend raises the typed subclass (still a ValueError)
        with pytest.raises(RangeNotSatisfiable):
            backend.get_range("r", 10, 1)  # start at end: unsatisfiable
        with pytest.raises(RangeNotSatisfiable):
            backend.get_range("r", 99, 1)  # start past end
        with pytest.raises(RangeNotSatisfiable):
            backend.batch_get_ranges([("r", 25, 4)])

    def test_get_range_missing_key(self, backend):
        with pytest.raises(ObjectNotFound):
            backend.get_range("nope", 0, 1)

    def test_batch_get_ranges_preserves_order(self, backend):
        backend.put("a", b"abcdefgh")
        backend.put("b", b"01234567")
        got = backend.batch_get_ranges(
            [("b", 2, 3), ("a", 0, 4), ("b", 6, 99), ("a", 4, 1)]
        )
        assert got == [b"234", b"abcd", b"67", b"e"]


# ---------------------------------------------------------------------------
# backend-specific behaviour
# ---------------------------------------------------------------------------

def test_localfs_rejects_escaping_keys(tmp_path):
    b = LocalFSBackend(str(tmp_path))
    for bad in ("/abs", "../escape", "a/../../b"):
        with pytest.raises(ValueError):
            b.put(bad, b"x")


def test_localfs_atomic_leaves_no_temps(tmp_path):
    b = LocalFSBackend(str(tmp_path), fsync=True)
    for i in range(10):
        b.put(f"v/{i}.tvc", os.urandom(1000))
    for dirpath, _dirs, files in os.walk(str(tmp_path)):
        assert not [f for f in files if TEMP_MARKER in f]


def test_sharded_distribution_and_stability(tmp_path):
    b = ShardedBackend.local(str(tmp_path), 4)
    keys = [f"v/{i}/{j}.tvc" for i in range(20) for j in range(10)]
    for k in keys:
        b.put(k, k.encode())
    per_vol = [len(v.list()) for v in b.volumes]
    assert sum(per_vol) == len(keys)
    assert all(n > 0 for n in per_vol)  # every volume takes a share
    # placement is stable and routed: the owning volume holds the key
    for k in keys[:10]:
        assert b.volumes[b.volume_for(k)].exists(k)
    b.close()


def test_sharded_batch_get_fans_out(tmp_path):
    b = ShardedBackend.local(str(tmp_path), 4)
    keys = [f"k{i}" for i in range(50)]
    for i, k in enumerate(keys):
        b.put(k, bytes([i]))
    assert b.batch_get(keys) == [bytes([i]) for i in range(50)]
    b.close()


def test_sharded_batch_put_places_like_put(tmp_path):
    b = ShardedBackend.local(str(tmp_path), 4)
    items = [(f"v/{i}/0.tvc", f"data-{i}".encode()) for i in range(40)]
    b.batch_put(items)
    for k, d in items:
        # fan-out must respect the hash ring: the owning volume holds it
        assert b.volumes[b.volume_for(k)].get(k) == d
    assert all(len(v.list()) > 0 for v in b.volumes)
    b.close()


def test_tiered_batch_put_write_through(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=1 << 20)
    b.batch_put([("a", b"1"), ("b", b"2")])
    assert cold.get("a") == b"1" and cold.get("b") == b"2"  # durable copies
    assert set(b.hot_keys()) == {"a", "b"}  # and hot-admitted


def test_tiered_write_through_and_spill(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=2500)
    for i in range(10):
        b.put(f"k{i}", bytes(1000))
    assert b.hot_total_bytes <= 2500  # spill kept the hot tier bounded
    for i in range(10):
        assert cold.exists(f"k{i}")  # write-through: cold has everything
        assert b.get(f"k{i}") == bytes(1000)  # spilled keys still readable


def test_tiered_spill_follows_priority(tmp_path):
    b = TieredBackend(LocalFSBackend(str(tmp_path)), hot_bytes=2500)
    # LRU_VSS semantics: lower sequence number spills first
    prio = {"keep-a": 100.0, "keep-b": 90.0, "drop-a": 1.0, "drop-b": 2.0}
    b.set_priority_fn(lambda keys: {k: prio.get(k, 50.0) for k in keys})
    for k in prio:
        b.put(k, bytes(1000))
    hot = set(b.hot_keys())
    assert "keep-a" in hot and "keep-b" in hot
    assert "drop-a" not in hot


def test_tiered_get_promotes(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    cold.put("x", b"cold-data")
    b = TieredBackend(cold, hot_bytes=1 << 20)
    assert b.get("x") == b"cold-data"
    assert "x" in b.hot_keys()


# ---------------------------------------------------------------------------
# write-back tiering (the tiered:remote composition; remote-specific
# behaviour lives in test_remote.py, chaos in test_faults.py)
# ---------------------------------------------------------------------------

def test_writeback_put_is_deferred_then_flushed(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.put("a", b"dirty-bytes")
    assert b.get("a") == b"dirty-bytes"     # visible immediately
    assert b.stat("a").nbytes == 11
    assert "a" in b.list()                  # dirty keys listed
    b.flush()                               # durability barrier
    assert b.dirty_keys() == []
    assert cold.get("a") == b"dirty-bytes"  # cold copy landed
    b.close()


def test_writeback_spill_flushes_dirty_before_drop(tmp_path):
    """Eviction must never lose the only copy of an unuploaded object:
    a dirty victim is uploaded synchronously, then dropped."""
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=2500, write_back=True)
    for i in range(10):  # 10 KiB through a 2.5 KiB tier
        b.put(f"k{i}", bytes([i]) * 1000)
    assert b.hot_total_bytes <= 2500
    b.flush()
    for i in range(10):  # every object durable and readable
        assert b.get(f"k{i}") == bytes([i]) * 1000
        assert cold.get(f"k{i}") == bytes([i]) * 1000
    b.close()


def test_writeback_overwrite_while_flushing_keeps_last_write(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    for round_ in range(5):
        b.put("k", f"gen-{round_}".encode())
    b.flush()
    assert cold.get("k") == b"gen-4"
    b.close()


def test_writeback_delete_beats_trailing_flush(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.put("k", b"x" * 100)
    b.delete("k")  # may race the background upload; delete must win
    b.flush()
    assert not b.exists("k")
    assert not cold.exists("k")
    b.close()


def test_writeback_close_is_a_durability_barrier(tmp_path):
    cold = LocalFSBackend(str(tmp_path))
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.batch_put([(f"k{i}", bytes(100)) for i in range(8)])
    b.close()  # implies flush()
    assert all(cold.exists(f"k{i}") for i in range(8))


def test_oversized_overwrite_invalidates_stale_hot_copy(tmp_path):
    """An object that outgrew the hot tier bypasses admission — but a
    smaller hot copy from an earlier write must not keep serving."""
    cold = LocalFSBackend(str(tmp_path))
    for wb in (False, True):
        b = TieredBackend(cold, hot_bytes=100, write_back=wb)
        b.put("k", b"small")
        b.put("k", b"X" * 200)  # > hot_bytes: cold-only
        assert b.get("k") == b"X" * 200
        assert b.stat("k").nbytes == 200
        b.batch_put([("k", b"Y" * 300)])
        assert b.get("k") == b"Y" * 300
        b.close()


def test_writeback_ingest_window_lands_cold_before_indexing(tmp_path):
    """The ingest durability contract survives the write-back cache:
    after VSSWriter.close(), every indexed GOP object is already on
    the cold tier — a crash that wipes the hot tier loses nothing that
    was acknowledged."""
    from repro_torch.data.video import synthesize_road

    clip = synthesize_road(30, width=96, height=64, seed=4)
    root = str(tmp_path / "vss")
    vss = VSS(root, backend="tiered:remote")
    w = vss.writer("cam", fps=30.0, codec="tvc-ll", gop_frames=10)
    w.append(clip)
    w.close()  # durability barrier: durable AND indexed
    cold = vss.backend.cold
    gops = [g for g in vss.catalog.all_gops() if g.joint_ref is None]
    assert gops
    # deterministically on the cold tier NOW — not whenever the
    # background flusher gets to it
    assert all(cold.exists(g.path) for g in gops)
    # crash that loses the entire hot tier: reads still serve via cold
    vss.backend._drop_hot()
    out = vss.read("cam", cache=False).frames
    assert np.array_equal(out, clip)
    vss.close()


def test_writeback_spill_flush_failure_is_transient_not_terminal(
        tmp_path):
    """One cold-tier hiccup during an eviction-forced flush must not
    terminally pin the key: the attempt counts against the same
    retry budget the background flusher uses, and the key flushes
    once the cold tier recovers."""
    class Hiccup(MemoryBackend):
        def __init__(self):
            super().__init__()
            self.fail_puts = 0

        def put(self, key, data):
            if self.fail_puts > 0:
                self.fail_puts -= 1
                raise IOError("transient cold-tier hiccup")
            super().put(key, data)

    cold = Hiccup()
    b = TieredBackend(cold, hot_bytes=2500, write_back=True)
    b.put("k0", bytes(1000))
    b.flush()
    cold.fail_puts = 1  # exactly one failure, then healthy
    for i in range(1, 6):  # force spills through the failure window
        b.put(f"k{i}", bytes(1000))
    b.flush()  # must succeed: one hiccup < FLUSH_MAX_ATTEMPTS
    for i in range(6):
        assert cold.get(f"k{i}") == bytes(1000)
    b.close()


class _DownCold(MemoryBackend):
    """A cold tier that refuses writes until ``down`` clears."""

    def __init__(self):
        super().__init__()
        self.down = True

    def put(self, key, data):
        if self.down:
            raise IOError("cold tier unreachable")
        super().put(key, data)


def test_writeback_flush_failure_pins_object_hot(tmp_path):
    cold = _DownCold()
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.put("k", b"precious")
    with pytest.raises(RuntimeError, match="write-back flush failed"):
        b.flush()
    assert b.get("k") == b"precious"  # never dropped
    cold.down = False
    b.put("k", b"precious")  # fresh write clears the failure state
    b.flush()
    assert cold.get("k") == b"precious"
    b.close()


def test_writeback_hot_hit_range_past_end_is_typed(tmp_path):
    """A ranged read answered from the write-back hot tier must raise
    the same typed `RangeNotSatisfiable` the cold backends map to HTTP
    416 — not a bare ValueError the serving layer can't route."""
    b = TieredBackend(MemoryBackend(), hot_bytes=1 << 20, write_back=True)
    b.put("k", b"0123456789")  # acknowledged: dirty, served hot
    with pytest.raises(RangeNotSatisfiable) as ei:
        b.get_range("k", 10, 1)
    assert (ei.value.key, ei.value.start, ei.value.size) == ("k", 10, 10)
    with pytest.raises(RangeNotSatisfiable):
        b.batch_get_ranges([("k", 0, 2), ("k", 99, 1)])
    b.close()


def test_demote_surfaces_pinned_keys_during_cold_outage(tmp_path):
    """demote() during a cold-tier outage must not silently swallow the
    flush failure: pinned keys stay hot (no data loss), are counted on
    vss_cache_demote_pinned_total, and show up in stats() until the
    cold tier recovers."""
    cold = _DownCold()
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.put("k1", b"a" * 64)
    b.put("k2", b"b" * 64)
    before = b._c_demote_pinned.value
    assert b.demote(["k1", "k2"]) == 0  # nothing dropped, nothing lost
    assert b._c_demote_pinned.value == before + 2
    st = b.stats()
    assert st["demote_skipped_pinned"] == ["k1", "k2"]
    assert st["pinned_keys"] == ["k1", "k2"]
    assert b.get("k1") == b"a" * 64  # the acknowledged values survive
    # recovery: un-pin, flush, and the demote now lands cleanly
    cold.down = False
    assert b.retry_failed() == 2
    b.flush()
    assert b.stats()["demote_skipped_pinned"] == []
    assert b.demote(["k1", "k2"]) == 2
    assert cold.get("k1") == b"a" * 64
    assert cold.get("k2") == b"b" * 64
    b.close()


def test_writeback_oversized_overwrite_never_loses_acknowledged_value(
        tmp_path):
    """Degrading an oversized overwrite to write-through must not
    destroy the previously acknowledged dirty value until the cold put
    has succeeded — and on failure the old value stays readable AND
    durable-trackable."""
    cold = _DownCold()
    cold.down = False
    b = TieredBackend(cold, hot_bytes=100, write_back=True)
    b.put("k", b"small")          # acknowledged; may still be hot-only
    cold.down = True
    with pytest.raises(IOError):
        b.put("k", b"X" * 200)    # oversize: must write through; fails
    assert b.get("k") == b"small"  # the acknowledged value survives
    cold.down = False
    b.flush()                      # ...and still reaches durability
    assert cold.get("k") == b"small"
    b.put("k", b"X" * 200)         # healthy: the overwrite lands
    assert b.get("k") == b"X" * 200
    assert cold.get("k") == b"X" * 200
    b.flush()
    b.close()


def test_writeback_flush_scope_covers_only_named_keys(tmp_path):
    """flush(keys=...) — the per-ingest-window barrier — lands exactly
    the named keys without waiting on the rest of the dirty set."""
    cold = MemoryBackend()
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.batch_put([(f"w/{i}", bytes([i]) * 100) for i in range(6)])
    window = [f"w/{i}" for i in range(3)]
    b.flush(window)
    assert all(cold.get(k) == bytes([int(k[2:])]) * 100 for k in window)
    b.flush()  # global barrier still lands everything else
    assert sorted(cold.list()) == sorted(f"w/{i}" for i in range(6))
    b.close()


def test_writeback_outage_backpressures_instead_of_growing(tmp_path):
    """Cold tier down + tier over budget with pinned objects: put must
    fail (honest backpressure), not absorb dirty bytes at memory speed
    until the process OOMs."""
    cold = _DownCold()
    b = TieredBackend(cold, hot_bytes=2500, write_back=True)
    with pytest.raises(RuntimeError, match="over budget .* pinned"):
        for i in range(50):  # outage: eventually the tier must refuse
            b.put(f"k{i}", bytes(1000))
    assert b.hot_total_bytes < 50 * 1000  # growth stopped early
    # recovery: un-pin, flush, and the accepted objects all land
    cold.down = False
    assert b.retry_failed() > 0
    b.flush()
    for k in b.list():
        assert cold.get(k) == bytes(1000)
    b.close()


def test_writeback_close_retries_after_cold_tier_recovers(tmp_path):
    """Objects pinned during an outage get one more chance at close():
    the cold tier recovered, so close lands them instead of raising."""
    cold = _DownCold()
    b = TieredBackend(cold, hot_bytes=1 << 20, write_back=True)
    b.put("k", b"precious")
    with pytest.raises(RuntimeError):
        b.flush()  # pinned while down
    cold.down = False
    b.close()  # retry_failed + flush: durable after all
    assert cold.get("k") == b"precious"


def test_make_backend_specs(tmp_path):
    # make_backend wraps every composition level with telemetry, so
    # isinstance dispatch goes through unwrap(); plain attribute access
    # (.fsync, .cold, .write_back) delegates transparently
    root = str(tmp_path / "o")
    assert unwrap(make_backend("memory", root), MemoryBackend) is not None
    assert unwrap(make_backend("local", root), LocalFSBackend) is not None
    assert make_backend("local:fsync", root).fsync
    sh = make_backend("sharded:3", root)
    assert unwrap(sh, ShardedBackend) is not None and len(sh.volumes) == 3
    t = make_backend("tiered:sharded:2", root)
    assert unwrap(t, TieredBackend) is not None and not t.write_back
    assert unwrap(t.cold, ShardedBackend) is not None
    assert len(t.cold.volumes) == 2
    r = make_backend("remote", root + "r")
    assert unwrap(r, RemoteBackend) is not None
    r.close()
    tr = make_backend("tiered:remote", root + "tr")
    assert unwrap(tr, TieredBackend) is not None and tr.write_back
    assert unwrap(tr.cold, RemoteBackend) is not None
    tr.close()
    with pytest.raises(ValueError):
        make_backend("s3", root)
    with pytest.raises(ValueError):
        make_backend("remote:ftp://bad", root)
    # uninstrumented build keeps the bare types
    assert isinstance(
        make_backend("memory", root, instrument=False), MemoryBackend
    )


# ---------------------------------------------------------------------------
# VSS integration: every backend serves the full read/write pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_clip():
    from repro_torch.data.video import synthesize_road

    return synthesize_road(30, width=128, height=96, seed=3)


@pytest.mark.parametrize("spec", BACKEND_SPECS)
def test_vss_pipeline_on_every_backend(spec, tmp_path, short_clip):

    vss = VSS(str(tmp_path / "vss"),
              backend=_make(spec, str(tmp_path / "vss" / "objects")))
    vss.write("v", short_clip, fps=30.0, codec="tvc-hi", gop_frames=10)
    out = vss.read("v", codec="rgb").frames  # cached read → admission path
    assert out.shape == short_clip.shape
    r = vss.read("v", t=(0.2, 0.8), codec="hevc", cache=False)
    assert r.frames.shape[0] == 18
    vss.close()


@pytest.mark.parametrize("spec", BACKEND_SPECS)
def test_vss_tiled_pipeline_on_every_backend(spec, tmp_path, short_clip):
    """The tiled physical layout (rows x cols tile objects per GOP)
    must behave identically to the plain layout on every backend: full
    reads and ROI reads stitch the tiles back bit-exactly."""
    from repro_torch.core.spec import WriteSpec

    vss = VSS(str(tmp_path / "vss"),
              backend=_make(spec, str(tmp_path / "vss" / "objects")))
    w = vss.writer_spec(WriteSpec(name="v", fps=30.0, codec="tvc-hi",
                                  gop_frames=10, tiles=(2, 2)))
    w.append(short_clip)
    w.close()
    full = vss.read("v", codec="rgb", cache=False).frames
    assert full.shape == short_clip.shape
    roi = (40, 24, 88, 72)
    r = vss.read("v", roi=roi, codec="rgb", cache=False).frames
    assert np.array_equal(r, full[:, 24:72, 40:88])
    vss.close()


def test_vss_env_backend_selection(tmp_path, short_clip, monkeypatch):
    from repro_torch.storage import ENV_VAR

    monkeypatch.setenv(ENV_VAR, "sharded:2")
    vss = VSS(str(tmp_path / "vss"))
    assert unwrap(vss.backend, ShardedBackend) is not None
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    assert np.asarray(vss.read("v", codec="rgb", cache=False).frames).shape \
        == short_clip.shape
    vss.close()


def test_no_raw_open_on_payload_paths():
    """Acceptance guard: GOP payload I/O must live in repro_torch.storage."""
    import pathlib

    core = pathlib.Path(__file__).parent.parent / "src" / "repro" / "core"
    offenders = []
    for f in core.glob("*.py"):
        src = f.read_text()
        if "open(" in src.replace("logical_exists(", "").replace(
                "os.open(", ""):
            for i, line in enumerate(src.splitlines(), 1):
                if "open(" in line and "os.open" not in line \
                        and "logical_exists" not in line \
                        and not line.strip().startswith("#"):
                    offenders.append(f"{f.name}:{i}: {line.strip()}")
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------

def _fs_path_for(root, key):
    return os.path.join(root, "objects", *key.split("/"))


def test_crash_recovery_scavenges_and_preserves_committed(tmp_path,
                                                          short_clip):

    root = str(tmp_path / "vss")
    # pinned to the local layout: the test tears objects behind the
    # store's back at known filesystem paths
    vss = VSS(root, backend="local")
    vss.write("v", short_clip, fps=30.0, codec="tvc-hi", gop_frames=10)
    vss.read("v", t=(0.0, 0.6), codec="tvc-med")  # cache a derived view
    view_gops = [
        g for p in vss.catalog.physicals_for("v") if not p.is_original
        for g in vss.catalog.gops_for(p.physical_id)
    ]
    assert view_gops
    victim = view_gops[0]
    n_gops_before = len(vss.catalog.all_gops())
    vss.catalog.close()  # crash: no clean-shutdown marker is written

    # simulate a crash's aftermath behind the store's back:
    vpath = _fs_path_for(root, victim.path)
    with open(vpath, "r+b") as f:  # torn object under a live key
        f.truncate(max(os.path.getsize(vpath) // 2, 8))
    orphan = _fs_path_for(root, "v/9/0.tvc")  # object with no catalog row
    os.makedirs(os.path.dirname(orphan), exist_ok=True)
    with open(orphan, "wb") as f:
        f.write(b"orphan")
    with open(orphan + TEMP_MARKER + "999-0", "wb") as f:
        f.write(b"partial")  # in-flight temp artifact

    vss2 = VSS(root, backend="local")  # startup scavenger runs here
    rep = vss2.recovery
    assert rep.temps_removed == 1
    assert rep.orphans_removed == 1
    assert rep.gops_dropped == 1
    assert not os.path.exists(orphan)
    # the torn object is gone from catalog and disk
    assert len(vss2.catalog.all_gops()) == n_gops_before - 1
    assert not os.path.exists(vpath)
    # committed GOPs survive: the full original still reads back exactly
    out = vss2.read("v", codec="rgb", cache=False).frames
    from repro_torch.core.quality import exact_psnr

    assert out.shape == short_clip.shape
    assert exact_psnr(out, short_clip) >= 48.0  # tvc-hi quality intact
    vss2.close()


def test_recovery_repairs_stale_deferred_size(tmp_path, short_clip):
    """Crash between the deferred compressor's put and its catalog size
    update: object is valid (wrapped, smaller) but nbytes is stale —
    the scavenger repairs the row instead of dropping it."""
    from repro_torch.core.deferred import wrap_bytes

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="local")  # persistence-dependent reopen below
    vss.write("v", short_clip, fps=30.0, codec="rgb", gop_frames=10)
    g = vss.catalog.gops_for(vss.catalog.get_original_id("v"))[0]
    raw = vss.backend.get(g.path)
    vss.backend.put(g.path, wrap_bytes(raw, 3))  # ...crash before update
    vss.catalog.close()  # crash: no clean-shutdown marker is written

    vss2 = VSS(root, backend="local")
    assert vss2.recovery.gops_repaired == 1
    assert vss2.recovery.gops_dropped == 0
    g2 = vss2.catalog.get_gop(g.gop_id)
    assert g2.zwrapped and g2.nbytes < len(raw)
    out = vss2.read("v", codec="rgb", cache=False).frames
    assert np.array_equal(out, short_clip)  # rgb+lossless wrap: bit-exact
    vss2.close()


def test_recovery_clean_on_healthy_store(tmp_path, short_clip):

    root = str(tmp_path / "vss")
    vss = VSS(root)
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.close()
    vss2 = VSS(root)  # clean shutdown: the O(objects) sweep is skipped
    assert vss2.recovery.clean
    vss2.close()


def test_crash_reopen_without_close_runs_scavenger(tmp_path, short_clip):

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="local")  # persistence-dependent reopen below
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.backend.put("v/orphan.tvc", b"debris")  # no catalog row
    vss.catalog.close()  # crash
    vss2 = VSS(root, backend="local")
    assert vss2.recovery.orphans_removed == 1
    vss2.close()


def test_layout_mismatch_refuses_to_open(tmp_path, short_clip):
    """A mismatched backend must fail loudly, not scavenge-wipe the
    catalog of a healthy store."""

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="local")  # pinned: the mismatches are the point
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.close()
    with pytest.raises(ValueError, match="storage layout"):
        VSS(root, backend="sharded:2")
    with pytest.raises(ValueError, match="storage layout"):
        VSS(root, backend=MemoryBackend())
    with pytest.raises(ValueError, match="storage layout"):
        VSS(root, backend="replicated:3")
    vss2 = VSS(root, backend="local")  # original layout still opens fine
    assert vss2.read("v", codec="rgb", cache=False).frames.shape \
        == short_clip.shape
    vss2.close()


def test_tiered_layout_interchangeable_with_cold(tmp_path, short_clip):
    """The hot tier is ephemeral — tiered-over-local and plain local
    share a placement scheme and may reopen each other's stores."""

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="local")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.close()
    vss2 = VSS(root, backend="tiered:local")
    assert vss2.read("v", codec="rgb", cache=False).frames.shape \
        == short_clip.shape
    vss2.close()


def test_drop_frees_joint_segments_only_at_last_referent(vss, overlap_pair):
    left, right, _ = overlap_pair
    vss.write("cam_a", left, fps=30.0, codec="rgb", gop_frames=left.shape[0])
    vss.write("cam_b", right, fps=30.0, codec="rgb",
              gop_frames=right.shape[0])
    jids = vss.apply_joint_compression(["cam_a", "cam_b"])
    assert jids
    seg_keys = vss.catalog.all_joint_segment_paths()
    assert seg_keys and all(vss.backend.exists(k) for k in seg_keys)
    vss.drop("cam_a")  # partner still reads through the shared pieces
    assert all(vss.backend.exists(k) for k in seg_keys)
    vss.drop("cam_b")  # last referent: pieces and joint rows are freed
    assert not any(vss.backend.exists(k) for k in seg_keys)
    assert not vss.catalog.all_joint_segment_paths()


# ---------------------------------------------------------------------------
# zlib fallback (the no-zstandard environment)
# ---------------------------------------------------------------------------

def test_wrap_roundtrip_without_zstd(monkeypatch):
    from repro_torch.core import deferred

    monkeypatch.setattr(deferred, "zstandard", None)
    data = b"y" * 5000 + bytes(range(256))
    w = deferred.wrap_bytes(data, 5)
    assert w[:4] == deferred.LMAGIC
    assert deferred.is_wrapped(w)
    # decode side needs no zstd either way for zlib-wrapped data
    assert deferred.unwrap_bytes(w) == data


def test_codec_roundtrip_without_zstd(monkeypatch, short_clip):
    from repro_torch.codec import tvc

    monkeypatch.setattr(tvc, "zstandard", None)
    enc = tvc.encode_gop(short_clip[:8], "tvc-hi", device="cpu")
    out = tvc.decode_gop(enc, device="cpu")
    assert out.shape == short_clip[:8].shape
    # serialized form round-trips through the normal object path
    assert tvc.decode_gop(tvc.deserialize_gop(tvc.serialize_gop(enc)),
                          device="cpu").shape == out.shape


def test_validate_gop_bytes_detects_truncation(short_clip):
    from repro_torch.codec import tvc
    from repro_torch.storage import validate_gop_bytes

    data = tvc.serialize_gop(tvc.encode_gop(short_clip[:8], "tvc-med",
                                            device="cpu"))
    assert validate_gop_bytes(data)
    assert not validate_gop_bytes(data[: len(data) // 2])
    assert not validate_gop_bytes(b"garbage")


# ---------------------------------------------------------------------------
# the port against the reference: same operations, same answers, and
# stores that cross between the packages
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    """A call's result in a package-neutral form: typed errors by class
    name (both packages define their own classes), stats by their
    fields, listings sorted."""
    try:
        out = fn(*args)
    except Exception as exc:  # noqa: BLE001 - the type is the result
        return ("raise", type(exc).__name__)
    if isinstance(out, (jstorage.ObjectStat, tstorage.ObjectStat)):
        return ("ok", out.key, out.nbytes)
    if fn.__name__ == "list":
        return ("ok", sorted(out))
    return ("ok", out)


def _random_op(rng, keys):
    op = rng.choice(("put", "put", "get", "get_range", "stat", "exists",
                     "delete", "list", "batch_get", "batch_put",
                     "batch_get_ranges"))
    key = rng.choice(keys)
    if op == "put":
        return op, (key, rng.randbytes(rng.randrange(0, 3000)))
    if op == "get_range":
        return op, (key, rng.randrange(-1, 3000), rng.randrange(-1, 400))
    if op == "list":
        return op, (rng.choice(("", "v/", "v/1/", "w/", "x")),)
    if op == "batch_get":
        return op, (rng.sample(keys, rng.randrange(1, 4)),)
    if op == "batch_put":
        return op, ([(k, rng.randbytes(rng.randrange(1, 900)))
                     for k in rng.sample(keys, rng.randrange(1, 4))],)
    if op == "batch_get_ranges":
        return op, ([(k, rng.randrange(0, 600), rng.randrange(1, 300))
                     for k in rng.sample(keys, rng.randrange(1, 3))],)
    return op, (key,)


@pytest.mark.parametrize("spec", BACKEND_SPECS)
def test_conformance_matches_reference(spec, tmp_path):
    """Every conformance row, driven through one seeded sequence of puts,
    gets, ranged reads, stats, listings and deletes in both packages:
    every answer and every typed error must be the same."""
    jb = _make(spec, str(tmp_path / "j"), jstorage)
    tb = _make(spec, str(tmp_path / "t"))
    rng = random.Random(f"conformance:{spec}")
    keys = [f"v/1/{i}.tvc" for i in range(4)] + [
        f"v/2/{i}.tvc" for i in range(3)] + ["w/0.tvc", "x"]
    try:
        for step in range(250):
            op, args = _random_op(rng, keys)
            want = _outcome(getattr(jb, op), *args)
            got = _outcome(getattr(tb, op), *args)
            assert got == want, (step, op, args)
        assert sorted(tb.list()) == sorted(jb.list())
        assert tb.layout_fingerprint().split(":")[0] \
            == jb.layout_fingerprint().split(":")[0]
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_hash_ring_places_like_reference(n):
    """Placement is md5 over the key: every key must land on the same
    slot, and walk the same replica preference, in both packages."""
    jring, tring = jstorage.HashRing(n), tstorage.HashRing(n)
    rng = random.Random(n)
    for i in range(10_000):
        key = f"v/{rng.randrange(1 << 30)}/{i}.tvc"
        assert tring.owner(key) == jring.owner(key), key
        r = 1 + i % n
        assert tring.preference(key, r) == jring.preference(key, r), key


_FP_SPECS = ("local", "local:fsync", "memory", "sharded:1", "sharded:4",
             "sharded:7", "tiered", "tiered:local", "tiered:memory",
             "tiered:sharded:3", "tiered:replicated:4", "tiered:remote",
             "replicated", "replicated:2", "replicated:5", "replicated:5:3:3",
             "replicated:4:3:2", "remote", "remote:<url>",
             "tiered:remote:<url>", "remotes:<url>")


@pytest.mark.parametrize("order", ["reference-first", "port-first"])
def test_layout_fingerprint_matches_reference(tmp_path, order):
    """`layout_fingerprint()` guards a store's reopen, so it must be the
    same string in both packages for every spec of the grammar, on the
    same root (a self-hosted remote mints its id there) and against the
    same external server, plain and over TLS with a secret."""
    cert, key = mint_tls_cert(str(tmp_path / "tls"))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    plain = jstorage.ObjectServer(jstorage.LocalFSBackend(
        str(tmp_path / "ext")))
    tls = tstorage.ObjectServer(tstorage.LocalFSBackend(
        str(tmp_path / "ext-tls")), secret=_TLS_SECRET, ssl_context=ctx)
    packages = (jstorage, tstorage)
    if order == "port-first":
        packages = packages[::-1]
    try:
        for i, spec in enumerate(_FP_SPECS):
            url = tls.url if spec.startswith("remotes") else plain.url
            spec = spec.replace("<url>", url.split("://", 1)[1]
                                if spec.startswith("remotes") else url)
            root = str(tmp_path / f"s{i}")
            fps = []
            for S in packages:
                b = S.make_backend(spec, root, secret=_TLS_SECRET
                                   if spec.startswith("remotes") else None,
                                   ca_file=cert)
                fps.append(b.layout_fingerprint())
                b.close()
            assert fps[0] == fps[1], spec
    finally:
        plain.close()
        tls.close()


CROSS_SPECS = ("sharded:4", "tiered", "replicated:3:2:2", "tiered:remote")


def _write_and_read(vss, clip):
    vss.write("v", clip, fps=30.0, codec="hevc")
    vss.write("w", clip[:30], fps=30.0, codec="tvc-ll")
    vss.read("v", resolution=(64, 48))  # a cached view too
    return {name: vss.read(name, cache=False).frames for name in ("v", "w")}


@pytest.mark.parametrize("spec", CROSS_SPECS)
def test_reference_backend_store_reads_back_in_port(tmp_path, clip, spec):
    from repro.core.config import VSSConfig as JConfig
    from repro.core.store import VSS as JVSS

    root = str(tmp_path / "s")
    j = JVSS(root, config=JConfig(backend=spec))
    want = _write_and_read(j, clip)
    j.close()
    t = VSS(root, config=VSSConfig(backend=spec))
    for name, frames in want.items():
        assert np.array_equal(t.read(name, cache=False).frames, frames)
    assert np.array_equal(want["w"], clip[:30])
    t.close()


@pytest.mark.parametrize("spec", CROSS_SPECS)
def test_port_backend_store_reads_back_in_reference(tmp_path, clip, spec):
    from repro.core.config import VSSConfig as JConfig
    from repro.core.store import VSS as JVSS

    root = str(tmp_path / "s")
    t = VSS(root, config=VSSConfig(backend=spec))
    want = _write_and_read(t, clip)
    t.close()
    j = JVSS(root, config=JConfig(backend=spec))
    for name, frames in want.items():
        assert np.array_equal(j.read(name, cache=False).frames, frames)
    j.close()
