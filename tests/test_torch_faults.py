"""Chaos suite: `FaultInjectingBackend` driving the remote retry path,
replicated quorum/fallback, and the §2 pipeline under injected faults.

The wrapper is the shared fault fixture for the whole backend matrix
(see also its quiet run inside test_storage.py's conformance suite):
seeded, so every failing sequence replays bit-identically."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.storage import (
    FaultInjectingBackend,
    InjectedFault,
    LocalFSBackend,
    MemoryBackend,
    ObjectServer,
    RemoteBackend,
    RemoteError,
    ReplicatedBackend,
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


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def _chaos_trace(seed, S=tstorage):
    b = S.FaultInjectingBackend(S.MemoryBackend(), seed=seed,
                                error_rate=0.35, torn_write_rate=0.2)
    outcomes = []
    for i in range(40):
        try:
            if i % 3 == 0:
                b.put(f"k{i % 7}", b"payload" * 10)
            elif i % 3 == 1:
                b.get(f"k{(i - 1) % 7}")
            else:
                b.stat(f"k{(i - 2) % 7}")
            outcomes.append("ok")
        except (InjectedFault, Exception) as exc:
            outcomes.append(type(exc).__name__)
    return outcomes, list(b.fault_log)


def test_seeded_chaos_is_reproducible():
    """Same seed, same op sequence -> identical faults, outcomes and
    fault log; a different seed produces different weather."""
    a_out, a_log = _chaos_trace(42)
    b_out, b_log = _chaos_trace(42)
    assert a_out == b_out and a_log == b_log
    c_out, c_log = _chaos_trace(43)
    assert (a_out, a_log) != (c_out, c_log)


def test_fail_next_forces_exact_failures():
    b = FaultInjectingBackend(MemoryBackend(), seed=0)
    b.put("k", b"v")
    b.fail_next(2)
    with pytest.raises(InjectedFault):
        b.get("k")
    with pytest.raises(InjectedFault):
        b.get("k")
    assert b.get("k") == b"v"  # exactly two, then clean
    assert b.injected_errors == 2


def test_wrapper_is_transparent_to_calibration():
    """Calibrating through the wrapper must price the wrapped store's
    real kind, not file weather under the wrapper's default."""
    inner = MemoryBackend()
    b = FaultInjectingBackend(inner, seed=0)
    assert b.calibration_targets() == {"memory": inner}


def test_hang_then_recover():
    b = FaultInjectingBackend(MemoryBackend(), seed=0)
    b.put("k", b"v")
    b.hang()
    got = []
    t = threading.Thread(target=lambda: got.append(b.get("k")))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive() and not got  # stalled, not failed
    b.resume()
    t.join(timeout=30.0)
    assert got == [b"v"]


# ---------------------------------------------------------------------------
# remote retry path under server-side faults
# ---------------------------------------------------------------------------

@pytest.fixture()
def flaky_served():
    store = FaultInjectingBackend(MemoryBackend(), seed=3)
    server = ObjectServer(store)
    rb = RemoteBackend(server.url, max_retries=3, backoff_base=0.005)
    yield store, rb
    store.resume()
    rb.close()
    server.close()


def test_remote_retries_ride_out_transient_5xx(flaky_served):
    store, rb = flaky_served
    rb.put("k", b"v")
    store.fail_next(2)  # two 500s, then the third attempt lands
    assert rb.get("k") == b"v"
    assert rb.retries == 2


def test_remote_retries_exhaust_then_raise(flaky_served):
    store, rb = flaky_served
    rb.put("k", b"v")
    store.fail_next(10 ** 6)  # never recovers within the budget
    before = rb.retries
    with pytest.raises(RemoteError, match="failed after 4 attempts"):
        rb.get("k")
    assert rb.retries - before == 3  # max_retries, no unbounded spin
    store.fail_next(0)


def test_remote_put_survives_faulty_commit_path(flaky_served):
    """Faults striking inside the server-side rename (get/put/delete on
    the backing store) answer 500; the client's retried POST must land
    the commit exactly once, with no temp debris."""
    from repro_torch.storage.remote import TEMP_PREFIX

    store, rb = flaky_served
    store.fail_next(1)  # the first backing-store op of the put 500s
    rb.put("k", b"exactly-once")
    assert rb.retries >= 1
    assert store.inner.get("k") == b"exactly-once"
    rb.sweep_temps()
    assert all(not k.startswith(TEMP_PREFIX) for k in store.inner.list())


def test_remote_rides_out_hang_then_recover(flaky_served):
    store, rb = flaky_served
    rb.put("k", b"v")
    store.hang()
    got = []
    t = threading.Thread(target=lambda: got.append(rb.get("k")))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()  # blocked on the hung device, not erroring
    store.resume()
    t.join(timeout=30.0)
    assert got == [b"v"]


# ---------------------------------------------------------------------------
# replicated quorum under injected faults
# ---------------------------------------------------------------------------

def _replicated_with_faulty_child(tmp_path, **fault_kw):
    children = [
        FaultInjectingBackend(
            LocalFSBackend(str(tmp_path / "c0")), seed=11, **fault_kw
        ),
        LocalFSBackend(str(tmp_path / "c1")),
        LocalFSBackend(str(tmp_path / "c2")),
    ]
    return children[0], ReplicatedBackend(
        children,
        # corruption detection for the raw test payloads: a complete
        # object carries its full declared length
        validate=lambda d: len(d) >= 64,
    )


def test_quorum_writes_survive_injected_torn_writes(tmp_path):
    """Every write to child 0 tears (truncated bytes land AND the put
    raises): quorum still reached on the healthy children, and reads
    never return the partially-written bytes."""
    faulty, rb = _replicated_with_faulty_child(
        tmp_path, torn_write_rate=1.0
    )
    keys = [f"v/{i}/0.tvc" for i in range(12)]
    full = {k: k.encode() * 8 for k in keys}  # >= 64 bytes each
    for k in keys:
        rb.put(k, full[k])
    rb.quiesce()
    torn_keys = [
        k for k in keys
        if 0 in rb.replicas_for(k) and faulty.inner.exists(k)
    ]
    assert torn_keys  # the faulty child really holds torn objects
    assert all(
        len(faulty.inner.get(k)) < len(full[k]) for k in torn_keys
    )
    for k in keys:  # reads skip the torn copies via validate-fallback
        assert rb.get(k) == full[k]
    assert rb.batch_get(keys) == [full[k] for k in keys]
    assert rb.stats.degraded_writes > 0
    rb.close()


def test_transient_child_faults_never_fail_quorum_ops(tmp_path):
    faulty, rb = _replicated_with_faulty_child(tmp_path, error_rate=0.4)
    keys = [f"v/{i}/0.tvc" for i in range(20)]
    full = {k: k.encode() * 8 for k in keys}
    rb.batch_put(list(full.items()))  # quorum met despite the weather
    rb.quiesce()
    assert rb.batch_get(keys) == [full[k] for k in keys]
    for k in keys:
        assert rb.get(k) == full[k]
    assert faulty.injected_errors > 0  # the chaos actually fired
    rb.close()


def test_vss_pipeline_survives_flaky_replica(tmp_path):
    """End-to-end §2 chaos: one of three replicas randomly failing and
    tearing writes, and the full write -> cached read -> recode path
    still returns exact frames."""
    from repro_torch.data.video import synthesize_road
    from repro_torch.storage import validate_gop_bytes

    clip = synthesize_road(30, width=128, height=96, seed=5)
    children = [
        FaultInjectingBackend(
            LocalFSBackend(str(tmp_path / "c0")), seed=9,
            error_rate=0.25, torn_write_rate=0.25,
        ),
        LocalFSBackend(str(tmp_path / "c1")),
        LocalFSBackend(str(tmp_path / "c2")),
    ]
    backend = ReplicatedBackend(children, validate=validate_gop_bytes)
    vss = VSS(str(tmp_path / "vss"), backend=backend)
    try:
        vss.write("v", clip, fps=30.0, codec="tvc-ll", gop_frames=10)
        out = vss.read("v", codec="rgb", cache=False).frames
        assert np.array_equal(out, clip)  # tvc-ll: bit-exact or bust
        out2 = vss.read("v", t=(0.3, 0.9), codec="rgb", cache=False).frames
        assert np.array_equal(out2, clip[9:27])
    finally:
        vss.close()


def test_scrub_repairs_what_chaos_tore(tmp_path):
    """After a torn-write storm, the scrubber restores every replica
    from a healthy copy (the shared-repair path the remote sweep and
    replicated recovery both lean on)."""
    from repro_torch.data.video import synthesize_road
    from repro_torch.storage import validate_gop_bytes

    clip = synthesize_road(30, width=128, height=96, seed=6)
    faulty = FaultInjectingBackend(
        LocalFSBackend(str(tmp_path / "c0")), seed=21, torn_write_rate=0.5,
    )
    children = [faulty,
                LocalFSBackend(str(tmp_path / "c1")),
                LocalFSBackend(str(tmp_path / "c2"))]
    backend = ReplicatedBackend(children, validate=validate_gop_bytes)
    vss = VSS(str(tmp_path / "vss"), backend=backend)
    try:
        vss.write("v", clip, fps=30.0, codec="tvc-med", gop_frames=10)
        backend.quiesce()
        assert faulty.injected_torn > 0  # the storm happened
        faulty.torn_write_rate = 0.0     # weather clears; now heal
        report = vss.scrub()
        assert report.replicas_repaired > 0
        keys = [g.path for g in vss.catalog.all_gops()
                if g.joint_ref is None]
        assert keys and all(
            backend.replica_count(k) == backend.replicas for k in keys
        )
        # every replica of every key now validates
        for k in keys:
            for ci in backend.replicas_for(k):
                assert validate_gop_bytes(backend.replica_get(ci, k))
    finally:
        vss.close()


# ---------------------------------------------------------------------------
# injected latency (the knob fig26 uses to emulate a WAN round trip)
# ---------------------------------------------------------------------------

def test_injected_latency_slows_ops_measurably():
    b = FaultInjectingBackend(MemoryBackend(), seed=0, latency=0.01)
    b.put("k", b"v")
    t0 = time.perf_counter()
    for _ in range(10):
        b.get("k")
    elapsed = time.perf_counter() - t0
    # mean delay 10ms/op, uniform on [0, 20ms]: 10 ops take >0 — use a
    # generous floor so slow CI can't flake it
    assert elapsed > 0.02
    b.close()


# ---------------------------------------------------------------------------
# the port against the reference: one seed, one weather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 43, 1234])
def test_seeded_chaos_matches_reference(seed):
    """The same seed injects the same faults into the same operations in
    both packages: outcomes and fault logs are equal."""
    assert _chaos_trace(seed) == _chaos_trace(seed, jstorage)


def test_torn_write_lengths_match_reference():
    """A torn write lands the same truncated prefix in both packages."""
    landed = []
    for S in (jstorage, tstorage):
        inner = S.MemoryBackend()
        b = S.FaultInjectingBackend(inner, seed=5, torn_write_rate=0.5,
                                    error_rate=0.1)
        outcomes = []
        for i in range(30):
            try:
                b.put(f"k{i}", bytes(range(256)) * (1 + i % 4))
                outcomes.append("ok")
            except Exception as exc:  # noqa: BLE001 - the type is the result
                outcomes.append(type(exc).__name__)
        landed.append((outcomes, b.fault_log, b.injected_errors,
                       b.injected_torn,
                       {k: inner.get(k) for k in inner.list()}))
    assert landed[1] == landed[0]
