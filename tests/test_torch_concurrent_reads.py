"""Concurrent `read_batch` callers over one `VSS` handle.

The serving tier multiplexes many HTTP clients onto a single store, so
the read path must hold up under real thread concurrency: results stay
bit-exact regardless of interleaving, reads racing a streaming writer
never deadlock against the ingest read-your-writes barrier, and the
QoS ordering knobs (priority, deadline_ms) sequence execution within a
coalesced group without changing what is returned.

The reference's `tests/test_concurrent_reads.py` on the port (CPU),
plus the same results and execution order as the reference's."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro import codec as jcodec
from repro.core.config import VSSConfig as JConfig
from repro.core.spec import ReadSpec as JReadSpec
from repro.core.store import VSS as JVSS
from repro_torch import codec as tcodec
from repro_torch.core.config import VSSConfig
from repro_torch.core.spec import ReadSpec
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


@pytest.fixture()
def road_store(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    return vss


def _mixed_specs():
    return [
        ReadSpec("road", t=(0.0, 1.0), codec="rgb", cache=False),
        ReadSpec("road", t=(0.5, 1.5), codec="tvc-med", cache=False),
        ReadSpec("road", t=(1.0, 2.0), codec="rgb",
                 resolution=(64, 48), cache=False),
        ReadSpec("road", codec="tvc-lo", cache=False),
    ]


def test_concurrent_read_batch_bit_exact(road_store):
    """N threads hammering read_batch see exactly what a sequential
    caller sees — no torn buffers, no cross-request bleed."""
    specs = _mixed_specs()
    reference = [r.frames for r in road_store.read_batch(specs)]

    outputs = [None] * 6
    errors = []

    def worker(slot):
        try:
            outputs[slot] = [
                r.frames for r in road_store.read_batch(specs)
            ]
        except Exception as exc:  # noqa: BLE001 - collected for assert
            errors.append(exc)

    threads = [
        threading.Thread(target=worker, args=(i,))
        for i in range(len(outputs))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "read_batch caller deadlocked"
    assert not errors, errors
    for got in outputs:
        assert got is not None
        for g, ref in zip(got, reference):
            assert np.array_equal(g, ref)


def test_concurrent_reads_race_streaming_writer_no_deadlock(vss, clip):
    """Readers barrier on the ingest pipeline while a writer streams
    into the same store: every read must return (no deadlock) and
    observe a consistent prefix of what was appended."""
    w = vss.writer("stream", fps=30.0, codec="rgb", gop_frames=10)
    w.append(clip[:20])

    stop = threading.Event()
    errors = []
    reads_done = [0]

    def reader():
        while not stop.is_set():
            try:
                out = vss.read_batch(
                    [ReadSpec("stream", t=(0.0, 20 / 30.0), codec="rgb",
                              cache=False)]
                )[0].frames
                assert np.array_equal(out, clip[:20])
                reads_done[0] += 1
            except Exception as exc:  # noqa: BLE001 - collected
                errors.append(exc)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    # keep appending while the readers run, then close (durability
    # barrier) with readers still active
    for i in range(20, len(clip), 10):
        w.append(clip[i:i + 10])
    w.close()
    stop.set()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "reader deadlocked against ingest barrier"
    assert not errors, errors
    assert reads_done[0] > 0
    # post-close, the full video reads back exactly
    full = vss.read("stream", codec="rgb").frames
    assert np.array_equal(full, clip)


def _spy_order(vss):
    """Record the interval start of every plan ``vss`` materializes."""
    executed = []
    inner = vss._execute

    def spy(plan, *args, **kwargs):
        executed.append(plan.segments[0][0])
        return inner(plan, *args, **kwargs)

    vss._execute = spy
    return executed


def test_concurrent_batches_match_reference(tmp_path, clip):
    """Six threads of read_batch on each package's store: every thread's
    results equal the reference's sequential batch, frames and blobs,
    and both packages execute the QoS-ordered batch in the same order."""
    j = JVSS(str(tmp_path / "j"), config=JConfig(backend="local"))
    t = VSS(str(tmp_path / "t"), config=VSSConfig(backend="local"))
    try:
        for vss in (j, t):
            vss.write("road", clip, fps=30.0, codec="tvc-med",
                      gop_frames=15)
        kws = [dict(t=(0.0, 1.0), codec="rgb"),
               dict(t=(0.5, 1.5), codec="tvc-med", priority=3),
               dict(t=(1.0, 2.0), codec="rgb", resolution=(64, 48),
                    deadline_ms=20.0),
               dict(codec="tvc-lo", priority=3, deadline_ms=5.0)]
        want = j.read_batch([JReadSpec("road", cache=False, **kw)
                             for kw in kws])
        outputs, errors = [None] * 6, []

        def worker(slot):
            try:
                outputs[slot] = t.read_batch(
                    [ReadSpec("road", cache=False, **kw) for kw in kws])
            except Exception as exc:  # noqa: BLE001 - collected
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(outputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive(), "read_batch caller deadlocked"
        assert not errors, errors
        for got in outputs:
            for g, w in zip(got, want):
                assert g.codec == w.codec
                assert np.array_equal(g.frames, w.frames)
                if w.encoded is not None:
                    assert [tcodec.serialize_gop(e) for e in g.encoded] == \
                        [jcodec.serialize_gop(e) for e in w.encoded]
        orders = []
        for vss, S in ((j, JReadSpec), (t, ReadSpec)):
            order = _spy_order(vss)
            vss.read_batch([S("road", cache=False, **kw) for kw in kws])
            orders.append(order)
        # rgb results materialize through _execute: the deadline first
        assert orders[1] == orders[0] == [1.0, 0.0]
    finally:
        j.close()
        t.close()


def test_priority_and_deadline_order_execution(road_store):
    """Within one coalesced group: priority desc, then earliest
    deadline, then submission order — observable through the order the
    executor materializes plans, while results stay input-ordered."""
    specs = [
        ReadSpec("road", t=(0.0, 0.5), codec="rgb", cache=False),
        ReadSpec("road", t=(0.5, 1.0), codec="rgb", cache=False,
                 priority=5, deadline_ms=100.0),
        ReadSpec("road", t=(1.0, 1.5), codec="rgb", cache=False,
                 priority=5, deadline_ms=50.0),
        ReadSpec("road", t=(1.5, 2.0), codec="rgb", cache=False,
                 deadline_ms=10_000.0),
    ]
    executed = []
    inner = road_store._execute

    def spy(plan, *args, **kwargs):
        executed.append(plan.segments[0][0])  # interval start = identity
        return inner(plan, *args, **kwargs)

    road_store._execute = spy
    try:
        results = road_store.read_batch(specs)
    finally:
        road_store._execute = inner
    # expected: p5/d50 (t=1.0), p5/d100 (t=0.5), p0/d10s (t=1.5),
    # p0/no-deadline (t=0.0)
    assert executed == [1.0, 0.5, 1.5, 0.0]
    # ...but results come back in submission order, bit-exact
    for spec, res in zip(specs, results):
        ref = road_store.read(
            "road", t=spec.t, codec="rgb", cache=False
        ).frames
        assert np.array_equal(res.frames, ref)


def test_deadline_ms_validation():
    assert ReadSpec("v", deadline_ms=0).deadline_ms == 0.0
    assert ReadSpec("v", deadline_ms="25").deadline_ms == 25.0
    assert ReadSpec("v").deadline_ms is None
    with pytest.raises(ValueError):
        ReadSpec("v", deadline_ms=-1)
    with pytest.raises(ValueError):
        ReadSpec("v", deadline_ms=float("nan"))
    with pytest.raises(ValueError):
        ReadSpec("v", deadline_ms="soon")


def test_deadline_does_not_change_plan_or_result_identity(road_store):
    """deadline_ms is pure QoS: specs differing only in deadline share
    plan groups and deduped execution."""
    a = ReadSpec("road", t=(0.0, 1.0), codec="rgb", cache=False)
    b = ReadSpec("road", t=(0.0, 1.0), codec="rgb", cache=False,
                 deadline_ms=5_000.0)
    ra = a.resolve(road_store.catalog.get_physical(
        road_store.catalog.get_original_id("road")))
    rb = b.resolve(road_store.catalog.get_physical(
        road_store.catalog.get_original_id("road")))
    assert ra.plan_key() == rb.plan_key()
    assert ra.result_key() == rb.result_key()
    out = road_store.read_batch([a, b])
    assert np.array_equal(out[0].frames, out[1].frames)
