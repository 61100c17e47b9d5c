"""Pipelined ingest: queue semantics, multi-stream concurrency, error
propagation, durability barriers, and crash-mid-queue recovery — the
reference's `tests/test_ingest.py` on the port (CPU), plus the same
stores, counters and recovery after the same crash as the reference's."""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.config import VSSConfig as JConfig
from repro.core.spec import WriteSpec as JWriteSpec
from repro.core.store import VSS as JVSS
from repro_torch.core.config import VSSConfig
from repro_torch.core.spec import WriteSpec
from repro_torch.core.store import VSS as _PortVSS
from repro_torch.storage import MemoryBackend


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


def _wait_until(pred, timeout=30.0, what="condition"):
    """Poll a state predicate to a deadline — the synchronization
    primitive for 'the other thread has provably reached state X'.
    Tests must never assert on a fixed sleep's worth of progress (a
    loaded CI runner makes that a coin flip); they wait for the state
    itself and only then assert."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out awaiting {what}"
        time.sleep(0.005)


def _writer(vss, name, *, codec="rgb", gop_frames=15, batch_gops=1,
            pipelined=None):
    return vss.writer_spec(
        WriteSpec(name=name, fps=30.0, codec=codec, gop_frames=gop_frames),
        batch_gops=batch_gops, pipelined=pipelined,
    )


class FlakyBackend(MemoryBackend):
    """Fails every batch_put after the first ``ok_puts`` windows."""

    def __init__(self, ok_puts: int):
        super().__init__()
        self.ok_puts = ok_puts
        self.batch_puts = 0

    def batch_put(self, items):
        self.batch_puts += 1
        if self.batch_puts > self.ok_puts:
            raise IOError("simulated volume failure")
        super().batch_put(items)


# ---------------------------------------------------------------------------
# pipelined writer semantics
# ---------------------------------------------------------------------------

def test_pipelined_roundtrip_and_prefix_read(vss, clip):
    w = _writer(vss, "v", codec="tvc-ll", gop_frames=15)
    w.append(clip[:30])
    # read-your-writes: the store waits out this video's queued windows
    r = vss.read("v", t=(0.0, 1.0), cache=False)
    assert r.frames.shape[0] == 30
    w.append(clip[30:])
    w.close()  # durability barrier
    out = vss.read("v", cache=False).frames
    assert np.array_equal(out, clip)  # tvc-ll is bit-exact
    st = vss.ingest.stats()
    assert st.queued_gops == 0
    assert st.gops_published == st.gops_submitted == 4
    assert st.errors == 0


def test_concurrent_multi_stream_ingest(vss, clip):
    """N camera streams share one pipeline; each stream's GOPs stay
    FIFO and every stream reads back exactly."""
    n = 4
    errs = []

    def ingest(i):
        try:
            w = _writer(vss, f"cam{i}", gop_frames=15, batch_gops=2)
            for off in range(0, clip.shape[0], 20):
                w.append(clip[off: off + 20])
            w.close()
        except Exception as exc:  # pragma: no cover - fail loudly below
            errs.append(exc)

    threads = [threading.Thread(target=ingest, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    for i in range(n):
        out = vss.read(f"cam{i}", cache=False).frames
        assert np.array_equal(out, clip)  # rgb: bit-exact, order intact
    st = vss.ingest.stats()
    assert st.gops_published == st.gops_submitted == n * 4
    assert st.queued_gops == 0


def test_backpressure_bounds_the_queue(tmp_path, clip):
    vss = VSS(str(tmp_path / "vss"), ingest_queue_gops=1, ingest_workers=1)
    try:
        vss.ingest.pause()
        w = _writer(vss, "v", gop_frames=15)
        fed = threading.Event()

        def feed():
            w.append(clip)  # 4 GOPs -> 4 windows; bound is 1 GOP
            fed.set()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        # with workers paused the second submit must block on the
        # bound: wait for the *provable* blocked state (the pipeline
        # counts the wait before sleeping on it), not a wall-clock
        # guess about how far the feeder got
        _wait_until(
            lambda: vss.ingest.stats().backpressure_waits >= 1,
            what="the feeder to block on the queue bound",
        )
        assert not fed.is_set()
        vss.ingest.resume()
        assert fed.wait(30.0)
        t.join(timeout=30.0)
        w.close()
        st = vss.ingest.stats()
        assert st.backpressure_waits >= 1
        assert st.max_queued_gops == 1  # the bound held
        assert np.array_equal(vss.read("v", cache=False).frames, clip)
    finally:
        vss.close()


def test_inline_mode_with_zero_workers(tmp_path, clip):
    """workers=0 degrades to synchronous inline publishing."""
    vss = VSS(str(tmp_path / "vss"), ingest_workers=0)
    try:
        w = _writer(vss, "v", gop_frames=15)
        w.append(clip)
        w.close()
        assert np.array_equal(vss.read("v", cache=False).frames, clip)
        st = vss.ingest.stats()
        assert st.gops_published == st.gops_submitted == 4
    finally:
        vss.close()


def test_blocking_writer_still_supported(vss, clip):
    w = _writer(vss, "v", gop_frames=15, pipelined=False)
    w.append(clip)
    w.close()
    assert np.array_equal(vss.read("v", cache=False).frames, clip)


def test_barrier_waits_on_snapshot_not_live_writer(tmp_path, clip):
    """A continuously-appending writer must never starve a concurrent
    reader's barrier: the barrier covers windows submitted before it
    began, not ones that keep arriving."""

    class GatedBackend(MemoryBackend):
        def __init__(self):
            super().__init__()
            self.gate = threading.Semaphore(0)
            self.arrivals = 0  # windows that reached the backend

        def batch_put(self, items):
            with self._lock:
                self.arrivals += 1
            self.gate.acquire()  # one permit per window
            super().batch_put(items)

    backend = GatedBackend()
    vss = VSS(str(tmp_path / "vss"), backend=backend, ingest_workers=1,
              enable_deferred=False, enable_compaction=False)
    try:
        w = _writer(vss, "v", gop_frames=15)
        w.append(clip[:30])  # windows 1+2 submitted (worker blocks on 1)
        done = threading.Event()
        t = threading.Thread(
            target=lambda: (vss.ingest.barrier({"v"}), done.set()),
            daemon=True,
        )
        t.start()
        # deterministic "barrier is really waiting" check: once the
        # worker is provably parked on the gate, window 1 cannot have
        # settled — so the barrier cannot have returned
        _wait_until(lambda: backend.arrivals >= 1,
                    what="the worker to park on the gate")
        assert not done.is_set()   # nothing settled yet
        w.append(clip[30:])        # windows 3+4 arrive AFTER the barrier
        backend.gate.release()
        backend.gate.release()     # settle exactly windows 1+2
        assert done.wait(30.0)     # barrier returns; 3+4 still queued
        st = vss.ingest.stats()
        assert st.queued_gops > 0  # later windows did not extend the wait
        for _ in range(8):
            backend.gate.release()
        w.close()
        assert np.array_equal(vss.read("v", cache=False).frames, clip)
    finally:
        for _ in range(8):  # never leave the worker stuck on the gate
            backend.gate.release()
        vss.close()


# ---------------------------------------------------------------------------
# error propagation
# ---------------------------------------------------------------------------

def test_failed_put_reraises_on_writer_not_reader(tmp_path, clip):
    backend = FlakyBackend(ok_puts=1)
    vss = VSS(str(tmp_path / "vss"), backend=backend,
              enable_deferred=False, enable_compaction=False)
    try:
        w = _writer(vss, "v", gop_frames=15)
        vss.ingest.pause()  # queue all 4 windows, then fail window 2
        w.append(clip)
        vss.ingest.resume()
        with pytest.raises(IOError, match="simulated volume failure"):
            w.close()
        # exactly the durable prefix is indexed; nothing dangles
        gops = [
            g for p in vss.catalog.physicals_for("v")
            for g in vss.catalog.gops_for(p.physical_id)
        ]
        assert len(gops) == 1
        assert all(backend.exists(g.path) for g in gops)
        st = vss.ingest.stats()
        assert st.errors == 1
        assert st.gops_published == 1
        assert st.gops_dropped_after_error == 2  # windows 3+4, discarded
        # the writer is poisoned; later calls re-raise, nothing is lost
        # silently
        with pytest.raises(IOError):
            w.append(clip[:15])
        # readers of the durable prefix are unaffected
        out = vss.read("v", cache=False).frames
        assert np.array_equal(out, clip[:15])
    finally:
        vss.close()


def test_error_on_one_stream_leaves_others_alone(tmp_path, clip):
    class TargetedFlaky(MemoryBackend):
        def batch_put(self, items):
            if any(k.startswith("bad/") for k, _ in items):
                raise IOError("bad volume")
            super().batch_put(items)

    vss = VSS(str(tmp_path / "vss"), backend=TargetedFlaky(),
              enable_deferred=False, enable_compaction=False)
    try:
        wg = _writer(vss, "good", gop_frames=15)
        wb = _writer(vss, "bad", gop_frames=15)
        vss.ingest.pause()  # queue both streams' windows first
        wg.append(clip[:30])
        wb.append(clip[:30])
        vss.ingest.resume()
        with pytest.raises(IOError):
            wb.close()
        wg.append(clip[30:])
        wg.close()  # the healthy stream is untouched
        assert np.array_equal(vss.read("good", cache=False).frames, clip)
    finally:
        vss.close()


def test_blocking_writer_failed_put_is_retryable(tmp_path, clip):
    """pipelined=False: a failed inline publish must leave the writer's
    accounting matching the catalog — the window buffers back and a
    retry republishes it, with no phantom hole in the frame index."""
    backend = FlakyBackend(ok_puts=1)
    vss = VSS(str(tmp_path / "vss"), backend=backend,
              enable_deferred=False, enable_compaction=False)
    try:
        w = _writer(vss, "v", gop_frames=15, pipelined=False)
        w.append(clip[:15])  # window 1 publishes inline
        with pytest.raises(IOError):
            w.append(clip[15:30])  # window 2 fails inside the put
        assert len(w._pending) == 1  # ...and is buffered back
        backend.ok_puts = 10 ** 9  # the volume comes back
        w.append(clip[30:])
        w.close()
        out = vss.read("v", cache=False).frames
        assert np.array_equal(out, clip)  # contiguous, nothing skipped
    finally:
        vss.close()


# ---------------------------------------------------------------------------
# crash mid-queue: recovery drops partials, never an indexed-but-missing GOP
# ---------------------------------------------------------------------------

def _simulate_crash(vss):
    """Tear the store down exactly as a process death would leave it:
    workers stop (queued windows evaporate), no clean-shutdown marker,
    no drain."""
    vss.ingest.close()
    vss.deferred.stop_background()
    vss.catalog.close()
    vss.backend.close()


def test_crash_mid_queue_keeps_durable_prefix(tmp_path, clip):
    root = str(tmp_path / "vss")
    # pinned to the local layout: the reopen below depends on objects
    # surviving the process "death"
    vss = VSS(root, backend="local")
    w = _writer(vss, "cam", codec="tvc-ll", gop_frames=15)
    w.append(clip[:30])           # windows 1+2 submitted
    vss.ingest.barrier({"cam"})   # ...and durable+indexed
    vss.ingest.pause()
    w.append(clip[30:])           # windows 3+4 queued-but-unpublished
    # crash hit mid-batch_put of window 3: one object landed, no rows
    queued = w._channel.pending[0]
    vss.backend.put(queued.items[0][0], queued.items[0][1])
    n_indexed = len(vss.catalog.all_gops())
    assert n_indexed == 2
    _simulate_crash(vss)

    vss2 = VSS(root, backend="local")  # scavenger + drop_empty_logicals
    try:
        assert vss2.recovery.orphans_removed == 1  # the half-window object
        assert vss2.recovery.gops_dropped == 0
        # no indexed-but-missing GOP: every surviving row has its object
        gops = vss2.catalog.all_gops()
        assert len(gops) == n_indexed
        assert all(vss2.backend.exists(g.path) for g in gops)
        # the reopened store reads exactly the durable prefix
        out = vss2.read("cam", cache=False).frames
        assert np.array_equal(out, clip[:30])
    finally:
        vss2.close()


def test_crash_before_first_publish_drops_the_logical(tmp_path, clip):
    """Every window still queued at the crash: the logical+physical rows
    were registered synchronously at first flush but nothing was ever
    indexed — recovery drops the empty video and frees the name."""
    root = str(tmp_path / "vss")
    vss = VSS(root)
    vss.ingest.pause()
    w = _writer(vss, "ghost", codec="tvc-ll", gop_frames=15)
    w.append(clip[:30])
    assert vss.catalog.logical_exists("ghost")
    assert not vss.catalog.all_gops()
    _simulate_crash(vss)

    vss2 = VSS(root)
    try:
        assert not vss2.catalog.logical_exists("ghost")
        with pytest.raises(KeyError):
            vss2.read("ghost", cache=False)
        # the name is immediately reusable
        vss2.write("ghost", clip[:15], fps=30.0, codec="tvc-ll",
                   gop_frames=15)
        assert np.array_equal(
            vss2.read("ghost", cache=False).frames, clip[:15]
        )
    finally:
        vss2.close()


def test_clean_close_drains_the_queue(tmp_path, clip):
    """VSS.close() lands every queued window before the clean-shutdown
    marker: a reopened store sees the full video, no scavenge needed."""
    root = str(tmp_path / "vss")
    vss = VSS(root, backend="local")  # persistence-dependent reopen below
    w = _writer(vss, "v", codec="tvc-ll", gop_frames=15, batch_gops=2)
    w.append(clip)
    w.close()
    vss.close()
    vss2 = VSS(root, backend="local")
    try:
        assert vss2.recovery.clean
        assert np.array_equal(vss2.read("v", cache=False).frames, clip)
    finally:
        vss2.close()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _objects(root):
    base = os.path.join(root, "objects")
    out = {}
    for d, _dirs, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), base)] = fh.read()
    return out


def _gop_rows(vss):
    return sorted((g.path, g.start_frame, g.num_frames, g.nbytes)
                  for g in vss.catalog.all_gops())


@pytest.mark.parametrize("workers,batch_gops", [(0, 1), (1, 2), (3, 1)])
def test_pipelined_ingest_matches_reference(tmp_path, clip, workers,
                                            batch_gops):
    """Two streams through each package's pipeline: the same counters,
    catalog rows, objects and frames."""
    seen = []
    for make, config, spec, name in (
            (JVSS, JConfig, JWriteSpec, "j"),
            (VSS, VSSConfig, WriteSpec, "t")):
        root = str(tmp_path / name)
        vss = make(root, config=config(backend="local", ingest=dataclasses
                                       .replace(config().ingest,
                                                workers=workers)))
        try:
            for cam, codec in (("a", "tvc-ll"), ("b", "tvc-med")):
                w = vss.writer_spec(spec(name=cam, fps=30.0, codec=codec,
                                         gop_frames=15),
                                    batch_gops=batch_gops)
                for off in range(0, clip.shape[0], 20):
                    w.append(clip[off:off + 20])
                w.close()
            st = vss.ingest.stats()
            seen.append((
                (st.windows_submitted, st.windows_published,
                 st.gops_submitted, st.gops_published, st.bytes_published,
                 st.errors, st.queued_gops),
                _gop_rows(vss),
                [vss.read(cam, cache=False).frames for cam in "ab"]))
        finally:
            vss.close()
        seen[-1] += (_objects(root),)
    (sj, rj, fj, oj), (st_, rt, ft, ot) = seen
    assert st_ == sj and rt == rj and ot == oj
    for a, b in zip(fj, ft):
        assert np.array_equal(a, b)


def test_crash_recovery_matches_reference(tmp_path, clip):
    """The same crash in both packages (two windows durable, two queued,
    half of the third's objects landed) recovers alike, and either
    package reopens the other's crashed store."""
    reports, rows = [], []
    for make, config, spec, name in (
            (JVSS, JConfig, JWriteSpec, "j"),
            (VSS, VSSConfig, WriteSpec, "t")):
        root = str(tmp_path / name)
        vss = make(root, config=config(backend="local"))
        w = vss.writer_spec(spec(name="cam", fps=30.0, codec="tvc-ll",
                                 gop_frames=15))
        w.append(clip[:30])
        vss.ingest.barrier({"cam"})
        vss.ingest.pause()
        w.append(clip[30:])
        queued = w._channel.pending[0]
        vss.backend.put(queued.items[0][0], queued.items[0][1])
        _simulate_crash(vss)
    for make, config, name in ((VSS, VSSConfig, "j"), (JVSS, JConfig, "t")):
        vss = make(str(tmp_path / name), config=config(backend="local"))
        try:
            rep = vss.recovery
            reports.append((rep.temps_removed, rep.orphans_removed,
                            rep.gops_dropped, rep.gops_repaired))
            rows.append(_gop_rows(vss))
            assert np.array_equal(vss.read("cam", cache=False).frames,
                                  clip[:30])
        finally:
            vss.close()
    assert reports[1] == reports[0] == (0, 1, 0, 0)
    assert rows[1] == rows[0]
