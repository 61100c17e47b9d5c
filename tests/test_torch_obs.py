"""Telemetry correctness and cost: `repro_torch.obs` registry math, trace
span trees, exact read-path counter accounting, exposition endpoints,
and the disabled-registry overhead guard."""

import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core.spec import ReadSpec
from repro_torch.obs import (
    LATENCY_BUCKETS,
    MetricsRegistry,
    Span,
    Tracer,
    instrument_backend,
)
from repro_torch.obs.registry import NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM
from repro_torch.storage import FaultInjectingBackend, MemoryBackend, TieredBackend
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

_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    rf"(\{{{_LABEL}(,{_LABEL})*\}})?"
    r" (\+Inf|-Inf|NaN|[-+0-9.eE]+)$"
)


# ---------------------------------------------------------------------------
# registry math
# ---------------------------------------------------------------------------

def test_counter_and_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("t_total", "help")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = reg.gauge("t_gauge")
    g.set(7)
    g.inc(2)
    g.dec(4)
    assert g.value == 5.0
    assert reg.value("t_total") == 3.5
    assert reg.value("t_gauge") == 5.0
    assert reg.value("never_registered") == 0.0


def test_histogram_bucket_math():
    """Observations land in the bucket whose edge is the first >= v
    (bisect_left: an exact-edge sample belongs to that edge's bucket),
    overflow goes to +Inf, and sum/count are exact."""
    reg = MetricsRegistry()
    h = reg.histogram("t_h", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.0, 1.5, 3.0, 8.0, 100.0):
        h.observe(v)
    #            <=1   <=2   <=4   <=8   +Inf
    assert h.counts == [2, 1, 1, 1, 1]
    assert h.count == 6
    assert h.sum == pytest.approx(0.5 + 1.0 + 1.5 + 3.0 + 8.0 + 100.0)
    counts, s, c = reg.histogram_values("t_h")
    assert counts == [2, 1, 1, 1, 1] and c == 6
    assert s == pytest.approx(h.sum)


def test_histogram_percentiles_bucket_bounded():
    """Interpolated quantiles are exact to within one bucket's width
    and clamped by the observed min/max."""
    reg = MetricsRegistry()
    h = reg.histogram("t_p", buckets=LATENCY_BUCKETS)
    samples = [i / 1000.0 for i in range(1, 101)]  # 1ms .. 100ms
    for v in samples:
        h.observe(v)
    p50, p99 = h.percentile(0.5), h.percentile(0.99)
    # true p50 = 50ms sits in the (25ms, 50ms] bucket; p99 = 99ms in
    # the (50ms, 100ms] bucket
    assert 0.025 <= p50 <= 0.0501
    assert 0.05 <= p99 <= 0.1
    assert h.percentile(0.0) >= min(samples) - 1e-12
    assert h.percentile(1.0) <= max(samples) + 1e-12
    empty = reg.histogram("t_p_empty", buckets=(1.0,))
    assert empty.percentile(0.5) == 0.0
    with pytest.raises(ValueError):
        h.percentile(1.5)


def test_concurrent_increments_exact():
    """8 threads x 10k increments on shared handles lose nothing —
    the lock-striped counters and histogram totals are exact."""
    reg = MetricsRegistry()
    c = reg.counter("t_c_total")
    h = reg.histogram("t_c_h", buckets=(0.5,))
    n_threads, n_iter = 8, 10_000

    def work():
        for _ in range(n_iter):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * n_iter
    assert h.count == n_threads * n_iter
    assert h.counts == [0, n_threads * n_iter]


def test_multi_handle_series_sum():
    """Two components registering the same (name, labels) keep exact
    per-instance handles while the series reports their sum — the
    per-instance `stats()` / process-wide /metrics contract."""
    reg = MetricsRegistry()
    a = reg.counter("t_shared_total", labels={"kind": "memory"})
    b = reg.counter("t_shared_total", labels={"kind": "memory"})
    other = reg.counter("t_shared_total", labels={"kind": "remote"})
    a.inc(3)
    b.inc(4)
    other.inc(10)
    assert a.value == 3 and b.value == 4
    assert reg.value("t_shared_total", {"kind": "memory"}) == 7
    assert reg.value("t_shared_total", {"kind": "remote"}) == 10


def test_gauge_fn_weakref_drops_dead_component():
    """Callback gauges on bound methods are weakly held: a collected
    component stops contributing instead of pinning itself alive or
    poisoning the scrape."""
    reg = MetricsRegistry()

    class Component:
        def depth(self):
            return 42.0

    comp = Component()
    reg.gauge_fn("t_depth", comp.depth)
    assert reg.value("t_depth") == 42.0
    del comp
    import gc

    gc.collect()
    assert reg.value("t_depth") == 0.0
    # a raising callback is skipped, not propagated
    reg.gauge_fn("t_bad", lambda: 1 / 0)
    assert reg.value("t_bad") == 0.0
    assert "t_bad" in reg.render_prometheus()


def test_type_and_bucket_conflicts_rejected():
    reg = MetricsRegistry()
    reg.counter("t_conflict")
    with pytest.raises(ValueError):
        reg.gauge("t_conflict")
    reg.histogram("t_hist", buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.histogram("t_hist", buckets=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError):
        reg.histogram("t_unsorted", buckets=(2.0, 1.0))


def test_prometheus_render_parses():
    """Every rendered sample line matches the text-format grammar;
    histogram buckets are cumulative and end at +Inf; label values are
    escaped."""
    reg = MetricsRegistry()
    reg.counter("t_r_total", "a counter", {"kind": 'we"ird\\path\n'}).inc(2)
    reg.gauge("t_r_gauge", "a gauge").set(1.5)
    h = reg.histogram("t_r_h", "a histogram", buckets=(1.0, 2.0))
    h.observe(0.5)
    h.observe(1.5)
    h.observe(9.0)
    text = reg.render_prometheus()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert SAMPLE_RE.match(line), f"unparseable: {line!r}"
    assert 't_r_h_bucket{le="1"} 1' in text
    assert 't_r_h_bucket{le="2"} 2' in text
    assert 't_r_h_bucket{le="+Inf"} 3' in text
    assert "t_r_h_count 3" in text
    assert '\\"' in text and "\\\\" in text and "\\n" in text
    # snapshot/json agree with the text form
    snap = reg.snapshot()
    assert snap["t_r_h"]["series"][0]["count"] == 3
    json.loads(reg.render_json())


# ---------------------------------------------------------------------------
# disabled registry: null handles, no wrapper, bounded overhead
# ---------------------------------------------------------------------------

def test_disabled_registry_hands_out_null_handles():
    reg = MetricsRegistry(enabled=False)
    assert reg.counter("x_total") is NULL_COUNTER
    assert reg.gauge("x_g") is NULL_GAUGE
    assert reg.histogram("x_h") is NULL_HISTOGRAM
    reg.gauge_fn("x_fn", lambda: 1.0)  # no-op, nothing registered
    NULL_COUNTER.inc()
    NULL_GAUGE.set(5)
    NULL_HISTOGRAM.observe(1.0)
    assert reg.value("x_total") == 0.0
    assert reg.render_prometheus() == "\n"
    # instrument_backend returns the inner backend itself: zero wrapper
    # frames on the disabled hot path
    mb = MemoryBackend()
    assert instrument_backend(mb, registry=reg) is mb


def test_disabled_registry_overhead_guard():
    """A disabled registry adds <5% to a memory-backend microloop.
    Structurally it adds *nothing* — the instrumented handle IS the
    bare backend — so the timing check pins the contract the structural
    identity implies."""
    import time as _time

    payload = b"x" * 4096
    raw = MemoryBackend()
    instr = instrument_backend(MemoryBackend(),
                               registry=MetricsRegistry(enabled=False))
    assert type(instr) is MemoryBackend

    def microloop(b, n=3000):
        t0 = _time.perf_counter()
        for i in range(n):
            k = f"k{i & 63}"
            b.put(k, payload)
            b.get(k)
        return _time.perf_counter() - t0

    microloop(raw, 200)  # warm both paths
    microloop(instr, 200)
    best_raw = min(microloop(raw) for _ in range(5))
    best_instr = min(microloop(instr) for _ in range(5))
    assert best_instr <= best_raw * 1.05, (
        f"disabled telemetry cost {best_instr / best_raw - 1:.1%}"
        " on the memory microloop (budget: 5%)"
    )


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_tracer_ring_and_span_tree():
    tr = Tracer(capacity=3)
    with tr.span("root", spec="v") as root:
        with tr.span("child", parent=root, n=1):
            pass
    got = tr.recent()
    assert len(got) == 1
    assert got[0]["name"] == "root" and got[0]["attrs"] == {"spec": "v"}
    assert got[0]["children"][0]["name"] == "child"
    assert got[0]["dur_s"] >= got[0]["children"][0]["dur_s"] >= 0.0
    for i in range(5):  # ring keeps the newest `capacity` roots
        tr.record(Span(f"r{i}").finish())
    names = [d["name"] for d in tr.recent()]
    assert names == ["r2", "r3", "r4"]
    assert [d["name"] for d in tr.recent(2)] == ["r3", "r4"]
    lines = tr.export_jsonl().splitlines()
    assert [json.loads(ln)["name"] for ln in lines] == names
    tr.clear()
    assert tr.recent() == []
    off = Tracer(enabled=False)
    with off.span("ignored"):
        pass
    assert off.recent() == []


# ---------------------------------------------------------------------------
# layer counters: fault wrapper, tiered cache
# ---------------------------------------------------------------------------

def test_fault_counters_live_on_registry():
    reg = MetricsRegistry()
    b = FaultInjectingBackend(MemoryBackend(), registry=reg)
    b.put("k", b"v")
    assert b.get("k") == b"v"
    b.fail_next(1)
    with pytest.raises(Exception):
        b.get("k")
    assert b.injected_errors == 1  # legacy view ...
    assert reg.value("vss_fault_injected_total", {"fault": "error"}) == 1
    assert b.ops == reg.value("vss_fault_ops_total") == 3


def test_tiered_cache_counters_and_gauges():
    reg = MetricsRegistry()
    cold = MemoryBackend()
    t = TieredBackend(cold, hot_bytes=1 << 20, registry=reg)
    t.put("hot", b"a" * 100)
    t.get("hot")  # served from the hot tier
    cold.put("cold-only", b"b" * 100)  # behind the cache's back
    t.get("cold-only")  # miss -> cold fetch
    assert reg.value("vss_cache_hits_total") == 1
    assert reg.value("vss_cache_misses_total") == 1
    assert reg.value("vss_cache_hot_bytes") > 0
    assert reg.value("vss_cache_hot_objects") >= 1


# ---------------------------------------------------------------------------
# read-path accounting: exact counters, trace trees, cross-layer match
# ---------------------------------------------------------------------------

@pytest.fixture()
def traced_vss(tmp_path, clip):
    reg = MetricsRegistry()
    store = VSS(str(tmp_path / "vss"), backend="memory", registry=reg,
                enable_deferred=False, enable_compaction=False)
    store.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=5)
    yield store, reg
    store.close()


def test_read_batch_exact_counters_and_spans(traced_vss):
    """N specs -> one plan group -> M deduped fetches -> M decodes,
    with every count cross-checked three ways: the VSS planner
    counters, the per-spec trace spans, and the instrumented backend's
    own byte histograms all agree."""
    store, reg = traced_vss
    specs = [
        ReadSpec(name="v", t=(0.0, 1.5), cache=False),
        ReadSpec(name="v", t=(0.5, 2.0), cache=False),
        ReadSpec(name="v", t=(1.0, 2.0), cache=False),
        ReadSpec(name="v", t=(0.0, 1.5), cache=False),  # exact duplicate
    ]
    out = store.read_batch(specs)
    assert len(out) == 4
    st = store.stats("v")
    assert st.specs_read == 4
    assert st.plan_groups == 1          # one (video, view-config) group
    assert st.specs_coalesced == 3      # three rode the first's plan
    # the union of (0,2.0)s at 5-frame GOPs/30fps is 12 objects, each
    # fetched once and decoded once
    assert st.objects_fetched == 12
    assert st.gops_decoded == 12
    assert st.predicted_io_seconds > 0.0
    assert st.actual_io_seconds > 0.0

    roots = store.recent_traces()
    assert len(roots) == 4
    for root in roots:
        assert root["name"] == "read" and root["attrs"]["spec"] == "v"
        assert [c["name"] for c in root["children"]][0] == "plan"
    fetch_spans = [c for r in roots for c in r["children"]
                   if c["name"] == "fetch"]
    decode_spans = [c for r in roots for c in r["children"]
                    if c["name"] == "decode"]
    assert len(decode_spans) == 4
    assert sum(1 for d in decode_spans if d["attrs"].get("shared")) == 1
    assert reg.value("vss_read_duplicate_specs_shared_total") == 1
    # span-level attribution reconciles exactly with the counters
    assert sum(s["attrs"]["objects"] for s in fetch_spans) == 12
    assert sum(s["attrs"]["bytes"] for s in fetch_spans) == st.fetch_bytes
    planned = sum(s["attrs"]["planned"] for s in fetch_spans)
    dedup = sum(s["attrs"]["dedup_hits"] for s in fetch_spans)
    assert planned - dedup == 12
    assert st.gop_fetches_deduped == dedup > 0
    # ... and with the instrumented backend layer: the read path's
    # fetch bytes are exactly what the memory backend served
    counts, nbytes, nobs = reg.histogram_values(
        "vss_backend_op_bytes", {"kind": "memory", "op": "batch_get"})
    assert nobs == 12
    assert int(nbytes) == st.fetch_bytes
    assert reg.value(
        "vss_backend_ops_total", {"kind": "memory", "op": "batch_get"}) == 1


def test_single_read_streams_but_still_counts(traced_vss):
    """The single-spec read() path retains nothing (streaming _BatchIO)
    yet its fetch/decode telemetry and trace root still land."""
    store, reg = traced_vss
    store.read("v", t=(0.0, 0.5), cache=False)
    st = store.stats("v")
    assert st.specs_read == 1
    assert st.objects_fetched == 3      # (0,0.5)s = frames 0..15 -> 3 GOPs
    assert st.gops_decoded == 3
    roots = store.recent_traces()
    assert len(roots) == 1
    names = [c["name"] for c in roots[0]["children"]]
    assert names[0] == "plan" and "decode" in names
    fetch = [c for c in roots[0]["children"] if c["name"] == "fetch"]
    assert fetch and fetch[0]["attrs"]["inline"] is True
    assert fetch[0]["attrs"]["objects"] == 3


def test_trace_ring_is_bounded(tmp_path, clip):
    store = VSS(str(tmp_path / "vss"), backend="memory",
                registry=MetricsRegistry(), trace_capacity=4,
                enable_deferred=False, enable_compaction=False)
    try:
        store.write("v", clip[:20], fps=30.0, codec="tvc-hi", gop_frames=5)
        for _ in range(7):
            store.read("v", t=(0.0, 0.3), cache=False)
        assert len(store.recent_traces()) == 4
    finally:
        store.close()


def test_ingest_stats_view_matches_registry(traced_vss):
    """IngestPipeline.stats() is a thin view over the same registry
    handles /metrics reads — one source of truth."""
    store, reg = traced_vss
    st = store.stats("v").ingest
    assert st is not None and st.gops_published == 12
    assert reg.value("vss_ingest_gops_published_total") == st.gops_published
    assert reg.value("vss_ingest_windows_published_total") == (
        st.windows_published
    )
    assert reg.value("vss_ingest_bytes_published_total") == (
        st.bytes_published
    )
    assert reg.value("vss_ingest_queued_gops") == 0  # drained gauge_fn


def test_stats_is_mapping_compatible(traced_vss):
    store, _ = traced_vss
    st = store.stats("v")
    assert st["gops"] == st.gops == 12
    assert st["physical_videos"] == 1
    assert st["bytes"] > 0 and st["budget"] > 0
    assert set(dict(st)) == {f for f in st}
    with pytest.raises(KeyError):
        st["nope"]


# ---------------------------------------------------------------------------
# exposition: /metrics + /healthz over HTTP, offline dump
# ---------------------------------------------------------------------------

def test_metrics_and_healthz_endpoints(tmp_path, clip):
    store = VSS(str(tmp_path / "vss"), backend="memory",
                registry=MetricsRegistry(),
                enable_deferred=False, enable_compaction=False)
    store.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=5)
    store.read("v", t=(0.0, 0.5), cache=False)
    srv = store.start_metrics_server()
    assert store.start_metrics_server() is srv  # idempotent
    with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as resp:
        assert resp.status == 200
        assert "text/plain" in resp.headers["Content-Type"]
        body = resp.read().decode()
    for line in body.splitlines():
        if line and not line.startswith("#"):
            assert SAMPLE_RE.match(line), f"unparseable: {line!r}"
    for family in ("vss_backend_ops_total", "vss_backend_op_seconds",
                   "vss_read_specs_total", "vss_ingest_gops_published_total"):
        assert f"# TYPE {family}" in body
    with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as resp:
        assert resp.status == 200
        health = json.loads(resp.read())
    assert health["status"] == "ok"
    assert health["backend"]["ok"] is True
    assert health["ingest"]["started"] is True
    assert health["scrub"]["startup_recovery_clean"] is True
    # the metrics-only server has no object plane behind it
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(srv.url + "/o/some-key", timeout=10)
    assert exc_info.value.code == 503
    # offline snapshot CLI scrapes the same pair
    from repro_torch.obs import dump

    assert dump.main(["--url", srv.url, "--format", "prom"]) == 0
    store.close()  # closing the store tears the server down
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(srv.url + "/metrics", timeout=2)


def test_healthz_degraded_on_backend_failure(tmp_path):
    store = VSS(str(tmp_path / "vss"), backend="memory",
                registry=MetricsRegistry())
    try:
        def broken(key):
            raise RuntimeError("disk on fire")

        store.backend.exists = broken
        report = store.health()
        assert report["status"] == "degraded"
        assert report["backend"]["ok"] is False
        assert "disk on fire" in report["backend"]["error"]
        srv = store.start_metrics_server()
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert exc_info.value.code == 503
        assert json.loads(exc_info.value.read())["status"] == "degraded"
    finally:
        store.close()


def test_traces_empty_and_views_zero_when_disabled(tmp_path):
    """A store on a disabled registry runs the zero-telemetry path:
    no wrapper backend, no spans, registry-backed stats read zero —
    and reads still work."""
    reg = MetricsRegistry(enabled=False)
    store = VSS(str(tmp_path / "vss"), backend="memory", registry=reg,
                enable_deferred=False, enable_compaction=False)
    try:
        assert type(store.backend) is MemoryBackend
        rng = np.random.RandomState(0)
        clip = rng.randint(0, 255, (20, 48, 64, 3), np.uint8)
        store.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=5)
        out = store.read("v", cache=False)
        assert out.frames.shape == clip.shape
        assert store.recent_traces() == []
        st = store.stats("v")
        assert st.gops == 4             # catalog facts still real
        assert st.specs_read == 0       # registry-backed fields read 0
        assert st.fetch_bytes == 0
    finally:
        store.close()


# ---------------------------------------------------------------------------
# the port against the reference: one /metrics vocabulary
# ---------------------------------------------------------------------------

def _scrape(url):
    """{(family, type)}, {(sample name, label names)} and every sample's
    value, from a live ``/metrics``."""
    with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
        body = resp.read().decode()
    types, series, values = set(), set(), {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types.add((name, kind))
        elif line and not line.startswith("#"):
            m = SAMPLE_RE.match(line)
            assert m, line
            head, value = line.rsplit(" ", 1)
            name, _, labels = head.partition("{")
            names = tuple(sorted(re.findall(r'(\w+)="', labels)))
            series.add((name, names))
            values[head] = float(value)
    return types, series, values


def _metrics_workload(vss, clip, spec_cls):
    vss.write("v", clip, fps=30.0, codec="tvc-hi", gop_frames=15)
    vss.read("v", t=(0.0, 0.5), cache=False)
    vss.read_batch([spec_cls(name="v", t=(0.0, 1.0), cache=False),
                    spec_cls(name="v", t=(0.5, 1.5), codec="rgb")])
    vss.read("v", codec="h264", cache=False)
    vss.backend.flush()


# counters that count what the caller asked for; the rest (seconds,
# bytes of timing-dependent flush batches, retries, hedges) may differ
# from run to run of either package
_OP_COUNTERS = re.compile(
    r"^(vss_backend_ops_total|vss_read_specs_total"
    r"|vss_read_plan_groups_total|vss_read_objects_fetched_total"
    r"|vss_read_gops_decoded_total|vss_read_gop_fetches_deduped_total"
    r"|vss_read_duplicate_specs_shared_total|vss_read_specs_coalesced_total"
    r"|vss_read_fetch_bytes_total|vss_read_ranged_fetches_total"
    r"|vss_ingest_gops_submitted_total|vss_ingest_gops_published_total"
    r"|vss_ingest_windows_submitted_total|vss_ingest_windows_published_total"
    r"|vss_ingest_bytes_published_total|vss_cache_hits_total"
    r"|vss_cache_misses_total|vss_cache_writeback_flushes_total)\b")


_FLUSHER_UPLOADS = re.compile(r'kind="remote",op="(batch_)?put"')


def test_metrics_families_match_reference(tmp_path, clip):
    """Both packages, driven through the same operations on a
    ``tiered:remote`` store, expose the same metric families with the
    same types and label sets, and equal values for every counter that
    counts operations."""
    from repro.core.config import IngestConfig as JIngest
    from repro.core.config import VSSConfig as JConfig
    from repro.core.spec import ReadSpec as JReadSpec
    from repro.core.store import VSS as JVSS
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.core.config import IngestConfig

    j = JVSS(str(tmp_path / "j"), config=JConfig(
        backend="tiered:remote", registry=JRegistry(),
        ingest=JIngest(workers=1)))
    t = VSS(str(tmp_path / "t"), config=VSSConfig(
        backend="tiered:remote", registry=MetricsRegistry(),
        ingest=IngestConfig(workers=1)))
    try:
        got = []
        for vss, spec_cls in ((j, JReadSpec), (t, ReadSpec)):
            _metrics_workload(vss, clip, spec_cls)
            got.append(_scrape(vss.start_metrics_server().url))
        (jt, js, jv), (tt, ts, tv) = got
        assert tt == jt
        assert ts == js
        for family in ("vss_backend_ops_total", "vss_cache_spills_total",
                       "vss_journal_appends_total",
                       "vss_remote_connections_created_total"):
            assert any(name == family for name, _ in jt), family
        # the write-back flusher groups its uploads as it finds them
        # dirty, so the remote tier's put / batch_put split is timing's
        ops = {k: v for k, v in jv.items() if _OP_COUNTERS.match(k)
               and not _FLUSHER_UPLOADS.search(k)}
        assert len(ops) > 10
        assert {k: tv.get(k) for k in ops} == ops
    finally:
        j.close()
        t.close()
