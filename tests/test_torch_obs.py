"""Telemetry correctness and cost: `repro_torch.obs` registry math, trace
span trees, exact read-path counter accounting, exposition endpoints,
and the disabled-registry overhead guard."""

import dataclasses
import json
import re
import threading
import time
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


# ---------------------------------------------------------------------------
# the checks of scripts/metrics_smoke.py on the port
# ---------------------------------------------------------------------------

def _reference_smoke_families():
    """`REQUIRED_FAMILIES` of the reference's metrics smoke script."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" \
        / "metrics_smoke.py"
    spec = importlib.util.spec_from_file_location("_metrics_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REQUIRED_FAMILIES


def test_metrics_smoke_workload_on_the_port(tmp_path):
    """The mixed workload of ``scripts/metrics_smoke.py`` on a port store
    on ``tiered:remote``: pipelined ingest of two streams, an edge trim,
    a tiled ROI read, a coalescing batch, one injected fault absorbed by
    a retry, one signed and one refused request, an adaptive tick and a
    scrub.  ``/metrics`` must expose every family the script requires,
    in Prometheus text, and the reads must leave span trees."""
    from repro_torch.core.config import AdaptiveConfig
    from repro_torch.core.spec import WriteSpec
    from repro_torch.storage import (
        ObjectServer,
        RemoteAuthError,
        RemoteBackend,
        unwrap,
    )

    reg = MetricsRegistry(enabled=True)
    vss = VSS(str(tmp_path / "vss"), config=VSSConfig(
        backend="tiered:remote", registry=reg,
        adaptive=AdaptiveConfig(enabled=True)))
    try:
        rng = np.random.RandomState(7)
        for name in ("cam0", "cam1"):
            w = vss.writer(name, fps=30.0, gop_frames=10)
            for _ in range(3):
                w.append(rng.randint(0, 255, (20, 48, 64, 3), np.uint8))
            w.close()
        vss.read("cam0", t=(0.0, 1.0), cache=False)
        vss.read("cam0", t=(0.0, 0.1), cache=False)
        wt = vss.writer_spec(WriteSpec(name="cam2", fps=30.0, gop_frames=10,
                                       tiles=(2, 2)))
        wt.append(rng.randint(0, 255, (20, 48, 64, 3), np.uint8))
        wt.close()
        vss.read("cam2", t=(0.0, 0.5), roi=(0, 0, 24, 16), cache=False)
        assert reg.value("vss_read_ranged_fetches_total") >= 1
        assert reg.value("vss_tile_fetches_total") >= 1
        vss.read_batch([
            ReadSpec(name="cam0", t=(0.0, 1.5), cache=False),
            ReadSpec(name="cam1", t=(0.5, 2.0), cache=False),
            ReadSpec(name="cam0", t=(0.0, 1.5), cache=False),
        ])
        remote = unwrap(vss.backend, RemoteBackend)
        server = remote._server
        flaky = FaultInjectingBackend(server.store, registry=reg)
        server._httpd.store = flaky
        remote.put("smoke-probe", b"metrics smoke payload")
        flaky.fail_next(1)
        assert remote.get("smoke-probe") == b"metrics smoke payload"
        assert remote.retries >= 1
        assert reg.value("vss_journal_appends_total") >= 1
        assert reg.value("vss_journal_fsyncs_total") >= 1
        secret = b"metrics-smoke-secret"
        auth_server = ObjectServer(MemoryBackend(), secret=secret,
                                   registry=reg)
        signed = RemoteBackend(auth_server.url, secret=secret,
                               backoff_base=0.01)
        anon = RemoteBackend(auth_server.url, backoff_base=0.01)
        try:
            signed.put("k", b"authenticated")
            assert signed.get("k") == b"authenticated"
            with pytest.raises(RemoteAuthError):
                anon.get("k")
            assert anon.retries == 0
        finally:
            signed.close()
            anon.close()
            auth_server.close()
        for _ in range(3):
            vss.read("cam0", t=(0.0, 1.0), resolution=(32, 24), cache=False)
        report = vss.adapt()
        assert reg.value("vss_profiler_records_total") >= 5
        assert reg.value("vss_adapt_runs_total") >= 1
        assert "materialized" in report
        vss.scrub()
        srv = vss.start_metrics_server()
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers.get("Content-Type", "")
            body = r.read().decode()
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["backend"]["ok"] and health["ingest"]["started"]
        samples = [ln for ln in body.splitlines()
                   if ln and not ln.startswith("#")]
        assert all(SAMPLE_RE.match(ln) for ln in samples)
        assert len(samples) > 50
        families = {ln.split()[2] for ln in body.splitlines()
                    if ln.startswith("# TYPE")}
        missing = [f for f in _reference_smoke_families()
                   if f not in families]
        assert not missing, missing
        spans = {c["name"] for t in vss.recent_traces()
                 for c in t.get("children", [])}
        assert {"plan", "decode"} <= spans
    finally:
        vss.close()


# ---------------------------------------------------------------------------
# spans on the profiler's clock: `repro_torch.obs.span` mirrored as ranges
# ---------------------------------------------------------------------------

# names the benchmark's own ranges use; the program's never reuse them
BENCHMARK_LABELS = {"vss.read", "vss.append", "vss.close", "vss.encode_gop",
                    "vss.decode_gop"}


def _coder():
    from repro_torch.codec import tvc

    return "zlib" if tvc.zstandard is None else "zstd"


def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler`` session over every
    thread; return the ``vss.*`` host ranges as (name, thread, start,
    end)."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        fn()
    return [(e.name(), e.start_thread_id(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("vss.")]


def _write_then_read_half_size(store, clip):
    """A pipelined write, then a half-size read twice: the first decodes
    and admits the view, the second is served from it."""
    w = store.writer("v", fps=30.0, codec="tvc-med", gop_frames=5)
    w.append(clip[:20])
    w.close()
    h, w_ = clip.shape[1:3]
    for _ in range(2):
        out = store.read("v", t=(0.0, 0.5), resolution=(w_ // 2, h // 2),
                         cache=True)
        assert out.frames.shape == (15, h // 2, w_ // 2, 3)
    # an hevc view of the same seconds: decoded and encoded again
    store.read("v", t=(0.0, 0.5), codec="hevc", cache=True)


def test_profiler_sees_every_span_on_its_own_thread(tmp_path, clip):
    store = VSS(str(tmp_path / "vss"), config=VSSConfig(
        backend="memory", registry=MetricsRegistry()))
    try:
        ranges = _profiled(lambda: _write_then_read_half_size(store, clip))
    finally:
        store.close()
    names = {n for n, *_ in ranges}
    coder = _coder()
    leaves = {
        "vss.store.plan", "vss.store.fetch", "vss.store.resample_box",
        "vss.store.admit_step_mse", "vss.store.admit_put",
        "vss.store.admit_catalog", "vss.store.evict", "vss.store.compact",
        "vss.codec.h2d", "vss.codec.d2h", f"vss.codec.deflate.{coder}",
        f"vss.codec.inflate.{coder}", "vss.ingest.publish",
        "vss.store.concat", "vss.writer.concat", "vss.codec.rgb_pack",
        "vss.codec.rgb_unpack",
    }
    phases = {"vss.store.read_batch", "vss.store.decode",
              "vss.writer.flush_gop"}
    assert leaves | phases <= names, sorted((leaves | phases) - names)
    for n in names:
        assert not n.startswith("vss.kernel.") and n not in BENCHMARK_LABELS
        assert n.count(".") >= 2  # vss.<layer>.<stage>
    # every codec range runs inside a decode, an admission step or a GOP
    # flush, on its own thread
    outer = [r for r in ranges if r[0] == "vss.store.decode"
             or r[0].startswith("vss.store.admit_")
             or r[0] == "vss.writer.flush_gop"]
    in_decode = 0
    for n, th, a, b in ranges:
        if not n.startswith("vss.codec."):
            continue
        hosts = [o for o in outer if o[1] == th and o[2] <= a and b <= o[3]]
        assert hosts, (n, th)
        in_decode += any(o[0] == "vss.store.decode" for o in hosts)
    assert in_decode > 0
    # the pipeline's worker publishes on a thread of its own
    writer = {th for n, th, *_ in ranges if n == "vss.writer.flush_gop"}
    workers = {th for n, th, *_ in ranges if n == "vss.ingest.publish"}
    assert workers and not workers & writer


def test_backpressure_span_only_while_the_writer_blocks(tmp_path, clip):
    from repro_torch.core.config import IngestConfig

    def run(queue_gops):
        store = VSS(str(tmp_path / f"q{queue_gops}"), config=VSSConfig(
            backend="memory", registry=MetricsRegistry(),
            ingest=IngestConfig(workers=1, queue_gops=queue_gops)))
        done = threading.Event()

        def write():
            w = store.writer("v", fps=30.0, codec="tvc-hi", gop_frames=5)
            w.append(clip[:10])  # two GOPs: the second waits on a full queue
            w.close()
            done.set()

        def body():
            store.ingest.pause()
            t = threading.Thread(target=write)
            t.start()
            for _ in range(2000):
                if store.ingest.stats().backpressure_waits or done.is_set():
                    break
                done.wait(0.005)
            store.ingest.resume()
            t.join(timeout=60)
            assert not t.is_alive() and done.is_set()

        try:
            ranges = _profiled(body)
            return ranges, store.ingest.stats().backpressure_waits
        finally:
            store.close()

    ranges, waits = run(queue_gops=1)
    assert waits == 1
    blocked = [r for r in ranges if r[0] == "vss.ingest.backpressure"]
    assert len(blocked) == 1
    assert blocked[0][1] in {th for n, th, *_ in ranges
                             if n == "vss.writer.flush_gop"}
    ranges, waits = run(queue_gops=64)
    assert waits == 0
    assert "vss.ingest.backpressure" not in {n for n, *_ in ranges}


def test_deferred_compression_spans_name_the_coder():
    from repro_torch.core import deferred

    data = bytes(range(256)) * 64
    coder = "zlib" if deferred.zstandard is None else "zstd"
    ranges = _profiled(
        lambda: deferred.unwrap_bytes(deferred.wrap_bytes(data, 3)))
    assert [n for n, *_ in ranges] == [f"vss.deferred.deflate.{coder}",
                                       f"vss.deferred.inflate.{coder}"]


def test_no_record_function_without_a_profiler(tmp_path, clip, monkeypatch):
    """Structural, no clock: with no profiler recording, a write and a
    read (trees on) never construct a profiler range."""
    import torch.autograd.profiler as autograd_profiler

    calls = []

    class Counting:
        def __init__(self, name, *args):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    store = VSS(str(tmp_path / "vss"), config=VSSConfig(
        backend="memory", registry=MetricsRegistry()))
    try:
        _write_then_read_half_size(store, clip)
        assert calls == []
        assert store.recent_traces()  # the trees were built all the same
        # the same path with the flag up does mirror: the stub is the one
        # the spans would call
        monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
        store.read("v", t=(0.0, 0.5), cache=False)
    finally:
        store.close()
    assert "vss.store.decode" in calls and "vss.store.fetch" in calls


def test_read_tree_grandchildren_are_measured(tmp_path, clip):
    """A half-size miss: the root keeps plan/fetch/decode/admit children;
    below decode and admit, each stage is a measured span, and they sum
    to at most their parent."""
    store = VSS(str(tmp_path / "vss"), config=VSSConfig(
        backend="memory", registry=MetricsRegistry()))
    try:
        _write_then_read_half_size(store, clip)
        roots = store.recent_traces()
    finally:
        store.close()
    assert len(roots) == 3
    miss = roots[0]
    assert {c["name"] for c in miss["children"]} == {
        "plan", "fetch", "decode", "admit"}
    below = {}
    for child in miss["children"]:
        kids = child.get("children", [])
        below[child["name"]] = {g["name"] for g in kids}
        assert sum(g["dur_s"] for g in kids) <= child["dur_s"]
        for g in kids:
            assert g["dur_s"] > 0.0
    coder = _coder()
    assert {"fetch", "h2d", "d2h", f"inflate.{coder}",
            "resample_box"} <= below["decode"]
    assert {"admit_step_mse", "admit_put", "admit_catalog"} <= below["admit"]
    # the inline fetch summary holds the round trips its decode made
    decode = next(c for c in miss["children"] if c["name"] == "decode")
    fetch = next(c for c in miss["children"] if c["name"] == "fetch")
    trips = [g for g in decode["children"] if g["name"] == "fetch"]
    assert fetch["attrs"]["inline"] is True
    assert fetch["dur_s"] >= sum(g["dur_s"] for g in trips) > 0.0
    # the hevc view: decoded, then encoded again, below its decode span
    hevc = next(c for c in roots[2]["children"] if c["name"] == "decode")
    assert {f"inflate.{coder}", f"deflate.{coder}", "h2d", "d2h"} <= {
        g["name"] for g in hevc["children"]}


def test_pooled_entropy_spans_stay_under_the_decode(tmp_path, clip):
    """Frames large enough for the codec's entropy pool: inside a read,
    every chunk's inflate and deflate node hangs under the read's decode
    node though a pool thread coded it; under a profiler their ranges
    keep their names and come from the pool's threads, never from the
    thread that decodes."""
    from repro_torch.codec import tvc
    from repro_torch.obs.registry import default_registry

    big = np.ascontiguousarray(np.tile(clip[:8], (1, 8, 10, 1)))
    assert big[0].nbytes >= tvc.POOL_MIN_CHUNK_BYTES
    store = VSS(str(tmp_path / "vss"), config=VSSConfig(
        backend="memory", registry=MetricsRegistry()))

    def pooled():
        return [default_registry().value(
            "vss_codec_entropy_gops_total", {"stage": s, "mode": "pool"})
            for s in ("inflate", "deflate")]

    try:
        w = store.writer("v", fps=30.0, codec="tvc-med", gop_frames=4)
        w.append(big)
        w.close()
        before = pooled()
        ranges = _profiled(lambda: store.read(
            "v", t=(0.0, 8 / 30), codec="hevc", cache=True))
        after = pooled()
        root = store.recent_traces()[-1]
    finally:
        store.close()
    assert all(a > b for a, b in zip(after, before)), (before, after)
    coder = _coder()
    entropy = {f"vss.codec.inflate.{coder}", f"vss.codec.deflate.{coder}"}
    # the tree: each chunk a node under the decode node
    decode = next(c for c in root["children"] if c["name"] == "decode")
    nodes = [g["name"] for g in decode["children"]]
    for name in entropy:
        stage = name.split(".", 2)[2]
        assert nodes.count(stage) >= 4 and nodes.count(stage) % 4 == 0, (
            stage, nodes)
    # the profiler: the same names, on threads other than the decode's
    decoding = {th for n, th, *_ in ranges if n == "vss.store.decode"}
    coders = {th for n, th, *_ in ranges if n in entropy}
    assert entropy <= {n for n, *_ in ranges}
    assert decoding and coders and not coders & decoding
    # a pooled chunk's range lies inside the decode's extent
    (a0, b0), = {(a, b) for n, _, a, b in ranges if n == "vss.store.decode"}
    assert all(a0 <= a and b <= b0 for n, _, a, b in ranges if n in entropy)


def test_a_timed_span_measures_with_no_tree_and_no_profiler(monkeypatch):
    """``timed=True`` (the store's fetch and plan seconds) measures the
    region even where no tree node is built and no profiler records, and
    still constructs no profiler range; untimed, such a span is the
    shared null context."""
    import torch.autograd.profiler as autograd_profiler

    from repro_torch.obs import span

    calls = []

    class Counting:
        def __init__(self, name, *args):
            calls.append(name)

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    timed = span("vss.store.fetch", parent=None, timed=True)
    with timed as node:
        time.sleep(0.002)
    assert node is None
    assert timed.seconds >= 0.002
    assert calls == []
    assert span("vss.store.fetch", parent=None) is span(
        "vss.store.plan", parent=None)
