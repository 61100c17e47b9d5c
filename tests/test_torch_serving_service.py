"""The HTTP serving tier: coalescing, QoS shedding, signed delivery,
manifest caching, and the /metrics + /healthz surface.

Each test runs a real `VSSService` on an ephemeral port and speaks
stdlib HTTP at it — the same wire a VDBMS client would use.

The reference's `tests/test_serving_service.py` on the port (a CPU store;
every client decodes segments with ``device="cpu"``), then the port's
service held against the reference's: the same segments and manifests
for the same requests, stores crossing packages, interchangeable signed
URLs, the same spec verdicts, metric families and admission decisions.
"""
import dataclasses
import json
import shutil
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from repro.core.config import VSSConfig as JConfig
from repro.core.store import VSS as JVSS
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.serving import qos as jqos
from repro.serving import service as jservice
from repro.serving import signing as jsigning
from repro_torch import codec
from repro_torch.core.config import VSSConfig
from repro_torch.core.store import VSS as _PortVSS
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving import qos as tqos
from repro_torch.serving import service as tservice
from repro_torch.serving import signing as tsigning
from repro_torch.serving.qos import (
    REASON_QUEUE_DEPTH,
    REASON_TENANT_RATE,
    AdmissionController,
    TokenBucket,
)
from repro_torch.serving.service import VSSService, spec_from_json
from repro_torch.serving.signing import UrlSigner


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


def _post(base, body, tenant="t0"):
    req = urllib.request.Request(
        base + "/v1/read", data=json.dumps(body).encode(),
        headers={"X-VSS-Tenant": tenant,
                 "Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture()
def served(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    service = VSSService(vss, window_s=0.01)
    yield service, vss
    service.close()


def _fetch_frames(base, manifest):
    segs = []
    for seg in manifest["segments"]:
        status, data, _ = _get(base, seg["url"])
        assert status == 200
        assert len(data) == seg["nbytes"]
        segs.append(data)
    return np.concatenate(
        [codec.decode_gop(codec.deserialize_gop(b), device="cpu")
         for b in segs], axis=0
    )


# ---------------------------------------------------------------------------
# control plane + data plane
# ---------------------------------------------------------------------------

def test_read_manifest_and_bit_exact_segments(served):
    service, vss = served
    status, manifest, _ = _post(
        service.url, {"name": "road", "t": [0.0, 1.0], "codec": "tvc-med"}
    )
    assert status == 200
    assert manifest["codec"] == "tvc-med"
    assert manifest["segments"], "manifest must carry segment URLs"
    got = _fetch_frames(service.url, manifest)
    ref = vss.read("road", t=(0.0, 1.0), codec="tvc-med").frames
    assert np.array_equal(got, ref)


def test_rgb_read_serves_segments(served):
    service, vss = served
    status, manifest, _ = _post(
        service.url, {"name": "road", "t": [0.0, 0.5], "codec": "rgb"}
    )
    assert status == 200
    got = _fetch_frames(service.url, manifest)
    assert np.array_equal(
        got, vss.read("road", t=(0.0, 0.5), codec="rgb").frames
    )


def test_concurrent_requests_coalesce_into_fewer_batches(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    reg = MetricsRegistry()
    service = VSSService(vss, window_s=0.25, registry=reg)
    try:
        n = 8
        results = [None] * n

        def worker(i):
            results[i] = _post(
                service.url,
                {"name": "road", "t": [0.0, 1.0], "codec": "tvc-med"},
            )

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and r[0] == 200 for r in results)
        batches = reg.value("vss_serve_batches_total")
        assert batches < n, f"no coalescing: {batches} batches for {n} reqs"
        # identical concurrent requests: every client got the same bytes
        first = _fetch_frames(service.url, results[0][1])
        ref = vss.read("road", t=(0.0, 1.0), codec="tvc-med").frames
        assert np.array_equal(first, ref)
    finally:
        service.close()


def test_bad_spec_400_unknown_video_404(served):
    service, _vss = served
    assert _post(service.url, {"name": "road", "t": [5, 1]})[0] == 400
    assert _post(service.url, {"name": "road", "bogus": 1})[0] == 400
    assert _post(service.url, {"name": "ghost"})[0] == 404
    assert _post(service.url, [1, 2, 3])[0] == 400


def test_one_bad_spec_does_not_poison_coalesced_batchmates(vss, clip):
    """An invalid-at-execution spec in a coalesced batch fails alone;
    its batchmates still answer 200 via per-request fallback."""
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    reg = MetricsRegistry()
    service = VSSService(vss, window_s=0.25, registry=reg)
    try:
        bodies = [
            {"name": "road", "t": [0.0, 1.0], "codec": "tvc-med"},
            # resolves past the stored interval -> ValueError at resolve
            {"name": "road", "t": [0.0, 10_000.0], "codec": "tvc-med"},
            {"name": "road", "t": [1.0, 2.0], "codec": "tvc-med"},
        ]
        results = [None] * len(bodies)

        def worker(i):
            results[i] = _post(service.url, bodies[i])

        threads = [
            threading.Thread(target=worker, args=(i,))
            for i in range(len(bodies))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        codes = [r[0] for r in results]
        assert codes[0] == 200 and codes[2] == 200
        assert codes[1] == 400
    finally:
        service.close()


# ---------------------------------------------------------------------------
# QoS: shedding + deadlines
# ---------------------------------------------------------------------------

def test_tenant_rate_shed_with_retry_after(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    reg = MetricsRegistry()
    service = VSSService(
        vss,
        admission=AdmissionController(
            tenant_rate=0.5, tenant_burst=2.0, registry=reg
        ),
        registry=reg,
    )
    try:
        body = {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med"}
        codes = [_post(service.url, body, tenant="greedy") for _ in range(4)]
        assert [c[0] for c in codes[:2]] == [200, 200]
        shed = codes[2]
        assert shed[0] == 503
        assert shed[2]["X-VSS-Shed-Reason"] == REASON_TENANT_RATE
        assert int(shed[2]["Retry-After"]) >= 1
        # another tenant's budget is untouched
        assert _post(service.url, body, tenant="polite")[0] == 200
        assert reg.value(
            "vss_serve_shed_total", {"reason": REASON_TENANT_RATE}
        ) >= 1
    finally:
        service.close()


def test_past_deadline_request_is_shed(served):
    service, _vss = served
    status, body, headers = _post(
        service.url,
        {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med",
         "deadline_ms": 0},
    )
    assert status == 503
    assert headers["X-VSS-Shed-Reason"] == "deadline"
    assert body["reason"] == "deadline"
    # a generous deadline sails through
    assert _post(
        service.url,
        {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med",
         "deadline_ms": 60_000},
    )[0] == 200


def test_admission_controller_queue_and_bytes_limits():
    reg = MetricsRegistry()
    ac = AdmissionController(
        queue_limit=2, inflight_bytes_limit=100, tenant_rate=1000.0,
        tenant_burst=1000.0, registry=reg,
    )
    assert ac.admit() is None
    assert ac.admit() is None
    denial = ac.admit()
    assert denial is not None and denial.reason == REASON_QUEUE_DEPTH
    ac.release()
    assert ac.admit() is None
    ac.release()
    ac.release()
    ac.hold_bytes(150)
    denial = ac.admit()
    assert denial is not None and denial.reason == "inflight-bytes"
    ac.drop_bytes(150)
    assert ac.admit() is None
    assert reg.value("vss_serve_queue_depth") == ac.in_flight


def test_token_bucket_refills():
    tb = TokenBucket(rate=100.0, burst=2.0)
    assert tb.try_acquire() is None
    assert tb.try_acquire() is None
    retry = tb.try_acquire()
    assert retry is not None and retry > 0
    time.sleep(retry + 0.05)
    assert tb.try_acquire() is None


# ---------------------------------------------------------------------------
# signed URLs
# ---------------------------------------------------------------------------

def test_signer_verify_reasons():
    s = UrlSigner(secret=b"k", ttl_s=10.0)
    url = s.sign("/v1/segment/abc/0", now=1000.0)
    path, _, query = url.partition("?")
    q = dict(p.split("=") for p in query.split("&"))
    assert s.verify(path, q["exp"], q["sig"], now=1005.0) is None
    assert s.verify(path, q["exp"], q["sig"], now=1011.0) == "expired"
    assert s.verify(path, q["exp"], "0" * 64, now=1005.0) == "bad-signature"
    assert s.verify(path, "soon", q["sig"]) == "bad-exp"
    assert s.verify("/v1/segment/abc/1", q["exp"], q["sig"],
                    now=1005.0) == "bad-signature"


def test_tampered_and_expired_segment_urls_rejected(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    service = VSSService(vss)
    try:
        status, manifest, _ = _post(
            service.url,
            {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med"},
        )
        assert status == 200
        url = manifest["segments"][0]["url"]
        assert _get(service.url, url)[0] == 200
        # tampered signature
        assert _get(service.url, url.replace("sig=", "sig=0"))[0] == 403
        # no signature at all
        assert _get(service.url, url.partition("?")[0])[0] == 403
        # a token whose (validly signed) expiry already passed
        path = url.partition("?")[0]
        stale = service.signer.sign(
            path, now=time.time() - service.signer.ttl_s - 60
        )
        assert _get(service.url, stale)[0] == 410
    finally:
        service.close()


# ---------------------------------------------------------------------------
# stored manifests + cache invalidation
# ---------------------------------------------------------------------------

def test_manifest_lists_gops_and_serves_signed_objects(served):
    service, vss = served
    status, body, _ = _get(service.url, "/v1/manifest/road")
    manifest = json.loads(body)
    assert status == 200
    assert manifest["name"] == "road"
    assert manifest["total_bytes"] > 0
    gops = [g for p in manifest["physicals"] for g in p["gops"]]
    assert gops
    status, data, _ = _get(service.url, gops[0]["url"])
    assert status == 200
    enc = codec.deserialize_gop(data)
    assert enc.nbytes == gops[0]["nbytes"] or len(data) > 0
    # unknown name
    assert _get(service.url, "/v1/manifest/ghost")[0] == 404


def test_manifest_cache_hit_then_write_invalidates(vss, clip):
    vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
    reg = MetricsRegistry()
    service = VSSService(vss, registry=reg)
    try:
        assert _get(service.url, "/v1/manifest/road")[0] == 200
        assert _get(service.url, "/v1/manifest/road")[0] == 200
        assert reg.value("vss_serve_manifest_cache_misses_total") == 1
        assert reg.value("vss_serve_manifest_cache_hits_total") == 1
        # a write to a DIFFERENT video leaves the entry alone
        vss.write("other", clip[:15], fps=30.0, codec="rgb")
        assert _get(service.url, "/v1/manifest/road")[0] == 200
        assert reg.value("vss_serve_manifest_cache_hits_total") == 2
        # dropping the video invalidates its entry and 404s afterwards
        vss.drop("road")
        assert reg.value("vss_serve_manifest_invalidations_total") >= 1
        assert _get(service.url, "/v1/manifest/road")[0] == 404
    finally:
        service.close()


def test_manifest_reflects_appends_after_invalidation(vss, clip):
    vss.write("road", clip[:30], fps=30.0, codec="tvc-med", gop_frames=15)
    service = VSSService(vss)
    try:
        first = json.loads(_get(service.url, "/v1/manifest/road")[1])
        n_before = sum(
            len(p["gops"]) for p in first["physicals"]
        )
        # stream more frames in: the writer close invalidates the entry
        vss.drop("road")
        vss.write("road", clip, fps=30.0, codec="tvc-med", gop_frames=15)
        second = json.loads(_get(service.url, "/v1/manifest/road")[1])
        n_after = sum(len(p["gops"]) for p in second["physicals"])
        assert n_after > n_before
    finally:
        service.close()


# ---------------------------------------------------------------------------
# observability surface
# ---------------------------------------------------------------------------

def test_metrics_healthz_and_videos(served):
    service, _vss = served
    assert _post(
        service.url, {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med"}
    )[0] == 200
    status, body, headers = _get(service.url, "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    for family in (
        "vss_serve_requests_total",
        "vss_serve_admitted_total",
        "vss_serve_batches_total",
        "vss_serve_coalesce_width",
        "vss_serve_ttfb_seconds",
        "vss_serve_e2e_seconds",
        "vss_serve_queue_depth",
        "vss_serve_tenant_tokens",
    ):
        assert family in text, f"missing metric family {family}"
    status, body, _ = _get(service.url, "/healthz")
    report = json.loads(body)
    assert status == 200 and report["status"] == "ok"
    assert report["serving"]["coalescer_alive"] is True
    status, body, _ = _get(service.url, "/v1/videos")
    assert status == 200 and json.loads(body) == ["road"]


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------

def test_spec_from_json():
    spec = spec_from_json({
        "name": "v", "t": [0, 2], "codec": "hevc", "priority": 3,
        "deadline_ms": 50,
    })
    assert spec.name == "v" and spec.t == (0.0, 2.0)
    assert spec.codec == "tvc-hi" and spec.priority == 3
    assert spec.deadline_ms == 50.0
    with pytest.raises(ValueError):
        spec_from_json({"name": "v", "unknown_knob": 1})
    with pytest.raises(ValueError):
        spec_from_json({})
    with pytest.raises(ValueError):
        spec_from_json("just a string")


def _get_range(base, path, rng):
    req = urllib.request.Request(base + path, headers={"Range": rng})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_signed_gop_fetch_honours_range(served):
    """A signed /v1/gop URL answers HTTP Range requests with 206 +
    Content-Range (416 when unsatisfiable) so sub-GOP clients can pull
    just the byte prefix their frame trim decodes."""
    service, vss = served
    status, body, _ = _get(service.url, "/v1/manifest/road")
    gops = [g for p in json.loads(body)["physicals"] for g in p["gops"]]
    url = gops[0]["url"]
    status, full, headers = _get(service.url, url)
    assert status == 200
    assert headers.get("Accept-Ranges") == "bytes"

    status, part, headers = _get_range(service.url, url, "bytes=0-99")
    assert status == 206
    assert part == full[:100]
    assert headers["Content-Range"] == f"bytes 0-99/{len(full)}"

    status, tail, headers = _get_range(service.url, url, "bytes=100-")
    assert status == 206
    assert tail == full[100:]

    status, _body, headers = _get_range(
        service.url, url, f"bytes={len(full)}-"
    )
    assert status == 416
    assert headers["Content-Range"] == f"bytes */{len(full)}"


def test_segment_fetch_honours_range(served):
    service, vss = served
    status, manifest, _ = _post(
        service.url, {"name": "road", "t": [0.0, 0.5], "codec": "tvc-med"}
    )
    assert status == 200
    seg = manifest["segments"][0]
    _status, full, _ = _get(service.url, seg["url"])
    status, part, headers = _get_range(service.url, seg["url"], "bytes=8-23")
    assert status == 206
    assert part == full[8:24]
    assert headers["Content-Range"] == f"bytes 8-23/{len(full)}"


# ---------------------------------------------------------------------------
# the store's device: a result without encoded GOPs is encoded there
# ---------------------------------------------------------------------------

def test_park_encodes_on_the_store_device(served, monkeypatch):
    """An rgb result reaches `park` without encoded GOPs, and is encoded
    there on the store's device: a CPU store never asks for CUDA."""
    service, vss = served
    seen = []
    real = codec.encode_gop

    def spy(frames, name, **kw):
        seen.append(kw.get("device"))
        return real(frames, name, **kw)

    # the service's own view of the codec: the store's calls go past it
    monkeypatch.setattr(tservice, "_codec", types.SimpleNamespace(
        **dict(vars(codec), encode_gop=spy)))
    status, manifest, _ = _post(
        service.url, {"name": "road", "t": [0.0, 1.0], "codec": "rgb"})
    assert status == 200 and manifest["codec"] == "rgb"
    assert seen and set(seen) == {vss.device} == {"cpu"}
    got = _fetch_frames(service.url, manifest)
    assert np.array_equal(
        got, vss.read("road", t=(0.0, 1.0), codec="rgb").frames)


# ---------------------------------------------------------------------------
# the port's service against the reference's
# ---------------------------------------------------------------------------

BODIES = [
    {"name": "road", "codec": "hevc"},
    {"name": "road", "t": [0.4, 1.3], "codec": "rgb"},
    {"name": "road", "resolution": [64, 48], "codec": "rgb"},
    {"name": "road", "codec": "h264"},
    {"name": "road", "roi": [32, 16, 96, 80], "codec": "rgb"},
    {"name": "side", "t": [0.0, 0.5], "codec": "tvc-med"},
]


def _write(vss, clip):
    vss.write("road", clip, fps=30.0, codec="hevc")
    vss.write("side", clip[:20], fps=30.0, codec="tvc-ll", gop_frames=10)


@pytest.fixture()
def twins(tmp_path, clip):
    """A reference service and a port service, each over its own store
    (on a registry of its own) holding the same clips."""
    j = JVSS(str(tmp_path / "j"), config=JConfig(
        backend="local", registry=JRegistry()))
    t = VSS(str(tmp_path / "t"), config=VSSConfig(
        backend="local", registry=MetricsRegistry()))
    services = []
    try:
        for vss, S in ((j, jservice), (t, tservice)):
            _write(vss, clip)
            services.append(S.VSSService(vss))
        yield services
    finally:
        for svc in services:
            svc.close()
        j.close()
        t.close()


def _unsigned(url):
    return urllib.parse.urlsplit(url).path


def _answer(base, body, tenant="t0"):
    """Status, manifest without its ids and signatures, and the segment
    bytes fetched through the signed URLs."""
    status, manifest, headers = _post(base, body, tenant=tenant)
    if status != 200:
        return status, manifest, headers.get("X-VSS-Shed-Reason"), []
    segments = []
    for seg in manifest["segments"]:
        st, data, _ = _get(base, seg["url"])
        assert st == 200 and len(data) == seg["nbytes"]
        segments.append(data)
    rid = manifest.pop("request_id")
    manifest.pop("expires_at")
    manifest["segments"] = [
        {"path": _unsigned(seg["url"]).replace(rid, "<rid>"),
         "nbytes": seg["nbytes"]} for seg in manifest["segments"]]
    return status, manifest, None, segments


def _stored_manifest(base, name):
    status, body, _ = _get(base, "/v1/manifest/" + name)
    doc = json.loads(body)
    for p in doc.get("physicals", []):
        for g in p["gops"]:
            g["url"] = _unsigned(g["url"])
    return status, doc


def test_services_answer_alike(twins):
    """(a) The same reads through both services: byte-identical
    segments, manifests equal apart from ids and signatures, and the
    same stored manifests and video lists after them."""
    jsvc, tsvc = twins
    for body in BODIES:
        a, b = _answer(jsvc.url, body), _answer(tsvc.url, body)
        assert b[:3] == a[:3], body
        assert b[3] == a[3], body
        assert a[0] == 200 and a[3]
    for name in ("road", "side", "ghost"):
        assert _stored_manifest(tsvc.url, name) == \
            _stored_manifest(jsvc.url, name)
    assert _get(tsvc.url, "/v1/videos")[:2] == \
        _get(jsvc.url, "/v1/videos")[:2]


def test_port_service_serves_reference_store(tmp_path, clip):
    """(b) Cross-opening: a port service over a store the reference
    wrote answers the bytes the reference's service gives over a copy
    of the same store."""
    root = tmp_path / "written-by-reference"
    j = JVSS(str(root), config=JConfig(backend="local"))
    _write(j, clip)
    j.close()
    shutil.copytree(root, tmp_path / "copy")
    j = JVSS(str(tmp_path / "copy"), config=JConfig(
        backend="local", registry=JRegistry()))
    t = VSS(str(root), config=VSSConfig(
        backend="local", registry=MetricsRegistry()))
    jsvc, tsvc = jservice.VSSService(j), tservice.VSSService(t)
    try:
        for body in BODIES:
            a, b = _answer(jsvc.url, body), _answer(tsvc.url, body)
            assert b[:3] == a[:3] and b[3] == a[3], body
        assert _stored_manifest(tsvc.url, "road") == \
            _stored_manifest(jsvc.url, "road")
    finally:
        jsvc.close()
        tsvc.close()
        j.close()
        t.close()


@pytest.mark.parametrize("path", [
    "/v1/segment/abc/0", "/v1/gop/objects%2Fv%2F00000001.tvc",
    "/v1/segment/x/3?range=1", "/v1/manifest/road%20cam",
])
def test_signed_urls_interchangeable(path):
    """(c) One secret and one ``now``: identical URLs, and each package
    verifies the other's, with the same verdicts when tampered, late or
    for another path."""
    js = jsigning.UrlSigner(secret=b"shared", ttl_s=30.0)
    ts = tsigning.UrlSigner(secret=b"shared", ttl_s=30.0)
    url = ts.sign(path, now=1000.0)
    assert url == js.sign(path, now=1000.0)
    bare = urllib.parse.urlsplit(path).path
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))
    for now, exp, sig, p in (
            (1010.0, q["exp"], q["sig"], bare),
            (1031.0, q["exp"], q["sig"], bare),
            (1010.0, q["exp"], "0" + q["sig"][1:], bare),
            (1010.0, str(int(q["exp"]) + 1), q["sig"], bare),
            (1010.0, "soon", q["sig"], bare),
            (1010.0, q["exp"], q["sig"], bare + "x")):
        verdicts = {s.verify(p, exp, sig, now=now) for s in (js, ts)}
        assert len(verdicts) == 1, (now, exp, sig, p, verdicts)
    assert ts.verify(bare, q["exp"], q["sig"], now=1010.0) is None
    assert js.verify(bare, q["exp"], q["sig"], now=1010.0) is None


def test_signatures_refused_alike_over_http(tmp_path, clip):
    """(c) Over the wire, with one shared secret: a stored GOP's URL that
    either package signed opens on both services; tampered it answers
    403, expired 410, on both."""
    j = JVSS(str(tmp_path / "j"), config=JConfig(
        backend="local", registry=JRegistry()))
    t = VSS(str(tmp_path / "t"), config=VSSConfig(
        backend="local", registry=MetricsRegistry()))
    _write(j, clip)
    _write(t, clip)
    jsvc = jservice.VSSService(
        j, signer=jsigning.UrlSigner(secret=b"shared"))
    tsvc = tservice.VSSService(
        t, signer=tsigning.UrlSigner(secret=b"shared"))
    try:
        _st, doc = _stored_manifest(tsvc.url, "road")
        path = doc["physicals"][0]["gops"][0]["url"]
        bodies = []
        for signer in (jsvc.signer, tsvc.signer):
            url = signer.sign(path)
            for svc in (jsvc, tsvc):
                status, data, _ = _get(svc.url, url)
                assert status == 200
                bodies.append(data)
                tampered = url.replace("sig=", "sig=0")
                assert _get(svc.url, tampered)[0] == 403
                late = signer.sign(path, now=time.time() - signer.ttl_s - 60)
                status, _data, headers = _get(svc.url, late)
                assert status == 410
                assert headers["X-VSS-Auth-Error"] == "expired"
        assert all(b == bodies[0] for b in bodies)
    finally:
        jsvc.close()
        tsvc.close()
        j.close()
        t.close()


SPEC_BODIES = [
    {"name": "v"},
    {"name": "v", "t": [0, 2], "codec": "hevc", "priority": 3,
     "deadline_ms": 50},
    {"name": "v", "roi": [0, 0, 8, 8], "resolution": [4, 4], "fps": 15,
     "cache": False, "method": "greedy", "quality_eps_db": 30},
    {"name": "v", "t": None, "codec": None},
    {"name": "v", "unknown_knob": 1},
    {"name": "v", "codec": "vp9"},
    {"name": "v", "t": [5, 1]},
    {"name": "v", "t": "soon"},
    {"name": "v", "priority": "urgent"},
    {"name": "v", "deadline_ms": -1},
    {"name": "v", "deadline_ms": "soon"},
    {"name": "v", "deadline_ms": float("nan")},
    {"name": ""},
    {"codec": "hevc"},
    {},
    "just a string",
    [1, 2, 3],
]


def _spec_verdict(S, body):
    try:
        return ("ok", dataclasses.astuple(S.spec_from_json(body)))
    except Exception as exc:  # noqa: BLE001 - the verdict is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("body", SPEC_BODIES,
                         ids=[f"body{i}" for i in range(len(SPEC_BODIES))])
def test_spec_from_json_matches_reference(body):
    """(d) The same bodies accepted and refused, with the same
    exception and message."""
    assert _spec_verdict(tservice, body) == _spec_verdict(jservice, body)


def _smoke_families():
    """`REQUIRED_FAMILIES` of the reference's ``scripts/serving_smoke.py``."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" \
        / "serving_smoke.py"
    spec = importlib.util.spec_from_file_location("_serving_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REQUIRED_FAMILIES


def _serve_families(base):
    status, body, headers = _get(base, "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    types_ = {}
    series = set()
    for line in body.decode().splitlines():
        if line.startswith("# TYPE vss_serve_"):
            _h, _t, name, typ = line.split()
            types_[name] = typ
        elif line.startswith("vss_serve_"):
            head = line.rsplit(" ", 1)[0]
            if "_bucket{" not in head:
                series.add(head)
    return types_, series


def test_metric_families_match_reference(twins):
    """(e) After the same requests (reads from two tenants, one shed at
    its deadline, a stored manifest twice, the list of videos) the same
    `vss_serve_*` families and series on both services' ``/metrics``."""
    jsvc, tsvc = twins
    for svc in twins:
        for i, body in enumerate(BODIES[:3]):
            assert _post(svc.url, body, tenant=f"t{i % 2}")[0] == 200
        shed = _post(svc.url, dict(BODIES[1], deadline_ms=0))
        assert shed[0] == 503
        assert shed[2]["X-VSS-Shed-Reason"] == "deadline"
        assert _get(svc.url, "/v1/manifest/road")[0] == 200
        assert _get(svc.url, "/v1/manifest/road")[0] == 200
        assert _get(svc.url, "/v1/videos")[0] == 200
    a, b = _serve_families(jsvc.url), _serve_families(tsvc.url)
    assert b == a
    families = _smoke_families()
    assert len(families) == 12 and set(families) <= set(a[0])


def _admission_trace(Q, monkeypatch):
    """One seeded admit/release/hold/drop sequence on a fake clock."""
    clock = [100.0]
    monkeypatch.setattr(Q, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    ac = Q.AdmissionController(
        queue_limit=3, inflight_bytes_limit=1000, tenant_rate=2.0,
        tenant_burst=3.0,
        registry=JRegistry() if Q is jqos else MetricsRegistry())
    rng = np.random.default_rng(11)
    out, admitted = [], 0
    for _ in range(300):
        op = int(rng.integers(6))
        if op <= 1:
            d = ac.admit(f"tenant{int(rng.integers(3))}")
            if d is None:
                admitted += 1
            out.append(None if d is None else (d.reason, d.retry_after_s))
        elif op == 2 and admitted:
            ac.release()
            admitted -= 1
        elif op == 3:
            ac.hold_bytes(int(rng.integers(1, 600)))
        elif op == 4:
            ac.drop_bytes(int(rng.integers(1, 600)))
        else:
            clock[0] += float(rng.choice([0.01, 0.1, 0.5, 2.0]))
        out.append((ac.in_flight, ac.held_bytes))
    bucket = Q.TokenBucket(rate=4.0, burst=2.0)
    for dt in (0.0, 0.0, 0.0, 0.1, 0.3, 1.0):
        clock[0] += dt
        out.append((bucket.try_acquire(), bucket.tokens))
    return out


def test_admission_decisions_match_reference(monkeypatch):
    """(f) The same admits, denials, reasons and Retry-After hints, and
    the same token buckets, in both packages on one fake clock."""
    a = _admission_trace(jqos, monkeypatch)
    b = _admission_trace(tqos, monkeypatch)
    assert b == a
    reasons = {x[0] for x in a if isinstance(x, tuple) and
               isinstance(x[0], str)}
    assert reasons == {tqos.REASON_TENANT_RATE, tqos.REASON_QUEUE_DEPTH,
                       tqos.REASON_INFLIGHT_BYTES}
    assert (tqos.REASON_TENANT_RATE, tqos.REASON_QUEUE_DEPTH,
            tqos.REASON_INFLIGHT_BYTES, tqos.REASON_DEADLINE,
            tqos.DEFAULT_TENANT) == (
        jqos.REASON_TENANT_RATE, jqos.REASON_QUEUE_DEPTH,
        jqos.REASON_INFLIGHT_BYTES, jqos.REASON_DEADLINE,
        jqos.DEFAULT_TENANT)


def test_service_close_leaves_no_thread_or_port(tmp_path, clip):
    """``close`` joins the dispatcher and the server thread and frees
    the port."""
    vss = VSS(str(tmp_path / "s"), config=VSSConfig(
        registry=MetricsRegistry()))
    vss.write("road", clip[:15], fps=30.0, codec="tvc-med")
    service = tservice.VSSService(vss)
    try:
        assert _post(service.url, {"name": "road"})[0] == 200
    finally:
        service.close()
        vss.close()
    assert not service.coalescer.alive
    assert not service._thread.is_alive()
    with pytest.raises(OSError):
        urllib.request.urlopen(service.url + "/healthz", timeout=5)
