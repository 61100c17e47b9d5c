"""`RemoteBackend` + the bundled object server: wire protocol, retry
policy, the idempotency-safe temp-key put, and crash recovery.

Contract-level conformance (roundtrips, batches, atomicity, listing)
runs in test_torch_storage.py's `TestBackendConformance` matrix; chaos-level
behaviour (retry exhaustion, torn writes, hangs) in test_torch_faults.py.
This file covers what is specific to the HTTP seam."""
import dataclasses
import random
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.storage import (
    LocalFSBackend,
    MemoryBackend,
    ObjectNotFound,
    ObjectServer,
    RemoteAuthError,
    RemoteBackend,
    RemoteError,
    RequestSigner,
    TieredBackend,
)
from repro import storage as jstorage
from repro_torch import storage as tstorage
from repro_torch.storage.remote import TEMP_PREFIX, _Response
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
def served(tmp_path):
    """(server, backend) over a LocalFS store the test can reach
    behind the wire."""
    store = LocalFSBackend(str(tmp_path / "objects"))
    server = ObjectServer(store)
    rb = RemoteBackend(server.url, backoff_base=0.01)
    yield server, rb, store
    rb.close()
    server.close()


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_ranged_get_partial_object(served):
    _server, rb, _store = served
    rb.put("v/1/0.tvc", b"0123456789" * 10)
    assert rb.get_range("v/1/0.tvc", 0, 4) == b"0123"
    assert rb.get_range("v/1/0.tvc", 95, 5) == b"56789"
    assert rb.get_range("v/1/0.tvc", 10, 1000) == b"0123456789" * 9
    with pytest.raises(ObjectNotFound):
        rb.get_range("missing", 0, 4)
    with pytest.raises(ValueError):
        rb.get_range("v/1/0.tvc", 100, 4)  # start past the end
    with pytest.raises(ValueError):
        rb.get_range("v/1/0.tvc", -1, 4)


def test_ranged_get_slices_when_server_ignores_range(served):
    """An external server without Range support answers 200 + full
    body; the client must slice rather than hand back the whole
    object as if it were the requested window."""
    server, _rb, _store = served

    class NoRangeServer(RemoteBackend):
        def _request(self, method, path, body=None, headers=None):
            headers = {k: v for k, v in (headers or {}).items()
                       if k != "Range"}
            return super()._request(method, path, body=body,
                                    headers=headers)

    rb = NoRangeServer(server.url, backoff_base=0.01)
    try:
        rb.put("k", b"0123456789" * 10)
        assert rb.get_range("k", 6, 5) == b"67890"
        assert rb.get_range("k", 95, 100) == b"56789"
        with pytest.raises(ValueError):
            rb.get_range("k", 100, 4)
    finally:
        rb.close()


def test_server_speaks_plain_http(served):
    """Any HTTP client can read the store — the protocol is the
    commodity S3-shaped surface, not a private RPC."""
    server, rb, _store = served
    rb.put("plain/key.bin", b"wire-visible")
    with urllib.request.urlopen(f"{server.url}/o/plain/key.bin") as resp:
        assert resp.status == 200
        assert resp.read() == b"wire-visible"
    req = urllib.request.Request(
        f"{server.url}/o/plain/key.bin", headers={"Range": "bytes=5-11"}
    )
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 206
        assert resp.read() == b"visible"


def test_keys_with_url_hostile_characters(served):
    _server, rb, _store = served
    # the %41 key is the double-decoding canary: a server that
    # URL-decodes twice would commit it as "v 1/aAb..." instead
    for key in ("v 1/ob+j&ect=#0.tvc", "v 1/a%41b?x=1.tvc"):
        rb.put(key, b"quoted")
        assert rb.get(key) == b"quoted"
        assert rb.stat(key).nbytes == 6
        assert key in rb.list("v 1/")
    assert sorted(rb.list("v 1/")) == sorted(
        ["v 1/ob+j&ect=#0.tvc", "v 1/a%41b?x=1.tvc"]
    )
    for key in ("v 1/ob+j&ect=#0.tvc", "v 1/a%41b?x=1.tvc"):
        rb.delete(key)
        assert not rb.exists(key)


def test_remote_rejects_escaping_keys(served):
    _server, rb, _store = served
    for bad in ("/abs", "../escape", "a/../../b"):
        with pytest.raises(ValueError):
            rb.put(bad, b"x")


def test_missing_key_is_miss_not_retry(served):
    """4xx answers are protocol, not weather: a plain miss must not
    burn the retry budget (or its backoff time)."""
    _server, rb, _store = served
    with pytest.raises(ObjectNotFound):
        rb.get("nope")
    with pytest.raises(ObjectNotFound):
        rb.stat("nope")
    assert rb.retries == 0


# ---------------------------------------------------------------------------
# idempotency-safe put (temp key + server-side rename)
# ---------------------------------------------------------------------------

def test_put_goes_through_temp_key_and_commit(served):
    """Uploads land under the reserved temp prefix and only the rename
    publishes — mid-upload state is invisible to readers and lists."""
    _server, rb, store = served
    rb.put("v/1/0.tvc", b"committed")
    # nothing left under the temp prefix after a successful put
    assert [k for k in store.list() if k.startswith(TEMP_PREFIX)] == []
    assert store.get("v/1/0.tvc") == b"committed"


def test_crashed_upload_leaves_temp_swept_at_recovery(served):
    """A client that died between upload and commit: the destination
    key is untouched, the turd is swept by startup recovery."""
    _server, rb, store = served
    rb.put("v/1/0.tvc", b"live")
    # simulate the crash: the upload half of put(), no rename
    rb._request("PUT", rb._opath(f"{TEMP_PREFIX}deadbeef-1-0"),
                body=b"never committed")
    assert rb.get("v/1/0.tvc") == b"live"
    assert all(not k.startswith(TEMP_PREFIX) for k in rb.list())
    assert rb.sweep_temps() == 1
    assert [k for k in store.list() if k.startswith(TEMP_PREFIX)] == []
    assert rb.get("v/1/0.tvc") == b"live"  # live keys untouched


def test_rename_retry_after_lost_ack_is_accepted(tmp_path):
    """The commit's 204 lost in transit: the retried rename sees 404
    (source already consumed) and must reconcile via the destination —
    exactly the committed bytes means the put succeeded."""
    store = MemoryBackend()
    server = ObjectServer(store)

    class LossyAck(RemoteBackend):
        def __init__(self, url):
            super().__init__(url, backoff_base=0.01)
            self.dropped = 0

        def _request(self, method, path, body=None, headers=None):
            r = super()._request(method, path, body=body, headers=headers)
            if method == "POST" and self.dropped == 0 and r.status == 204:
                # the rename happened server-side; the ack evaporates
                # and the client's retry loop re-POSTs, reaching the
                # 404-reconcile branch in put()
                self.dropped += 1
                return super()._request(method, path)
            return r

    rb = LossyAck(server.url)
    try:
        rb.put("k", b"exactly-once")
        assert rb.dropped == 1
        assert store.get("k") == b"exactly-once"
        assert [k for k in store.list() if k.startswith(TEMP_PREFIX)] == []
    finally:
        rb.close()
        server.close()


def test_rename_missing_source_without_committed_dst_fails(tmp_path):
    """404 on a FIRST rename (nothing committed) must surface as a
    failure, not be mistaken for a lost ack."""
    store = MemoryBackend()
    server = ObjectServer(store)

    class EatUpload(RemoteBackend):
        def _request(self, method, path, body=None, headers=None):
            if method == "POST":
                # pretend someone swept our temp key mid-put
                return _Response(404, b"no src", None)
            return super()._request(method, path, body=body,
                                    headers=headers)

    rb = EatUpload(server.url, backoff_base=0.01)
    try:
        with pytest.raises(IOError, match="rename commit lost"):
            rb.put("k", b"x")
        assert not store.exists("k")
    finally:
        rb.close()
        server.close()


# ---------------------------------------------------------------------------
# connection pool sizing
# ---------------------------------------------------------------------------

def test_configure_concurrency_grows_but_never_shrinks(served):
    _server, rb, _store = served
    rb.configure_concurrency(9)
    assert rb._connections == 9
    keys = [f"k{i}" for i in range(30)]
    rb.batch_put([(k, k.encode()) for k in keys])
    assert rb.batch_get(keys) == [k.encode() for k in keys]
    # a smaller hint must not clamp the pool (two ingest workers must
    # not serialize the read fan-out)
    rb.configure_concurrency(2)
    assert rb._connections == 9
    assert rb.batch_get(keys[:5]) == [k.encode() for k in keys[:5]]


def test_vss_sizes_remote_pool_to_ingest_workers(tmp_path):

    from repro_torch.storage import unwrap

    vss = VSS(str(tmp_path / "vss"), backend="remote", ingest_workers=7)
    try:
        assert unwrap(vss.backend, RemoteBackend) is not None
        assert vss.backend._connections == 7
    finally:
        vss.close()
    vss2 = VSS(str(tmp_path / "vss2"), backend="tiered:remote",
               ingest_workers=5)
    try:
        assert unwrap(vss2.backend.cold, RemoteBackend) is not None
        assert vss2.backend.cold._connections == 5  # forwarded by tiered
    finally:
        vss2.close()


# ---------------------------------------------------------------------------
# VSS crash recovery over the remote layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_clip():
    from repro_torch.data.video import synthesize_road

    return synthesize_road(30, width=128, height=96, seed=3)


def test_vss_remote_startup_sweeps_temps_and_orphans(tmp_path, short_clip):
    """Crash residue on a remote store: an uncommitted temp upload and
    a published-but-never-indexed object; reopening the store sweeps
    both and committed GOPs stay readable."""

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="remote")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    rb = vss.backend
    rb._request("PUT", rb._opath(f"{TEMP_PREFIX}crashed-upload"),
                body=b"half")
    rb.put("v/9/0.tvc", b"published-not-indexed")
    vss.catalog.close()  # crash: no clean-shutdown marker
    vss.backend.close()  # the self-hosted server dies with the process

    vss2 = VSS(root, backend="remote")
    try:
        assert vss2.recovery.temps_removed == 1
        assert vss2.recovery.orphans_removed == 1
        assert vss2.recovery.gops_dropped == 0
        out = vss2.read("v", codec="rgb", cache=False).frames
        assert out.shape == short_clip.shape
    finally:
        vss2.close()


def test_reopen_against_wrong_server_refuses(tmp_path, short_clip):
    """The layout identity lives ON the server: pointing an existing
    catalog at a different object server (typo'd URL, wrong migration
    target) must fail the layout guard loudly — a constant fingerprint
    would let startup recovery wipe the catalog AND collect the other
    server's objects as orphans."""

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="remote")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.catalog.close()  # crash — so the scavenger WOULD run on reopen
    vss.backend.close()

    other = ObjectServer(MemoryBackend())  # a different, healthy store
    try:
        with pytest.raises(ValueError, match="storage layout"):
            VSS(root, backend=f"remote:{other.url}")
        # no object data touched on the wrong server — the probe only
        # minted its (reserved, list-hidden) layout identity
        assert [k for k in other.store.list()
                if not k.startswith("_layout/")] == []
    finally:
        other.close()
    vss2 = VSS(root, backend="remote")  # the right server still opens
    try:
        assert vss2.read("v", codec="rgb", cache=False).frames.shape \
            == short_clip.shape
    finally:
        vss2.close()


def test_error_before_body_read_closes_connection(served):
    """A PUT the server rejects before consuming its body (no
    Content-Length) must close the connection — leaving it open would
    parse the unread body as the next request line and desync every
    later exchange on the socket."""
    import socket as socketlib

    server, _rb, _store = served
    host, port = server.url[len("http://"):].split(":")
    s = socketlib.create_connection((host, int(port)), timeout=5.0)
    try:
        s.sendall(b"PUT /o/k HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n"
                  b"5\r\nhello\r\n0\r\n\r\n")
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = s.recv(4096)
            if not chunk:
                break
            resp += chunk
        assert b"411" in resp.split(b"\r\n", 1)[0]
        assert b"Connection: close" in resp
        # server closes: recv drains to EOF instead of hanging a
        # desynced keep-alive exchange
        s.settimeout(5.0)
        while True:
            tail = s.recv(4096)
            if not tail:
                break
    finally:
        s.close()


def test_vss_remote_reopens_under_same_layout(tmp_path, short_clip):

    root = str(tmp_path / "vss")
    vss = VSS(root, backend="remote")
    vss.write("v", short_clip, fps=30.0, codec="tvc-med", gop_frames=10)
    vss.close()
    with pytest.raises(ValueError, match="storage layout"):
        VSS(root, backend="local")
    # remote and tiered:remote share a layout (the hot tier is
    # ephemeral), mirroring tiered:local vs local
    vss2 = VSS(root, backend="tiered:remote")
    try:
        assert np.asarray(
            vss2.read("v", codec="rgb", cache=False).frames
        ).shape == short_clip.shape
    finally:
        vss2.close()


def test_calibration_targets_reach_through_the_cache(tmp_path):
    b = TieredBackend(RemoteBackend.self_hosted(str(tmp_path / "o")),
                      write_back=True)
    try:
        targets = b.calibration_targets()
        assert list(targets) == ["remote"]
        assert isinstance(targets["remote"], RemoteBackend)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# temp-key protocol property test: any interleaving of put/commit/crash
# recovers to indexed-implies-readable
# ---------------------------------------------------------------------------

def _drive(server_store, url, script):
    """Run a put/abandon script against a fresh client, "crash" it
    (drop the client without cleanup), then recover and check the
    invariant: every indexed key reads back exactly, every uncommitted
    upload is swept."""
    rb = RemoteBackend(url, backoff_base=0.01)
    indexed = {}
    for i, (op, slot) in enumerate(script):
        key = f"v/{slot}/0.tvc"
        data = f"gen-{i}".encode() * 8
        if op == "commit":
            rb.put(key, data)     # durable + committed...
            indexed[key] = data   # ...then indexed (publish-then-index)
        else:  # abandon: the crash hits between upload and commit
            rb._request(
                "PUT", rb._opath(f"{TEMP_PREFIX}abandon-{i}"), body=data
            )
    # crash: no flush, no close-protocol — just a new client recovering
    rb2 = RemoteBackend(url, backoff_base=0.01)
    rb2.sweep_temps()
    for key, data in indexed.items():
        assert rb2.get(key) == data, "indexed key must read back exactly"
    assert all(not k.startswith(TEMP_PREFIX) for k in server_store.list())
    rb.close()
    rb2.close()


try:  # property-based when the wheel is present, seeded sweep otherwise
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=15, deadline=None)
    @given(st.lists(
        st.tuples(st.sampled_from(["commit", "abandon"]),
                  st.integers(0, 3)),
        max_size=12,
    ))
    def test_temp_key_protocol_recovers_indexed_implies_readable(
            script):
        store = MemoryBackend()
        server = ObjectServer(store)
        try:
            _drive(store, server.url, script)
        finally:
            server.close()

except ImportError:  # deterministic sweep fallback (same invariant)
    def test_temp_key_protocol_recovers_indexed_implies_readable():
        import random

        for seed in range(6):
            rng = random.Random(seed)
            script = [
                (rng.choice(["commit", "abandon"]), rng.randrange(4))
                for _ in range(rng.randrange(1, 12))
            ]
            store = MemoryBackend()
            server = ObjectServer(store)
            try:
                _drive(store, server.url, script)
            finally:
                server.close()


# ---------------------------------------------------------------------------
# hedged GETs (tail-latency insurance)
# ---------------------------------------------------------------------------

def test_hedged_get_cuts_tail_latency(tmp_path):
    """Under bimodal injected latency (occasional heavy spikes), a
    hedged client's p99 beats the unhedged client's by a wide margin —
    the duplicate request escapes the spike."""
    import time as _time

    from repro_torch.storage.faults import FaultInjectingBackend

    store = FaultInjectingBackend(
        MemoryBackend(), seed=7, latency=0.002,
        latency_spike=0.12, latency_spike_rate=0.1,
    )
    server = ObjectServer(store)
    plain = RemoteBackend(server.url)
    hedged = RemoteBackend(server.url, hedge_threshold=0.02)
    try:
        plain.put("k", b"x" * 4096)

        def p99(backend, n=60):
            lats = []
            for _ in range(n):
                t0 = _time.perf_counter()
                assert backend.get("k") == b"x" * 4096
                lats.append(_time.perf_counter() - t0)
            lats.sort()
            return lats[max(0, round(0.99 * n) - 1)]

        plain_p99 = p99(plain)
        hedged_p99 = p99(hedged)
        assert hedged.hedges > 0, "spikes never crossed the threshold"
        assert hedged.hedge_wins > 0, "the duplicate never won a race"
        assert hedged_p99 < plain_p99 * 0.8, (
            f"hedging did not cut p99: {hedged_p99:.3f}s vs"
            f" {plain_p99:.3f}s"
        )
    finally:
        plain.close()
        hedged.close()
        server.close()


def test_hedged_get_miss_is_authoritative(served):
    """A 404 is the store speaking, not the network: the hedged path
    short-circuits it instead of waiting out the race."""
    server, _rb, _store = served
    hedged = RemoteBackend(server.url, hedge_threshold=0.01)
    try:
        with pytest.raises(ObjectNotFound):
            hedged.get("never-written")
        hedged.put("real", b"abc")
        assert hedged.get("real") == b"abc"
    finally:
        hedged.close()


def test_hedged_batch_get_does_not_deadlock(served):
    """batch_get fan-out + nested hedge futures must ride separate
    executors; saturating the fan-out pool used to be the deadlock
    shape."""
    server, _rb, _store = served
    hedged = RemoteBackend(server.url, hedge_threshold=0.001,
                           connections=2)
    try:
        items = [(f"k{i}", bytes([i]) * 64) for i in range(24)]
        hedged.batch_put(items)
        got = hedged.batch_get([k for k, _ in items])
        assert got == [v for _, v in items]
    finally:
        hedged.close()


def test_hedge_threshold_validation():
    with pytest.raises(ValueError):
        RemoteBackend("http://127.0.0.1:1", hedge_threshold=0.0)
    with pytest.raises(ValueError):
        RemoteBackend("http://127.0.0.1:1", hedge_threshold=-1.0)


# ---------------------------------------------------------------------------
# untrusted networks: HMAC signed requests + TLS
# ---------------------------------------------------------------------------

_SECRET = b"remote-auth-test-secret"


def test_signed_requests_authenticate_the_wire():
    server = ObjectServer(MemoryBackend(), secret=_SECRET)
    rb = RemoteBackend(server.url, secret=_SECRET, backoff_base=0.01)
    try:
        rb.put("v/1.tvc", b"payload")
        assert rb.get("v/1.tvc") == b"payload"
        assert rb.get_range("v/1.tvc", 0, 4) == b"payl"
        assert rb.stat("v/1.tvc").nbytes == 7
        assert rb.list() == ["v/1.tvc"]
        rb.delete("v/1.tvc")
        assert not rb.exists("v/1.tvc")
    finally:
        rb.close()
        server.close()


def test_unauthenticated_and_tampered_requests_401_without_retry():
    """Missing or wrong signatures are configuration errors: the
    server answers 401, the client raises `RemoteAuthError` on the
    FIRST attempt — hammering a doomed retry loop would only hide the
    misconfiguration."""
    store = MemoryBackend()
    server = ObjectServer(store, secret=_SECRET)
    good = RemoteBackend(server.url, secret=_SECRET, backoff_base=0.01)
    anon = RemoteBackend(server.url, backoff_base=0.01)
    tampered = RemoteBackend(server.url, secret=b"wrong-secret",
                             backoff_base=0.01)
    try:
        good.put("k", b"x")
        rejected0 = server._httpd._c_auth_rejected.value

        with pytest.raises(RemoteAuthError):
            anon.get("k")
        assert anon.retries == 0  # terminal, never transport weather

        with pytest.raises(RemoteAuthError):
            tampered.get("k")
        with pytest.raises(RemoteAuthError):
            tampered.put("k", b"overwrite")
        with pytest.raises(RemoteAuthError):
            tampered.delete("k")
        assert tampered.retries == 0
        assert store.get("k") == b"x"  # nothing mutated
        assert server._httpd._c_auth_rejected.value >= rejected0 + 4
        assert good.get("k") == b"x"  # the honest client is unaffected
    finally:
        for b in (good, anon, tampered):
            b.close()
        server.close()


def test_expired_signature_is_rejected():
    store = MemoryBackend()
    store.put("k", b"x")
    server = ObjectServer(store, secret=_SECRET)
    signer = RequestSigner(_SECRET)
    try:
        stale = signer.headers("GET", "/o/k", now=time.time() - 3600)
        req = urllib.request.Request(server.url + "/o/k", headers=stale)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 401
        assert ei.value.read() == b"expired"
        # extending the expiry header invalidates the MAC instead
        forged = dict(signer.headers("GET", "/o/k", now=time.time() - 3600))
        forged["X-VSS-Exp"] = str(int(time.time()) + 600)
        req = urllib.request.Request(server.url + "/o/k", headers=forged)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 401
        assert ei.value.read() == b"bad-signature"
        # a fresh signature over the same request is accepted
        req = urllib.request.Request(
            server.url + "/o/k", headers=signer.headers("GET", "/o/k"))
        assert urllib.request.urlopen(req).read() == b"x"
    finally:
        server.close()


def test_observability_endpoints_stay_open_on_secured_server():
    """/healthz (and /metrics) are the monitoring plane — probes don't
    hold store secrets; the object routes stay locked."""
    server = ObjectServer(MemoryBackend(), secret=_SECRET,
                          health=lambda: {"status": "ok"})
    try:
        with urllib.request.urlopen(server.url + "/healthz") as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server.url + "/o/k")
        assert ei.value.code == 401
    finally:
        server.close()


def test_tls_roundtrip_with_pinned_self_signed_cert(tmp_path):
    from test_torch_storage import mint_tls_cert

    cert, key = mint_tls_cert(str(tmp_path / "tls"))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    server = ObjectServer(MemoryBackend(), secret=_SECRET, ssl_context=ctx)
    assert server.url.startswith("https://")
    rb = RemoteBackend(server.url, secret=_SECRET, ca_file=cert,
                       backoff_base=0.01)
    try:
        rb.put("v/1.tvc", b"encrypted-in-flight")
        assert rb.get("v/1.tvc") == b"encrypted-in-flight"
        assert rb.get_range("v/1.tvc", 0, 9) == b"encrypted"
        assert rb.list() == ["v/1.tvc"]
    finally:
        rb.close()

    # a client that does NOT pin the cert refuses the connection —
    # default verification rejects the self-signed chain
    strict = RemoteBackend(server.url, secret=_SECRET, max_retries=0)
    try:
        with pytest.raises(RemoteError):
            strict.get("v/1.tvc")
    finally:
        strict.close()
        server.close()


def test_server_list_hides_reserved_namespaces(served):
    """The wire listing must not leak `_rtmp/` upload turds (or other
    reserved namespaces) to clients that do no filtering of their own
    — but an explicit reach-in prefix still answers, because startup
    temp sweeps list `_rtmp/` to clean it."""
    server, rb, store = served
    rb.put("v/1.tvc", b"x")
    store.put("_rtmp/turd", b"t")
    store.put("_journal/seg-0000000000000000.vssj", b"j")
    store.put("_layout/id", b"l")

    def wire_list(prefix=""):
        q = urllib.parse.urlencode({"prefix": prefix})
        with urllib.request.urlopen(server.url + f"/list?{q}") as r:
            return sorted(k for k in r.read().decode().split("\n") if k)

    assert wire_list() == ["v/1.tvc"]
    assert wire_list("v/") == ["v/1.tvc"]
    assert wire_list("_rtmp/") == ["_rtmp/turd"]  # explicit reach-in
    assert rb.sweep_temps() == 1
    assert wire_list("_rtmp/") == []


# ---------------------------------------------------------------------------
# the port against the reference: either client over either server
# ---------------------------------------------------------------------------

PACKAGES = {"reference": jstorage, "port": tstorage}


def _wire_script(rb):
    """One seeded run of every client verb over the wire, hostile key
    characters and typed errors included."""
    from test_torch_storage import _outcome

    rng = random.Random(7)
    keys = ["v/1/0.tvc", "v/1/1.tvc", "v 1/ob+j&ect=#0.tvc",
            "v 1/a%41b?x=1.tvc", "w/0.tvc"]
    out = []
    for _ in range(120):
        op = rng.choice(("put", "get", "get_range", "stat", "exists",
                         "delete", "list", "batch_get", "batch_put"))
        key = rng.choice(keys)
        if op == "put":
            args = (key, rng.randbytes(rng.randrange(0, 5000)))
        elif op == "get_range":
            args = (key, rng.randrange(0, 5000), rng.randrange(1, 700))
        elif op == "list":
            args = (rng.choice(("", "v/", "v 1/", "_rtmp/")),)
        elif op == "batch_get":
            args = (rng.sample(keys, 2),)
        elif op == "batch_put":
            args = ([(k, rng.randbytes(300)) for k in rng.sample(keys, 2)],)
        else:
            args = (key,)
        out.append((op, _outcome(getattr(rb, op), *args)))
    out.append(("fingerprint", rb.layout_fingerprint().split(":")[0]))
    out.append(("sweep", rb.sweep_temps()))
    return out


@pytest.mark.parametrize("secret", [None, _SECRET], ids=["plain", "signed"])
@pytest.mark.parametrize("client,server", [("port", "reference"),
                                           ("reference", "port")])
def test_remote_interop_matches_same_package(tmp_path, client, server,
                                             secret):
    """Either package's `RemoteBackend` against the other's
    `ObjectServer`, plain and signed: every answer equals the one the
    server's own client gets, and both leave the same objects."""
    S, C = PACKAGES[server], PACKAGES[client]
    runs, stores = [], []
    for name, client_pkg in (("own", S), ("cross", C)):
        store = S.LocalFSBackend(str(tmp_path / name))
        srv = S.ObjectServer(store, secret=secret)
        rb = client_pkg.RemoteBackend(srv.url, secret=secret,
                                      backoff_base=0.01)
        try:
            runs.append(_wire_script(rb))
            # the minted layout id is random in both
            stores.append({k: store.get(k) for k in store.list()
                           if not k.startswith("_layout/")})
        finally:
            rb.close()
            srv.close()
    assert runs[1] == runs[0]
    assert stores[1] == stores[0]


@pytest.mark.parametrize("server", ["reference", "port"])
def test_wrong_secret_refused_alike(server):
    """A wrong secret, or none, is refused by both servers with the
    same 401 body, and both clients raise the same terminal error."""
    S = PACKAGES[server]
    srv = S.ObjectServer(MemoryBackend(), secret=_SECRET)
    try:
        S.RemoteBackend(srv.url, secret=_SECRET).put("k", b"x")
        errors = []
        for C in (jstorage, tstorage):
            for secret in (None, b"wrong-secret"):
                rb = C.RemoteBackend(srv.url, secret=secret,
                                     backoff_base=0.01)
                try:
                    with pytest.raises(C.RemoteAuthError) as ei:
                        rb.get("k")
                    assert rb.retries == 0
                    errors.append(str(ei.value))
                finally:
                    rb.close()
        assert errors[:2] == errors[2:]
        assert "-> 401: missing-signature" in errors[0]
        assert "-> 401: bad-signature" in errors[1]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/o/k")
        assert (ei.value.code, ei.value.read()) == (401,
                                                     b"missing-signature")
    finally:
        srv.close()


def test_request_signatures_verify_across_packages():
    """The canonical string is METHOD|path?query|expiry in both: equal
    headers for the same request and instant, and each package's
    signature verifies (or is refused, with the same reason) in the
    other's signer."""
    now = time.time()
    js, ts = jstorage.RequestSigner(_SECRET), tstorage.RequestSigner(_SECRET)
    for method, path in (("GET", "/o/k"), ("put", "/o/v%201/a%41b"),
                         ("POST", "/rename?src=a&dst=b"),
                         ("DELETE", "/o/x")):
        hj = js.headers(method, path, now=now)
        ht = ts.headers(method, path, now=now)
        assert hj == ht
        for signer, h in ((ts, hj), (js, ht)):
            exp, sig = h["X-VSS-Exp"], h["X-VSS-Sig"]
            assert signer.verify(method, path, exp, sig, now=now) is None
            for args in ((method, path + "x", exp, sig),
                         ("HEAD", path, exp, sig),
                         (method, path, str(int(exp) + 1), sig),
                         (method, path, None, sig),
                         (method, path, "soon", sig)):
                assert signer.verify(*args, now=now) \
                    == (js if signer is ts else ts).verify(*args, now=now)
            assert signer.verify(method, path, exp, sig, now=now + 3600) \
                == "expired"
