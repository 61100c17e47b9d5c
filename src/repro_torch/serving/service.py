"""VSS-as-a-service: the concurrent HTTP front end over the read path.

`VSSService` turns one in-process `VSS` handle into a multi-tenant
serving tier on the stdlib HTTP stack (same machinery as
`repro_torch.storage.httpserver`).  The pieces:

  * **coalesced control plane** — ``POST /v1/read`` accepts a JSON
    `ReadSpec`; concurrent requests landing within one intake window
    are planned and executed through a single ``VSS.read_batch`` call
    (`repro_torch.serving.coalesce`), so N clients asking for overlapping
    views share joint plans, deduped GOP fetches, and single decodes;
  * **QoS** — per-tenant token-bucket admission plus queue-depth and
    in-flight-bytes caps (`repro_torch.serving.qos`); overload answers an
    honest ``503`` with ``Retry-After`` and ``X-VSS-Shed-Reason``
    instead of queueing into latency collapse.  ``deadline_ms`` in the
    request is a time budget from arrival: expired requests are shed at
    dispatch, and `read_batch` orders execution within a plan group by
    (priority desc, earliest deadline);
  * **signed data plane** — a read answers a *manifest* of segment
    URLs, not bytes; each ``GET /v1/segment/<rid>/<i>`` URL is an
    HMAC-signed expiring capability (`repro_torch.serving.signing`).
    Segments are serialized GOPs (`repro_torch.codec.deserialize_gop` +
    ``decode_gop`` on the client);
  * **stored-manifest endpoint** — ``GET /v1/manifest/<name>`` lists a
    logical video's physical layout with signed per-GOP URLs; the
    catalog walk is cached and invalidated through `VSS.on_write`;
  * **observability** — ``/metrics`` (Prometheus text) and
    ``/healthz`` ride the same `repro_torch.obs` registry as every other
    layer: intake-to-first-byte and end-to-end latency histograms,
    coalesce width, shed counts by reason, per-tenant quota gauges.

HTTP surface:

    POST /v1/read                  JSON ReadSpec -> JSON manifest
    GET  /v1/segment/<rid>/<i>     one result segment (signed, expiring)
    GET  /v1/manifest/<name>       stored layout + signed GOP URLs
    GET  /v1/gop/<key>             one stored GOP object (signed)
    GET  /v1/videos                logical videos (JSON list)
    GET  /metrics                  Prometheus text 0.0.4
    GET  /healthz                  JSON health report

Standalone::

    python -m repro_torch.serving.service --root /data/vss --port 8090

The store runs on the card; a boot file (``--config``) with
``"store": {"device": "cpu"}`` serves from the CPU instead.
"""
from __future__ import annotations

import json
import re
import secrets
import threading
import time
import urllib.parse
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from repro_torch import codec as _codec
from repro_torch.core.config import strict_keys
from repro_torch.core.spec import ReadSpec
from repro_torch.serving.config import ServiceConfig
from repro_torch.serving.coalesce import (
    DEFAULT_INTAKE_WINDOW_S,
    DEFAULT_MAX_BATCH,
    BatchCoalescer,
    DeadlineExceeded,
)
from repro_torch.serving.qos import (
    DEFAULT_TENANT,
    REASON_DEADLINE,
    AdmissionController,
    Denial,
)
from repro_torch.serving.signing import DEFAULT_TTL_S, UrlSigner

MAX_READ_BODY = 1 << 20  # a ReadSpec is small; anything bigger is abuse

# HTTP Range header accepted on signed /v1/gop and /v1/segment fetches
# (single ascending byte range; same grammar as the object server)
_RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")

_SPEC_FIELDS = (
    "name", "t", "resolution", "roi", "fps", "codec", "quality_eps_db",
    "cache", "method", "priority", "deadline_ms",
)


def spec_from_json(obj: dict) -> ReadSpec:
    """Build a validated `ReadSpec` from a decoded JSON body; unknown
    keys are rejected so typos fail loudly instead of silently serving
    the wrong view.  (The same `strict_keys` contract validates config
    files — `repro_torch.serving.config`.)"""
    data = strict_keys(obj, _SPEC_FIELDS, "ReadSpec")
    kwargs = {k: v for k, v in data.items() if v is not None}
    if "name" not in kwargs:
        raise ValueError("ReadSpec needs a 'name'")
    return ReadSpec(**kwargs)


class _Parked:
    """One executed read parked for signed-URL delivery."""

    __slots__ = ("segments", "meta", "expires", "nbytes")

    def __init__(self, segments: List[bytes], meta: dict, expires: float):
        self.segments = segments
        self.meta = meta
        self.expires = expires
        self.nbytes = sum(len(s) for s in segments)


class _ManifestCache:
    """Name -> stored-layout dict, invalidated by `VSS.on_write`.

    The cached value carries *unsigned* GOP paths; signatures are
    applied at render time so a manifest served from cache never hands
    out tokens that were minted (and started expiring) at fill time.
    """

    def __init__(self, vss, registry):
        self.vss = vss
        self._cache: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._hits = registry.counter(
            "vss_serve_manifest_cache_hits_total", "manifest cache hits")
        self._misses = registry.counter(
            "vss_serve_manifest_cache_misses_total", "manifest cache misses")
        self._invalidations = registry.counter(
            "vss_serve_manifest_invalidations_total",
            "manifest cache entries dropped by write notifications")
        vss.on_write(self.invalidate)

    def invalidate(self, name: str) -> None:
        with self._lock:
            if self._cache.pop(name, None) is not None:
                self._invalidations.inc()

    def get(self, name: str) -> dict:
        with self._lock:
            cached = self._cache.get(name)
        if cached is not None:
            self._hits.inc()
            return cached
        self._misses.inc()
        built = self._build(name)
        with self._lock:
            self._cache[name] = built
        return built

    def _build(self, name: str) -> dict:
        cat = self.vss.catalog
        if cat.get_original_id(name) is None:
            raise KeyError(f"unknown logical video {name!r}")
        physicals = []
        for p in cat.physicals_for(name):
            gops = []
            for g in cat.gops_for(p.physical_id):
                gops.append({
                    "gop_id": g.gop_id,
                    "start_frame": g.start_frame,
                    "num_frames": g.num_frames,
                    "nbytes": g.nbytes,
                    "t0": g.start_time(p.fps, p.t_start),
                    "t1": g.end_time(p.fps, p.t_start),
                    "path": g.path,
                })
            physicals.append({
                "physical_id": p.physical_id,
                "codec": p.codec,
                "fps": p.fps,
                "roi": list(p.roi),
                "t_start": p.t_start,
                "t_end": p.t_end,
                "is_original": p.is_original,
                "gops": gops,
            })
        return {
            "name": name,
            "total_bytes": cat.total_bytes(name),
            "physicals": physicals,
        }


class VSSService:
    """A running serving front end over one `VSS` store.

    Binds ``host:port`` (port 0 picks an ephemeral port) on a daemon
    thread; ``url`` is the base clients talk to.  ``window_s=0,
    max_batch=1`` degrades to per-request sequential serving — the
    benchmark control for the coalescing win.
    """

    _UNSET = object()  # legacy-kwarg sentinel

    def __init__(
        self,
        vss,
        *,
        config: Optional[ServiceConfig] = None,
        # live-object injection (not config — a config file can't carry
        # a pre-built controller, signer, or registry)
        admission: Optional[AdmissionController] = None,
        signer: Optional[UrlSigner] = None,
        registry=None,
        # -- deprecated keyword arguments (pre-ServiceConfig surface) --
        host=_UNSET,
        port=_UNSET,
        window_s=_UNSET,
        max_batch=_UNSET,
        url_ttl_s=_UNSET,
    ):
        legacy = {
            name: value
            for name, value in (
                ("host", host), ("port", port), ("window_s", window_s),
                ("max_batch", max_batch), ("url_ttl_s", url_ttl_s),
            )
            if value is not VSSService._UNSET
        }
        if legacy:
            warnings.warn(
                f"VSSService keyword argument(s) {sorted(legacy)} are"
                " deprecated; pass VSSService(vss,"
                " config=ServiceConfig(...)) instead",
                DeprecationWarning, stacklevel=2,
            )
            config = (config or ServiceConfig()).replace(**legacy)
        config = config or ServiceConfig()
        self.config = config
        self.vss = vss
        reg = registry if registry is not None else vss.registry
        self.registry = reg
        self.admission = admission or config.admission.build(registry=reg)
        self.signer = signer or UrlSigner(ttl_s=config.url_ttl_s)
        self.coalescer = BatchCoalescer(
            vss, window_s=config.window_s, max_batch=config.max_batch,
            registry=reg,
        )
        self.manifests = _ManifestCache(vss, reg)
        self._parked: Dict[str, _Parked] = {}
        self._parked_lock = threading.Lock()
        self._h_ttfb = reg.histogram(
            "vss_serve_ttfb_seconds",
            "read intake to result-ready (first byte imminent)")
        self._h_e2e = reg.histogram(
            "vss_serve_e2e_seconds", "read intake to manifest written")
        self._c_requests: Dict[str, object] = {}
        self._c_shed: Dict[str, object] = {}
        self._req_lock = threading.Lock()
        self._httpd = _ServiceServer((config.host, config.port), self)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="vss-serve-http",
        )
        self._thread.start()

    # -- metrics helpers ---------------------------------------------------
    def count_request(self, endpoint: str) -> None:
        with self._req_lock:
            c = self._c_requests.get(endpoint)
            if c is None:
                c = self.registry.counter(
                    "vss_serve_requests_total", "requests by endpoint",
                    {"endpoint": endpoint})
                self._c_requests[endpoint] = c
        c.inc()

    def count_shed(self, reason: str) -> None:
        with self._req_lock:
            c = self._c_shed.get(reason)
            if c is None:
                c = self.registry.counter(
                    "vss_serve_shed_total", "requests shed",
                    {"reason": reason})
                self._c_shed[reason] = c
        c.inc()

    def observe_ttfb(self, seconds: float) -> None:
        self._h_ttfb.observe(seconds)

    def observe_e2e(self, seconds: float) -> None:
        self._h_e2e.observe(seconds)

    # -- parked results ----------------------------------------------------
    def park(self, result) -> dict:
        """Serialize a `ReadResult` into signed-URL segments; returns
        the manifest dict for the HTTP response.  A result without
        encoded GOPs is encoded on the store's device."""
        if result.encoded is not None:
            segments = [_codec.serialize_gop(e) for e in result.encoded]
        else:
            segments = [
                _codec.serialize_gop(_codec.encode_gop(
                    chunk, result.codec, device=self.vss.device))
                for _, chunk in _codec.split_into_gops(
                    result.frames, result.codec)
            ]
        rid = secrets.token_hex(16)
        expires = time.time() + self.signer.ttl_s
        meta = {"codec": result.codec, "fps": result.fps}
        parked = _Parked(segments, meta, expires)
        self._evict_expired()
        with self._parked_lock:
            self._parked[rid] = parked
        self.admission.hold_bytes(parked.nbytes)
        return {
            "request_id": rid,
            "codec": result.codec,
            "fps": result.fps,
            "nbytes": parked.nbytes,
            "expires_at": int(expires),
            "segments": [
                {
                    "url": self.signer.sign(f"/v1/segment/{rid}/{i}"),
                    "nbytes": len(seg),
                }
                for i, seg in enumerate(segments)
            ],
        }

    def segment(self, rid: str, idx: int) -> Optional[bytes]:
        with self._parked_lock:
            parked = self._parked.get(rid)
        if parked is None or parked.expires < time.time():
            self._evict_expired()
            return None
        if not 0 <= idx < len(parked.segments):
            return None
        return parked.segments[idx]

    def _evict_expired(self) -> None:
        now = time.time()
        dropped = 0
        with self._parked_lock:
            for rid in [r for r, p in self._parked.items()
                        if p.expires < now]:
                dropped += self._parked.pop(rid).nbytes
        if dropped:
            self.admission.drop_bytes(dropped)

    # -- lifecycle ---------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.coalescer.close()
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


class _ServiceServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog (5) drops connections when a
    # client burst all connects in the same instant — exactly the shape
    # the coalescer is built for
    request_queue_size = 128

    def __init__(self, addr, service: VSSService):
        super().__init__(addr, _ServiceHandler)
        self.service = service


class _ServiceHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "vss-serving/1"

    @property
    def service(self) -> VSSService:
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # pragma: no cover - silence
        pass

    # -- plumbing ----------------------------------------------------------
    def _respond(self, status: int, body: bytes = b"",
                 extra: Optional[dict] = None, close: bool = False):
        if close:
            self.close_connection = True
        self.send_response(status)
        if close:
            self.send_header("Connection", "close")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _json(self, status: int, obj, extra: Optional[dict] = None):
        self._respond(status, json.dumps(obj).encode(), extra={
            "Content-Type": "application/json", **(extra or {})
        })

    def _shed(self, denial: Denial):
        self.service.count_shed(denial.reason)
        self._json(503, {"error": "shed", "reason": denial.reason}, extra={
            "Retry-After": str(max(1, round(denial.retry_after_s))),
            "X-VSS-Shed-Reason": denial.reason,
        })

    def _verify_signature(self, quoted_path: str) -> bool:
        """Check ``exp``/``sig`` on a data-plane request; answers the
        403/410 itself on failure.  The MAC covers the path exactly as
        signed — still URL-quoted — so quoting tricks can't alias keys."""
        q = {k: v[0] for k, v in urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query).items()}
        why = self.service.signer.verify(
            quoted_path, q.get("exp", ""), q.get("sig", ""))
        if why is None:
            return True
        self._respond(410 if why == "expired" else 403,
                      why.encode(), extra={"X-VSS-Auth-Error": why})
        return False

    # -- control plane -----------------------------------------------------
    def do_POST(self):
        if urllib.parse.urlsplit(self.path).path != "/v1/read":
            self._respond(404, b"bad path", close=True)
            return
        arrival = time.monotonic()
        self.service.count_request("read")
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            self._respond(411, b"length required", close=True)
            return
        if length > MAX_READ_BODY:
            self._respond(413, b"body too large", close=True)
            return
        try:
            raw = self.rfile.read(length)
            if len(raw) != length:
                raise ConnectionError("short read")
        except Exception:
            self._respond(400, b"truncated body", close=True)
            return
        tenant = self.headers.get("X-VSS-Tenant", DEFAULT_TENANT)
        denial = self.service.admission.admit(tenant)
        if denial is not None:
            self._shed(denial)
            return
        try:
            self._do_read(raw, arrival)
        finally:
            self.service.admission.release()

    def _do_read(self, raw: bytes, arrival: float):
        try:
            spec = spec_from_json(json.loads(raw.decode()))
        except (ValueError, UnicodeDecodeError) as exc:
            self._json(400, {"error": str(exc)})
            return
        # cheap existence probe: reject obvious misses before they cost
        # a batch fallback round (the authoritative check — post-ingest
        # barrier — still happens inside read_batch)
        if self.service.vss.catalog.get_original_id(spec.name) is None:
            self._json(404, {"error": f"unknown video {spec.name!r}"})
            return
        future = self.service.coalescer.submit(spec, arrival)
        try:
            result = future.result()
        except DeadlineExceeded as exc:
            # the coalescer already counted reason=deadline
            self._json(503, {"error": "shed", "reason": REASON_DEADLINE,
                             "detail": str(exc)}, extra={
                "Retry-After": "1",
                "X-VSS-Shed-Reason": REASON_DEADLINE,
            })
            return
        except KeyError as exc:
            self._json(404, {"error": str(exc)})
            return
        except ValueError as exc:
            self._json(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - wire boundary
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self.service.observe_ttfb(time.monotonic() - arrival)
        manifest = self.service.park(result)
        self._json(200, manifest)
        self.service.observe_e2e(time.monotonic() - arrival)

    # -- data plane + introspection ----------------------------------------
    def do_GET(self):
        path = urllib.parse.urlsplit(self.path).path
        if path == "/metrics":
            self._respond(
                200, self.service.registry.render_prometheus().encode(),
                extra={"Content-Type":
                       "text/plain; version=0.0.4; charset=utf-8"})
            return
        if path == "/healthz":
            try:
                report = self.service.vss.health()
                status = 200 if report.get("status") == "ok" else 503
            except Exception as exc:  # noqa: BLE001 - wire boundary
                report = {"status": "error",
                          "error": f"{type(exc).__name__}: {exc}"}
                status = 503
            report["serving"] = {
                "coalescer_alive": self.service.coalescer.alive,
                "in_flight": self.service.admission.in_flight,
                "held_bytes": self.service.admission.held_bytes,
            }
            self._json(status, report)
            return
        if path == "/v1/videos":
            self.service.count_request("videos")
            self._json(200, sorted(self.service.vss.catalog.list_logical()))
            return
        if path.startswith("/v1/manifest/"):
            self._do_manifest(path[len("/v1/manifest/"):])
            return
        if path.startswith("/v1/segment/"):
            self._do_segment(path)
            return
        if path.startswith("/v1/gop/"):
            self._do_gop(path)
            return
        self._respond(404, b"bad path", close=True)

    def _do_manifest(self, quoted_name: str):
        self.service.count_request("manifest")
        name = urllib.parse.unquote(quoted_name)
        try:
            manifest = self.service.manifests.get(name)
        except KeyError as exc:
            self._json(404, {"error": str(exc)})
            return
        signer = self.service.signer
        out = dict(manifest)
        out["physicals"] = [
            {**p, "gops": [
                {**g, "url": signer.sign(
                    "/v1/gop/" + urllib.parse.quote(g["path"], safe=""))}
                for g in p["gops"]
            ]}
            for p in manifest["physicals"]
        ]
        self._json(200, out)

    def _do_segment(self, path: str):
        self.service.count_request("segment")
        parts = path[len("/v1/segment/"):].split("/")
        if len(parts) != 2 or not parts[1].isdigit():
            self._respond(404, b"bad segment path")
            return
        if not self._verify_signature(path):
            return
        data = self.service.segment(parts[0], int(parts[1]))
        if data is None:
            self._respond(404, b"unknown or expired request id")
            return
        self._serve_bytes(data)

    def _do_gop(self, path: str):
        self.service.count_request("gop")
        if not self._verify_signature(path):
            return
        key = urllib.parse.unquote(path[len("/v1/gop/"):])
        try:
            data = self.service.vss.backend.get(key)
        except KeyError:
            self._respond(404, b"no such object")
            return
        except Exception as exc:  # noqa: BLE001 - wire boundary
            self._respond(500, f"{type(exc).__name__}: {exc}".encode())
            return
        self._serve_bytes(data)

    def _serve_bytes(self, data: bytes) -> None:
        """Answer an octet-stream response, honouring ``Range:
        bytes=a-b`` with 206/Content-Range (416 for unsatisfiable
        ranges) — so a sub-GOP client can pull just the byte prefix its
        frame trim decodes, through the same signed URL it was handed
        (the signature covers the path; the range picks bytes within
        it)."""
        extra = {"Content-Type": "application/octet-stream",
                 "Accept-Ranges": "bytes"}
        rng = self.headers.get("Range")
        if rng:
            m = _RANGE_RE.match(rng.strip())
            if not m or int(m.group(1)) >= len(data):
                self._respond(416, b"", extra={
                    **extra, "Content-Range": f"bytes */{len(data)}"})
                return
            a = int(m.group(1))
            b = int(m.group(2)) + 1 if m.group(2) else len(data)
            b = min(b, len(data))
            self._respond(206, data[a:b], extra={
                **extra,
                "Content-Range": f"bytes {a}-{b - 1}/{len(data)}"})
            return
        self._respond(200, data, extra=extra)


def main(argv=None) -> None:  # pragma: no cover - operational entry point
    import argparse

    from repro_torch.core.config import VSSConfig
    from repro_torch.core.store import VSS
    from repro_torch.serving.config import boot_from_json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="JSON boot file ({root, store, service} — see"
                         " repro_torch.serving.config); CLI flags override it")
    ap.add_argument("--root", default=None, help="VSS store root")
    ap.add_argument("--backend", default=None,
                    help="make_backend spec (default: store/env default)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--window-ms", type=float, default=None,
                    help="coalescing intake window (0 disables)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--url-ttl-s", type=float, default=None)
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            doc = json.load(f)
        if args.root:
            doc["root"] = args.root
        svc = dict(doc.get("service", {}))
        for field, value in (
            ("host", args.host), ("port", args.port),
            ("max_batch", args.max_batch), ("url_ttl_s", args.url_ttl_s),
            ("window_s", None if args.window_ms is None
             else args.window_ms / 1000.0),
        ):
            if value is not None:
                svc[field] = value
        if svc:
            doc["service"] = svc
        vss, service = boot_from_json(doc)
    else:
        if not args.root:
            ap.error("--root (or --config) is required")
        vss = VSS(args.root, config=VSSConfig(backend=args.backend))
        service = VSSService(vss, config=ServiceConfig(
            host=args.host or "127.0.0.1",
            port=8090 if args.port is None else args.port,
            window_s=(DEFAULT_INTAKE_WINDOW_S if args.window_ms is None
                      else args.window_ms / 1000.0),
            max_batch=args.max_batch or DEFAULT_MAX_BATCH,
            url_ttl_s=args.url_ttl_s or DEFAULT_TTL_S,
        ))
    print(f"serving VSS store at {service.url}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        service.close()
        vss.close()


if __name__ == "__main__":  # pragma: no cover
    main()
