"""Bundled HTTP object server — the wire side of `RemoteBackend`.

A minimal object protocol over plain HTTP/1.1, small enough that the
stdlib `http.server` machinery serves it and any S3/GCS-shaped store
could re-implement it:

    PUT    /o/<key>                store the request body under <key>
    GET    /o/<key>                full object; honours ``Range:
                                   bytes=a-b`` with a 206 partial
                                   response (partial GOP reads)
    HEAD   /o/<key>                existence + Content-Length, no body
    DELETE /o/<key>                idempotent delete (204 either way)
    GET    /list?prefix=<p>        newline-separated keys under <p>
    POST   /rename?src=<a>&dst=<b> server-side atomic commit: move the
                                   object at <a> to <b> (404 if <a> is
                                   missing)
    GET    /metrics                Prometheus text exposition of the
                                   attached `repro_torch.obs` registry
    GET    /healthz                JSON health report (200 ok /
                                   503 degraded) from the attached
                                   health callback

``/metrics`` and ``/healthz`` answer 404 unless the server was built
with a ``registry`` / ``health`` callback; `VSS.start_metrics_server`
builds a store-less instance (object routes answer 503) that serves
only the observability pair.

For untrusted networks the server optionally takes a shared ``secret``
(every object-plane request must then carry a valid
`repro_torch.storage.signing.RequestSigner` signature; 401 otherwise — the
observability pair stays open) and an ``ssl_context`` for TLS
(``--certfile``/``--keyfile`` standalone).  Listings hide the
server-private namespaces (``_rtmp/`` temps, ``_layout/``,
``_journal/``) unless the request prefix explicitly reaches into one.

Keys are URL-quoted path segments (``/`` survives).  Storage-level
misses answer 404, anything else a backend raises answers 500 — which
is exactly what `RemoteBackend`'s retry loop keys off, so server-side
fault injection is just wrapping the backing store in a
`FaultInjectingBackend`.

``/rename`` exists for the client's idempotency-safe put protocol:
uploads land under a unique temp key and commit with one rename, so a
retried upload never tears a live object and a crash between upload
and commit leaves only a temp turd for `RemoteBackend.sweep_temps`.
The handler serializes renames per destination key; the move itself is
get+put+delete on the backing store, whose atomic per-object ``put``
keeps readers of the destination on complete bytes.

The server composes over any `StorageBackend` (``--backend`` takes the
full `make_backend` spec grammar; default: a `LocalFSBackend` under
``--root``), which is also how `make_backend`'s plain ``remote`` spec
self-hosts a loopback instance per store.  Standalone (for benchmarks
against a real network hop):

    python -m repro_torch.storage.httpserver --root /data/objects --port 8080
    python -m repro_torch.storage.httpserver --root /data/objects \
        --backend replicated:3 --metrics
"""
from __future__ import annotations

import json
import re
import ssl
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.storage.base import ObjectNotFound, StorageBackend
from repro_torch.storage.signing import EXP_HEADER, RequestSigner, SIG_HEADER

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")

# server-private namespaces hidden from listings: uncommitted temp
# uploads (a listing consumed by scrub/recovery must never treat one
# as a live object), the store-identity key, and write-back journal
# state.  A caller that names a reserved namespace explicitly (the
# client's own sweep_temps lists ``_rtmp/``) still sees inside it.
_HIDDEN_PREFIXES = ("_rtmp/", "_layout/", "_journal/")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "vss-object-server/1"

    # the ThreadingHTTPServer subclass carries the backing store
    @property
    def store(self) -> Optional[StorageBackend]:
        return self.server.store  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # pragma: no cover - silence
        pass

    # -- helpers -----------------------------------------------------------
    def _authorized(self) -> bool:
        """Signed-request check (when the server has a signer).  The
        MAC covers method + full path-with-query + expiry, so a token
        cannot be replayed across verbs or re-aimed at another key.
        ``/metrics`` and ``/healthz`` stay open — they are the
        observability plane, carry no object data, and scrapers don't
        sign.  401s close the connection: the request may carry an
        unread body (PUT), and an unauthenticated peer gets no
        keep-alive courtesy."""
        signer = self.server.signer  # type: ignore[attr-defined]
        if signer is None:
            return True
        bare = urllib.parse.urlsplit(self.path).path
        if bare in ("/metrics", "/healthz"):
            return True
        reason = signer.verify(
            self.command, self.path,
            self.headers.get(EXP_HEADER), self.headers.get(SIG_HEADER),
        )
        if reason is None:
            self.server.count_auth(True)  # type: ignore[attr-defined]
            return True
        self.server.count_auth(False)  # type: ignore[attr-defined]
        self._respond(401, reason.encode(), close=True)
        return False

    def _key(self) -> Optional[str]:
        path = urllib.parse.urlsplit(self.path).path
        if not path.startswith("/o/"):
            # the request may carry an unread body (PUT): drop the
            # connection rather than desync the keep-alive stream
            self._respond(400, b"bad path", close=True)
            return None
        if self.store is None:
            # metrics-only server: no object plane behind it
            self._respond(503, b"no object store", close=True)
            return None
        return urllib.parse.unquote(path[len("/o/"):])

    def _query(self) -> dict:
        q = urllib.parse.urlsplit(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}

    def _respond(self, status: int, body: bytes = b"",
                 length: Optional[int] = None,
                 extra: Optional[dict] = None, close: bool = False):
        """``length`` declares a Content-Length with no body (HEAD).
        ``close`` drops the keep-alive connection after the response —
        required whenever we answer BEFORE consuming a request body
        (the unread bytes would otherwise be parsed as the next
        request line, desyncing every later exchange on the socket)."""
        if close:
            self.close_connection = True
        self.send_response(status)
        if close:
            self.send_header("Connection", "close")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.send_header(
            "Content-Length", str(len(body) if length is None else length)
        )
        self.end_headers()
        # a HEAD response never carries a body (whatever Content-Length
        # declares) — writing one would desync the keep-alive stream
        if body and length is None and self.command != "HEAD":
            self.wfile.write(body)

    def _guard(self, fn, *args, missing_status: int = 404):
        """Run a store operation; map a miss to 404 and any other
        backend failure to 500 (the client's retryable class)."""
        try:
            return True, fn(*args)
        except ObjectNotFound as exc:
            self._respond(missing_status, str(exc).encode())
        except Exception as exc:  # noqa: BLE001 - wire boundary
            self._respond(500, f"{type(exc).__name__}: {exc}".encode())
        return False, None

    # -- verbs -------------------------------------------------------------
    def do_GET(self):
        if not self._authorized():
            return
        path = urllib.parse.urlsplit(self.path).path
        if path == "/metrics":
            registry = self.server.registry  # type: ignore[attr-defined]
            if registry is None:
                self._respond(404, b"no metrics registry attached")
                return
            body = registry.render_prometheus().encode()
            self._respond(200, body, extra={
                "Content-Type": "text/plain; version=0.0.4; charset=utf-8"
            })
            return
        if path == "/healthz":
            health = self.server.health  # type: ignore[attr-defined]
            if health is None:
                self._respond(404, b"no health callback attached")
                return
            try:
                report = health()
                status = 200 if report.get("status") == "ok" else 503
            except Exception as exc:  # noqa: BLE001 - wire boundary
                report = {"status": "error",
                          "error": f"{type(exc).__name__}: {exc}"}
                status = 503
            self._respond(status, json.dumps(report, indent=2).encode(),
                          extra={"Content-Type": "application/json"})
            return
        if path == "/list":
            if self.store is None:
                self._respond(503, b"no object store", close=True)
                return
            prefix = self._query().get("prefix", "")
            ok, keys = self._guard(self.store.list, prefix)
            if ok:
                if not prefix.startswith(_HIDDEN_PREFIXES):
                    keys = [k for k in keys
                            if not k.startswith(_HIDDEN_PREFIXES)]
                self._respond(200, "\n".join(sorted(keys)).encode())
            return
        key = self._key()
        if key is None:
            return
        ok, data = self._guard(self.store.get, key)
        if not ok:
            return
        rng = self.headers.get("Range")
        if rng:
            m = _RANGE_RE.match(rng.strip())
            if not m or int(m.group(1)) >= len(data):
                self._respond(416, b"", extra={
                    "Content-Range": f"bytes */{len(data)}"
                })
                return
            a = int(m.group(1))
            b = int(m.group(2)) + 1 if m.group(2) else len(data)
            b = min(b, len(data))
            self._respond(206, data[a:b], extra={
                "Content-Range": f"bytes {a}-{b - 1}/{len(data)}"
            })
            return
        self._respond(200, data)

    def do_HEAD(self):
        if not self._authorized():
            return
        key = self._key()
        if key is None:
            return
        ok, st = self._guard(self.store.stat, key)
        if ok:
            self._respond(200, length=st.nbytes)

    def do_PUT(self):
        if not self._authorized():
            return
        key = self._key()
        if key is None:
            return
        length = self.headers.get("Content-Length")
        if length is None:
            # unread (possibly chunked) body: close, don't desync
            self._respond(411, b"length required", close=True)
            return
        try:
            data = self.rfile.read(int(length))
            if len(data) != int(length):
                raise ConnectionError("short read")
        except Exception:
            # a client that died mid-upload: nothing reaches the store
            self._respond(400, b"truncated upload", close=True)
            return
        ok, _ = self._guard(self.store.put, key, data)
        if ok:
            self._respond(204)

    def do_DELETE(self):
        if not self._authorized():
            return
        key = self._key()
        if key is None:
            return
        ok, _ = self._guard(self.store.delete, key)
        if ok:
            self._respond(204)

    def do_POST(self):
        if not self._authorized():
            return
        path = urllib.parse.urlsplit(self.path).path
        if path != "/rename":
            self._respond(400, b"bad path", close=True)
            return
        if self.store is None:
            self._respond(503, b"no object store", close=True)
            return
        q = self._query()  # parse_qs already URL-decoded the values
        src, dst = q.get("src"), q.get("dst")
        if not src or not dst:
            self._respond(400, b"rename needs src and dst")
            return
        lock = self.server.rename_lock(dst)  # type: ignore[attr-defined]
        with lock:
            ok, data = self._guard(self.store.get, src)
            if not ok:
                return
            ok, _ = self._guard(self.store.put, dst, data)
            if not ok:
                return
            ok, _ = self._guard(self.store.delete, src)
            if ok:
                self._respond(204)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, store: Optional[StorageBackend],
                 registry=None, health: Optional[Callable] = None,
                 signer: Optional[RequestSigner] = None):
        super().__init__(addr, _Handler)
        self.store = store
        self.registry = registry
        self.health = health
        self.signer = signer
        self._rename_locks: dict = {}
        self._rename_locks_guard = threading.Lock()
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._c_auth_accepted = reg.counter(
            "vss_remote_auth_accepted_total",
            "object-protocol requests with a valid signature")
        self._c_auth_rejected = reg.counter(
            "vss_remote_auth_rejected_total",
            "object-protocol requests rejected 401"
            " (missing/bad/expired signature)")

    def count_auth(self, ok: bool) -> None:
        (self._c_auth_accepted if ok else self._c_auth_rejected).inc()

    def rename_lock(self, dst: str) -> threading.Lock:
        with self._rename_locks_guard:
            if len(self._rename_locks) > 4096:
                # bound the map, but never discard a HELD lock — a
                # slow rename still inside it would lose its per-dst
                # serialization and could resurrect stale bytes
                self._rename_locks = {
                    k: lk for k, lk in self._rename_locks.items()
                    if lk.locked()
                }
            return self._rename_locks.setdefault(dst, threading.Lock())


class ObjectServer:
    """A running object server over a `StorageBackend`.

    Binds ``host:port`` (port 0 picks an ephemeral port) and serves on
    a daemon thread; ``url`` is what `RemoteBackend` connects to.  The
    backing store is shared state — the server never copies it — so a
    test can reach behind the wire (tear an object, count ops, inject
    faults via `FaultInjectingBackend`) while the client speaks HTTP.

    ``registry`` (a `repro_torch.obs.MetricsRegistry`) activates ``GET
    /metrics``; ``health`` (a zero-arg callable returning a dict with
    a ``"status"`` key) activates ``GET /healthz``.  ``store=None``
    builds a metrics-only server whose object routes answer 503.

    Untrusted networks: ``secret`` (bytes) requires every object-plane
    request to carry a valid `repro_torch.storage.signing.RequestSigner`
    signature (401 otherwise, counted on
    ``vss_remote_auth_rejected_total``); ``ssl_context`` (a server-side
    `ssl.SSLContext` loaded with a certificate chain + key) serves
    TLS, flipping ``url`` to ``https://``.
    """

    def __init__(self, store: Optional[StorageBackend], *,
                 host: str = "127.0.0.1", port: int = 0,
                 registry=None, health: Optional[Callable] = None,
                 secret: Optional[bytes] = None,
                 sig_ttl_s: Optional[float] = None,
                 ssl_context: Optional[ssl.SSLContext] = None):
        from repro_torch.storage.signing import DEFAULT_SIG_TTL_S

        self.store = store
        signer = None
        if secret:
            signer = RequestSigner(
                secret,
                ttl_s=DEFAULT_SIG_TTL_S if sig_ttl_s is None else sig_ttl_s,
            )
        self._tls = ssl_context is not None
        self._httpd = _Server((host, port), store,
                              registry=registry, health=health,
                              signer=signer)
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True
            )
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="vss-object-server",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


def main(argv=None) -> None:  # pragma: no cover - operational entry point
    import argparse
    import os

    from repro_torch.obs.registry import default_registry
    from repro_torch.storage import make_backend

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="directory for the backing store's objects")
    ap.add_argument(
        "--backend", default="localfs",
        help="make_backend spec for the backing store (e.g. 'localfs',"
        " 'memory', 'sharded:8', 'tiered:sharded:4',"
        " 'replicated:3:3:2'); default localfs",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--metrics", action="store_true",
                    help="also serve GET /metrics from the process-global"
                    " registry")
    ap.add_argument("--certfile", default=None,
                    help="TLS certificate chain (PEM); with --keyfile,"
                    " serves https")
    ap.add_argument("--keyfile", default=None,
                    help="TLS private key (PEM)")
    ap.add_argument("--secret-env", default="VSS_REMOTE_SECRET",
                    help="env var holding the shared request-signing"
                    " secret; set it to require signed requests"
                    " (401 otherwise)")
    args = ap.parse_args(argv)
    registry = default_registry() if args.metrics else None
    ssl_context = None
    if args.certfile:
        import ssl as _ssl

        ssl_context = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(args.certfile, args.keyfile)
    secret = os.environ.get(args.secret_env, "").encode() or None
    store = make_backend(args.backend, args.root, registry=registry)
    server = ObjectServer(store, host=args.host, port=args.port,
                          registry=registry, secret=secret,
                          ssl_context=ssl_context)
    print(f"serving {args.backend} under {args.root} at {server.url}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.close()
        store.close()


if __name__ == "__main__":  # pragma: no cover
    main()
