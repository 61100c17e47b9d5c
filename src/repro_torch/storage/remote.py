"""HTTP object-store backend — the remote cold tier.

`RemoteBackend` speaks the minimal object protocol served by
`repro_torch.storage.httpserver` (PUT/GET/HEAD/DELETE + prefix list + ranged
GET + server-side rename) over pooled stdlib `http.client`
connections — no third-party HTTP stack.  It is the S3/GCS-shaped end
of the `StorageBackend` contract the rest of the matrix already fits:
``kind_for`` answers ``"remote"`` so `CostModel.io_cost` prices its
fetches as round-trip latency + WAN-ish throughput, and the §3 planner
prefers locally-cached fragments whenever `TieredBackend` fronts it.

Retry policy
  Every request retries on connection errors and 5xx responses with
  bounded exponential backoff (``backoff_base * 2^attempt`` capped at
  ``backoff_max``, ``max_retries`` attempts after the first); 4xx
  responses never retry — they are protocol answers (404 is a miss),
  not transport weather.  Reads, stats, lists and deletes are
  idempotent, so blind retry is safe.

Untrusted networks (TLS + signed requests)
  An ``https://`` URL speaks TLS (stdlib ``ssl``; pass ``ca_file`` to
  trust a self-signed server certificate, or a full ``ssl_context``).
  A ``secret`` signs every request with `repro_torch.storage.signing`'s
  HMAC scheme (method + path + expiry in ``X-VSS-Exp``/``X-VSS-Sig``
  headers, re-signed per retry attempt); the server's 401 raises
  `RemoteAuthError` immediately — auth failures are configuration
  errors and are NEVER retried.  ``make_backend``'s ``remotes:<url>``
  spec is the TLS+auth composition of this backend.

Idempotency-safe puts (publish-then-index friendly)
  ``put`` uploads to a unique temp key under ``_rtmp/`` and commits
  with one server-side rename.  A retried upload can therefore never
  tear a live object (each attempt owns its temp key, the destination
  only ever changes through the server's atomic rename), and a rename
  whose 204 was lost in transit is reconciled on retry: source gone +
  destination holding exactly the uploaded bytes means the commit
  already happened.  A crash between upload and commit leaves a temp
  turd that ``sweep_temps`` — run by every startup recovery — removes;
  the destination key is untouched, so indexed objects never dangle.

Concurrency
  The connection pool (and the ``batch_get``/``batch_put`` fan-out
  executor) is sized by ``connections`` and re-sized by
  ``configure_concurrency`` — `VSS` wires it to ``ingest_workers`` so
  the pipelined ingest path gets one connection per publishing worker
  instead of serializing windows behind a single socket.

Hedged GETs (tail-latency insurance)
  With ``hedge_threshold`` set, a ``get`` that has not answered within
  the threshold launches ONE duplicate request and the first response
  wins — the classic tail-at-scale defense, safe because object GETs
  are idempotent and every committed object is immutable.  A 404 from
  either request is authoritative (the store speaking, not the
  network) and short-circuits.  Hedges ride a dedicated executor so a
  saturated ``batch_get`` fan-out can never deadlock against its own
  hedges; ``vss_remote_hedges_total`` / ``vss_remote_hedge_wins_total``
  count launches and races the duplicate actually won.  Off by default:
  hedging trades duplicate load for p99, which is the serving tier's
  call, not the storage layer's.

``RemoteBackend.self_hosted(root)`` bundles an in-process loopback
`ObjectServer` over a `LocalFSBackend` under ``root`` — what the plain
``remote`` spec in `make_backend` builds, so the whole tier-1 suite and
the CI backend matrix run against a real HTTP hop with zero external
setup.  ``remote:<url>`` connects to an external server instead.
"""
from __future__ import annotations

import http.client
import itertools
import os
import socket
import ssl
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import (
    FIRST_COMPLETED,
    ThreadPoolExecutor,
    TimeoutError as FutureTimeout,
    wait as wait_futures,
)
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.storage.base import (
    ObjectNotFound,
    ObjectStat,
    RangeNotSatisfiable,
    StorageBackend,
    validate_key,
)
from repro_torch.storage.signing import DEFAULT_SIG_TTL_S, RequestSigner

TEMP_PREFIX = "_rtmp/"  # uncommitted uploads live here (swept at startup)
LAYOUT_KEY = "_layout/id"  # server-side store identity (layout guard)
JOURNAL_PREFIX = "_journal/"  # write-back journal segments (local state)
_RESERVED_PREFIXES = (TEMP_PREFIX, "_layout/", JOURNAL_PREFIX)

DEFAULT_CONNECTIONS = 4
DEFAULT_MAX_RETRIES = 4
DEFAULT_BACKOFF_BASE = 0.05
DEFAULT_BACKOFF_MAX = 2.0
DEFAULT_TIMEOUT = 30.0

# transport-level failures worth a retry (the server being mid-restart,
# a dropped keep-alive socket, a half-open connection)
_RETRYABLE_EXCS = (http.client.HTTPException, ConnectionError,
                   socket.timeout, socket.error, OSError)


def _size_from_416(content_range: Optional[str]) -> Optional[int]:
    """Object size from a 416's ``Content-Range: bytes */<size>``."""
    if not content_range or not content_range.startswith("bytes */"):
        return None
    try:
        return int(content_range[len("bytes */"):])
    except ValueError:
        return None


def _expected_partial_len(content_range: Optional[str], start: int,
                          length: int) -> Optional[int]:
    """How many bytes a well-formed 206 for ``[start, start+length)``
    must carry, from its ``Content-Range: bytes a-b/total``.  None when
    the header is missing/malformed or names a different window — the
    caller treats that as unverifiable and retries."""
    if not content_range or not content_range.startswith("bytes "):
        return None
    try:
        span, _, total_s = content_range[len("bytes "):].partition("/")
        a_s, _, b_s = span.partition("-")
        a, b, total = int(a_s), int(b_s), int(total_s)
    except ValueError:
        return None
    if a != start or b < a or b >= total:
        return None
    expect = b - a + 1
    if expect > length or expect < min(length, total - start):
        return None  # server answered a window we did not ask for
    return expect


class RemoteError(IOError):
    """A request exhausted its retries (last cause attached)."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class RemoteAuthError(RemoteError):
    """The server rejected the request's authentication (HTTP 401).

    Terminal on the FIRST response — never retried: a missing or wrong
    secret is a configuration error, and an expired signature means
    re-signing (which every attempt does anyway), so a retry budget
    spent on 401s could only mask the misconfiguration."""


class _Response:
    __slots__ = ("status", "data", "length", "content_range")

    def __init__(self, status: int, data: bytes, length: Optional[int],
                 content_range: Optional[str] = None):
        self.status = status
        self.data = data
        self.length = length  # Content-Length header (HEAD has no body)
        self.content_range = content_range  # 206 partial responses


class RemoteBackend(StorageBackend):
    KIND = "remote"

    def __init__(
        self,
        url: str,
        *,
        connections: int = DEFAULT_CONNECTIONS,
        max_retries: int = DEFAULT_MAX_RETRIES,
        backoff_base: float = DEFAULT_BACKOFF_BASE,
        backoff_max: float = DEFAULT_BACKOFF_MAX,
        timeout: float = DEFAULT_TIMEOUT,
        hedge_threshold: Optional[float] = None,
        secret: Optional[bytes] = None,
        sig_ttl_s: float = DEFAULT_SIG_TTL_S,
        ssl_context: Optional[ssl.SSLContext] = None,
        ca_file: Optional[str] = None,
        registry=None,
        _owned_server=None,
    ):
        if hedge_threshold is not None and hedge_threshold <= 0:
            raise ValueError(
                f"hedge_threshold must be positive, got {hedge_threshold}"
            )
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"RemoteBackend needs an http(s):// url, got"
                             f" {url!r}")
        if parts.path not in ("", "/"):
            raise ValueError(
                f"RemoteBackend url must not carry a path, got {url!r}"
                " (the object protocol owns the whole namespace)"
            )
        self.url = url.rstrip("/")
        self.host = parts.hostname
        self.tls = parts.scheme == "https"
        self.port = parts.port or (443 if self.tls else 80)
        # TLS client context: an explicit ssl.SSLContext wins; else a
        # default-verifying context, trusting ``ca_file`` when given
        # (how a self-signed deployment pins its server certificate)
        self._ssl_context: Optional[ssl.SSLContext] = None
        if self.tls:
            self._ssl_context = (
                ssl_context if ssl_context is not None
                else ssl.create_default_context(cafile=ca_file)
            )
        self._signer = (
            RequestSigner(secret, ttl_s=sig_ttl_s)
            if secret else None
        )
        self.max_retries = max(0, int(max_retries))
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.timeout = timeout
        self.hedge_threshold = hedge_threshold
        self._server = _owned_server  # self-hosted loopback instance
        self._connections = max(1, int(connections))
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._counter = itertools.count()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        # transport telemetry (repro_torch.obs); `retries` stays readable as a
        # plain attribute (it is a thin view over the registry handle)
        from repro_torch.obs.registry import default_registry

        reg = registry or default_registry()
        self._c_retries = reg.counter(
            "vss_remote_retries_total",
            "transport retries (connection errors + 5xx)")
        self._c_conns_created = reg.counter(
            "vss_remote_connections_created_total",
            "new sockets opened because the idle pool was empty")
        self._c_pool_overflow = reg.counter(
            "vss_remote_pool_overflow_total",
            "connections closed on return because the pool was full"
            " (fan-out exceeded the configured pool size)")
        self._c_hedges = reg.counter(
            "vss_remote_hedges_total",
            "duplicate GETs launched past the hedge threshold")
        self._c_hedge_wins = reg.counter(
            "vss_remote_hedge_wins_total",
            "hedged GETs answered first by the duplicate request")

    @classmethod
    def self_hosted(cls, root: str, **kw) -> "RemoteBackend":
        """Spin an in-process loopback `ObjectServer` over a LocalFS
        store under ``root`` and connect to it.  ``close()`` shuts the
        server down; reopening the same ``root`` re-hosts the same
        objects (persistence lives in the files, not the process).
        A ``secret`` arms signed-request auth on BOTH ends, so the
        loopback composition exercises the same wire auth a real
        deployment runs."""
        from repro_torch.storage.httpserver import ObjectServer
        from repro_torch.storage.localfs import LocalFSBackend

        kw.pop("ca_file", None)  # loopback is plain http
        server_kw = {}
        if kw.get("secret"):
            server_kw["secret"] = kw["secret"]
            if kw.get("sig_ttl_s") is not None:
                server_kw["sig_ttl_s"] = kw["sig_ttl_s"]
        server = ObjectServer(LocalFSBackend(root), **server_kw)
        return cls(server.url, _owned_server=server, **kw)

    # -- connection pool ---------------------------------------------------
    def configure_concurrency(self, n: int) -> None:
        """Grow the connection pool (and fan-out executor) to cover
        ``n`` concurrent operators — `VSS` passes ``ingest_workers``.
        A minimum hint, never a shrink: two ingest workers must not
        clamp the read fan-out (or an explicit ``connections=32``)
        down to two sockets."""
        n = max(1, int(n))
        with self._lock:
            if n <= self._connections:
                return
            self._connections = n
            pool, self._pool = self._pool, None
        if pool is not None:  # re-created on demand at the new size
            pool.shutdown(wait=False)

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._connections,
                    thread_name_prefix="vss-remote",
                )
            return self._pool

    def _hedge_executor(self) -> ThreadPoolExecutor:
        """Hedged GETs run on their own pool: ``batch_get`` saturating
        the fan-out executor with gets that each wait on a nested
        future would deadlock against itself."""
        with self._lock:
            if self._hedge_pool is None:
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=max(4, self._connections * 2),
                    thread_name_prefix="vss-remote-hedge",
                )
            return self._hedge_pool

    @property
    def retries(self) -> int:
        """Transport retries performed (view over the registry counter)."""
        return int(self._c_retries.value)

    @property
    def hedges(self) -> int:
        """Duplicate GETs launched (view over the registry counter)."""
        return int(self._c_hedges.value)

    @property
    def hedge_wins(self) -> int:
        """Hedged GETs the duplicate answered first."""
        return int(self._c_hedge_wins.value)

    def _borrow(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        self._c_conns_created.inc()
        if self.tls:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=self._ssl_context,
            )
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )

    def _give_back(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self._connections:
                self._idle.append(conn)
                return
        self._c_pool_overflow.inc()
        conn.close()

    # -- request core ------------------------------------------------------
    def _request(
        self, method: str, path: str, body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> _Response:
        """One request with bounded exponential-backoff retries on
        connection errors and 5xx.  4xx answers return to the caller —
        they are the protocol speaking, not the network failing — and
        401 raises `RemoteAuthError` immediately (misconfigured or
        missing secret; retrying cannot help and would hide it)."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._c_retries.inc()
                time.sleep(min(self.backoff_max,
                               self.backoff_base * (2 ** (attempt - 1))))
            hdrs = dict(headers or {})
            if self._signer is not None:
                # sign per attempt: a retry delayed past the signature
                # TTL must not 401 on a stale expiry
                hdrs.update(self._signer.headers(method, path))
            conn = self._borrow()
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except _RETRYABLE_EXCS as exc:
                conn.close()
                last = exc
                continue
            if resp.status == 401:
                self._give_back(conn)
                raise RemoteAuthError(
                    f"{method} {path} -> 401:"
                    f" {data[:200].decode(errors='replace')}"
                    f" (shared secret missing or wrong — not retried)"
                )
            if resp.status >= 500:
                self._give_back(conn)
                last = RemoteError(
                    f"{method} {path} -> {resp.status}:"
                    f" {data[:200].decode(errors='replace')}"
                )
                continue
            self._give_back(conn)
            clen = resp.getheader("Content-Length")
            return _Response(resp.status, data,
                             None if clen is None else int(clen),
                             resp.getheader("Content-Range"))
        raise RemoteError(
            f"{method} {path} failed after {self.max_retries + 1}"
            f" attempts: {last}", last,
        )

    @staticmethod
    def _opath(key: str) -> str:
        return "/o/" + urllib.parse.quote(validate_key(key), safe="/")

    def batch_get_ranges(
        self, reqs: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        """Overlap ranged round-trips across the connection pool, the
        way ``batch_get`` overlaps full fetches."""
        reqs = list(reqs)
        if len(reqs) <= 1:
            return [self.get_range(*r) for r in reqs]
        return list(self._executor().map(
            lambda r: self.get_range(*r), reqs
        ))

    # -- contract ----------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        """Upload to a unique temp key, commit with a server-side
        rename — see the module docstring for why both halves retry
        safely."""
        self._opath(key)  # reject bad destination keys before uploading
        tmp = (f"{TEMP_PREFIX}{uuid.uuid4().hex}-{os.getpid()}"
               f"-{next(self._counter)}")
        r = self._request("PUT", self._opath(tmp), body=bytes(data),
                          headers={"Content-Type":
                                   "application/octet-stream"})
        if r.status != 204:
            raise RemoteError(f"PUT {key!r} -> {r.status}")
        q = urllib.parse.urlencode({"src": tmp, "dst": key})
        r = self._request("POST", f"/rename?{q}")
        if r.status == 404:
            # a retried rename whose first 204 was lost: the source is
            # gone — accept iff the destination holds EXACTLY our
            # bytes.  A size check alone could bless a same-length
            # stale object (same-size GOP rewrites are routine), so
            # this rare path pays one full GET to compare content.
            try:
                if self.get(key) == data:
                    return
            except ObjectNotFound:
                pass
            raise RemoteError(f"rename commit lost for {key!r}")
        if r.status != 204:
            raise RemoteError(f"rename {key!r} -> {r.status}")

    def get(self, key: str) -> bytes:
        if self.hedge_threshold is None:
            return self._get_once(key)
        return self._hedged_get(key)

    def _get_once(self, key: str) -> bytes:
        r = self._request("GET", self._opath(key))
        if r.status == 404:
            raise ObjectNotFound(key)
        if r.status != 200:
            raise RemoteError(f"GET {key!r} -> {r.status}")
        return r.data

    def _hedged_get(self, key: str) -> bytes:
        """First-response-wins duplicate GET once the primary is slower
        than ``hedge_threshold``.  404 short-circuits (authoritative);
        a transport failure on one request waits for the other, and the
        primary's error is re-raised only when both lose."""
        ex = self._hedge_executor()
        primary = ex.submit(self._get_once, key)
        try:
            return primary.result(timeout=self.hedge_threshold)
        except FutureTimeout:
            pass  # slow primary: race a duplicate
        self._c_hedges.inc()
        pending = {primary, ex.submit(self._get_once, key)}
        while pending:
            done, pending = wait_futures(
                pending, return_when=FIRST_COMPLETED
            )
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    if fut is not primary:
                        self._c_hedge_wins.inc()
                    return fut.result()
                if isinstance(exc, ObjectNotFound):
                    raise exc
        raise primary.exception()  # both exhausted their retries

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged GET (``Range: bytes=start-end``): fetch ``length``
        bytes at ``start`` without pulling the whole object — the
        transport behind sub-GOP reads over a slow link.

        A 206 body is verified against its ``Content-Range`` before
        being returned: a truncated partial body (proxy bug, server
        mid-restart) is indistinguishable from a legitimate short tail
        by length alone, so a mismatch retries with the same
        backoff/budget as any other transient failure instead of
        handing corrupt bytes to the decoder."""
        if start < 0 or length < 1:
            raise ValueError(f"bad range start={start} length={length}")
        end = start + length - 1
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._c_retries.inc()
                time.sleep(min(self.backoff_max,
                               self.backoff_base * (2 ** (attempt - 1))))
            r = self._request("GET", self._opath(key),
                              headers={"Range": f"bytes={start}-{end}"})
            if r.status == 404:
                raise ObjectNotFound(key)
            if r.status == 416:
                raise RangeNotSatisfiable(
                    key, start, _size_from_416(r.content_range))
            if r.status == 200:
                # a server that ignores Range answers 200 + full body;
                # slice client-side rather than hand back the whole
                # object as if it were the requested window
                if start >= len(r.data):
                    raise RangeNotSatisfiable(key, start, len(r.data))
                return r.data[start:start + length]
            if r.status != 206:
                raise RemoteError(f"ranged GET {key!r} -> {r.status}")
            expect = _expected_partial_len(r.content_range, start, length)
            if expect is not None and len(r.data) == expect:
                return r.data
            last = RemoteError(
                f"short/unverifiable 206 body for {key!r}: got"
                f" {len(r.data)} bytes, Content-Range {r.content_range!r}"
            )
        raise RemoteError(
            f"ranged GET {key!r} failed after {self.max_retries + 1}"
            f" attempts: {last}", last,
        )

    def stat(self, key: str) -> ObjectStat:
        # the size travels in the HEAD response's Content-Length (HEAD
        # bodies are empty by spec)
        r = self._request("HEAD", self._opath(key))
        if r.status == 404:
            raise ObjectNotFound(key)
        if r.status != 200:
            raise RemoteError(f"HEAD {key!r} -> {r.status}")
        return ObjectStat(key, r.length or 0)

    def delete(self, key: str) -> None:
        r = self._request("DELETE", self._opath(key))
        if r.status not in (204, 404):
            raise RemoteError(f"DELETE {key!r} -> {r.status}")

    def list(self, prefix: str = "") -> List[str]:
        q = urllib.parse.urlencode({"prefix": prefix})
        r = self._request("GET", f"/list?{q}")
        if r.status != 200:
            raise RemoteError(f"list {prefix!r} -> {r.status}")
        text = r.data.decode()
        return [
            k for k in text.split("\n")
            if k and not k.startswith(_RESERVED_PREFIXES)
        ]

    # -- fan-out -----------------------------------------------------------
    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        """Overlap round-trips across the connection pool — the whole
        point of a pooled remote store for §3 multi-fragment plans."""
        keys = list(keys)
        if len(keys) <= 1:
            return [self.get(k) for k in keys]
        return list(self._executor().map(self.get, keys))

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        items = list(items)
        if len(items) <= 1:
            for key, data in items:
                self.put(key, data)
            return
        list(self._executor().map(lambda kv: self.put(*kv), items))

    # -- maintenance -------------------------------------------------------
    def sweep_temps(self) -> int:
        """Remove uncommitted uploads (crash between upload and rename)
        — the remote half of startup recovery."""
        q = urllib.parse.urlencode({"prefix": TEMP_PREFIX})
        r = self._request("GET", f"/list?{q}")
        if r.status != 200:
            raise RemoteError(f"temp sweep list -> {r.status}")
        temps = [k for k in r.data.decode().split("\n") if k]
        for key in temps:
            self.delete(key)
        return len(temps)

    def layout_fingerprint(self) -> str:
        """``remote:<server store id>`` — the identity lives ON the
        server (a persistent `_layout/id` object minted at first use),
        not in the URL: the self-hosted loopback server binds a fresh
        port every run yet serves the same objects, while a typo'd or
        migrated URL points at a DIFFERENT store whose catalog rows
        would all scavenge as lost.  A constant fingerprint here would
        let that reopen pass the `VSS` layout guard and silently wipe
        both the catalog and the other server's objects; the minted id
        makes it fail loudly instead.  (The id key is hidden from
        ``list`` so the orphan sweep never collects it.)"""
        r = self._request("GET", self._opath(LAYOUT_KEY))
        if r.status == 404:
            # first use: mint an identity.  Two clients racing the
            # mint both re-read afterwards, so they agree on whichever
            # write landed last.
            self.put(LAYOUT_KEY, uuid.uuid4().hex.encode())
            r = self._request("GET", self._opath(LAYOUT_KEY))
        if r.status != 200:
            raise RemoteError(f"layout id fetch -> {r.status}")
        return f"remote:{r.data.decode(errors='replace')}"

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
            pool, self._pool = self._pool, None
            hedge_pool, self._hedge_pool = self._hedge_pool, None
        for conn in idle:
            conn.close()
        if pool is not None:
            pool.shutdown(wait=False)
        if hedge_pool is not None:
            hedge_pool.shutdown(wait=False)
        if self._server is not None:
            self._server.close()
            self._server = None
