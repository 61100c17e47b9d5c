"""HMAC signed-request auth for the object protocol.

`serving.signing.UrlSigner` signs *URLs* — capability tokens handed to
clients for a single data-plane fetch.  The storage wire needs the
sibling scheme: every request a `RemoteBackend` sends to an
auth-enabled `ObjectServer` carries a MAC over the request itself,
proving the caller holds the shared store secret:

    X-VSS-Exp: <unix expiry>
    X-VSS-Sig: HMAC-SHA256(secret, "<METHOD>|<path?query>|<exp>")

Properties
  * the MAC covers the **method and the full path including the query
    string**, so a captured ``GET /o/k`` token cannot be replayed as a
    ``DELETE``, and a ``/rename?src=a&dst=b`` cannot be re-aimed at a
    different destination;
  * expiry is inside the MAC — extending ``X-VSS-Exp`` invalidates the
    signature — and bounds the replay window of a captured request
    (idempotent verbs make replay-within-window harmless);
  * verification is constant-time (`hmac.compare_digest`);
  * the secret is provisioned out of band (``VSSConfig.remote.secret``
    or the ``VSS_REMOTE_SECRET`` env var) and shared by both ends:
    this is S3-SigV4-shaped symmetric auth, not a PKI.

Auth failures answer **401 and are never retried** — a wrong secret is
a configuration error, not transport weather, and hammering the server
with doomed retries would only hide it.
"""
from __future__ import annotations

import hashlib
import hmac
import time
from typing import Dict, Optional

DEFAULT_SIG_TTL_S = 300.0

EXP_HEADER = "X-VSS-Exp"
SIG_HEADER = "X-VSS-Sig"


class RequestSigner:
    """Signs and verifies object-protocol requests with a shared secret."""

    def __init__(self, secret: bytes, ttl_s: float = DEFAULT_SIG_TTL_S):
        if not secret:
            raise ValueError("request-signing secret must be non-empty")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.secret = bytes(secret)
        self.ttl_s = float(ttl_s)

    def _mac(self, method: str, path: str, exp: int) -> str:
        msg = f"{method.upper()}|{path}|{exp}".encode()
        return hmac.new(self.secret, msg, hashlib.sha256).hexdigest()

    def headers(self, method: str, path: str,
                *, now: Optional[float] = None) -> Dict[str, str]:
        """Auth headers for one request.  ``path`` is the full request
        target as sent on the wire (path + query)."""
        exp = int((time.time() if now is None else now) + self.ttl_s)
        return {EXP_HEADER: str(exp),
                SIG_HEADER: self._mac(method, path, exp)}

    def verify(self, method: str, path: str, exp: Optional[str],
               sig: Optional[str],
               *, now: Optional[float] = None) -> Optional[str]:
        """None when the request is authentic; otherwise a short
        machine-readable rejection reason (the 401 body)."""
        if exp is None or sig is None:
            return "missing-signature"
        try:
            exp_i = int(exp)
        except (TypeError, ValueError):
            return "bad-exp"
        if (time.time() if now is None else now) > exp_i:
            return "expired"
        if not hmac.compare_digest(self._mac(method, path, exp_i), str(sig)):
            return "bad-signature"
        return None
