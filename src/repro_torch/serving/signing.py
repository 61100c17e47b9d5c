"""HMAC-signed, expiring URLs for segment delivery.

The serving tier separates the *control plane* (a coalesced ``POST
/v1/read`` answering a manifest of segments) from the *data plane*
(``GET``s streaming each segment's bytes).  Data-plane URLs are
capability tokens: any holder can fetch exactly that path until the
expiry — no session state on the server, nothing to look up but the
signing secret.  This is the MAM/VoD signed-segment scheme on the
stdlib: token = HMAC-SHA256(secret, "<path>|<exp>").

Properties
  * expiry is inside the MAC, so extending ``exp`` invalidates ``sig``;
  * the MAC covers the decoded path, so URL-encoding tricks can't alias
    two resources under one token;
  * verification is constant-time (`hmac.compare_digest`);
  * the secret is per-service (random by default) — restarting the
    service revokes every outstanding URL, which is the correct failure
    mode for a cache of ephemeral results.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
import time
import urllib.parse
from typing import Optional

DEFAULT_TTL_S = 300.0


class UrlSigner:
    def __init__(self, secret: Optional[bytes] = None,
                 ttl_s: float = DEFAULT_TTL_S):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.secret = secret if secret is not None else secrets.token_bytes(32)
        if not self.secret:
            raise ValueError("signing secret must be non-empty")
        self.ttl_s = float(ttl_s)

    def _mac(self, path: str, exp: int) -> str:
        msg = f"{path}|{exp}".encode()
        return hmac.new(self.secret, msg, hashlib.sha256).hexdigest()

    def sign(self, path: str, *, now: Optional[float] = None) -> str:
        """Return ``path?exp=<unix>&sig=<hex>`` (query appended with
        ``&`` when the path already carries one)."""
        exp = int((time.time() if now is None else now) + self.ttl_s)
        sep = "&" if "?" in path else "?"
        bare = urllib.parse.urlsplit(path).path
        return f"{path}{sep}exp={exp}&sig={self._mac(bare, exp)}"

    def verify(self, path: str, exp: str, sig: str,
               *, now: Optional[float] = None) -> Optional[str]:
        """None when the token grants access to ``path``; otherwise a
        short machine-readable failure reason."""
        try:
            exp_i = int(exp)
        except (TypeError, ValueError):
            return "bad-exp"
        if (time.time() if now is None else now) > exp_i:
            return "expired"
        if not hmac.compare_digest(self._mac(path, exp_i), str(sig)):
            return "bad-signature"
        return None
