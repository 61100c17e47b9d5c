"""`repro_torch.storage` — pluggable tiered storage backends for GOP payloads.

Port of ``repro.storage``, kept byte-compatible with it wherever bytes
or names cross a process or a disk: placement hashes, layout
fingerprints, the journal's segment format, signed requests, the HTTP
protocol and metric names.  Stores, journals and servers work across
the two packages in both directions.

VSS §2 promises that the storage manager "transparently and
automatically arranges the data on disk".  This package is that
promise's seam: the catalog stays the control plane (metadata, temporal
index, LRU clock), while every payload byte moves through a
`StorageBackend` keyed by backend-relative object keys — the catalog's
``gop.path`` column.  `repro_torch.core` (store/cache/deferred/compact/joint)
contains no raw ``open()`` on payload paths; swap the backend and the
whole §2–§5 pipeline (read planning, LRU_VSS eviction, deferred
compression, compaction, joint compression) runs unchanged on a new
physical layout.

Backends
  * `MemoryBackend` — dict-backed; tests, benchmarks, hot tiers.
  * `LocalFSBackend` — one file per object, atomic temp+``os.replace``
    publish, optional fsync, crash-recovery scavenger.
  * `ShardedBackend` — consistent-hashes keys over N volumes; fans
    ``batch_get`` over a thread pool so the §3 read plans overlap I/O.
  * `TieredBackend` — bounded hot memory tier over any cold backend,
    write-through; spill ordering is wired to the catalog's LRU_VSS
    sequence numbers so eviction *policy* stays in `repro_torch.core.cache`.
  * `ReplicatedBackend` — quorum-replicates each key over R of N
    children (consistent-hash placement); reads fall back across
    replicas, the scrubber (`scrub`) re-replicates what a lost child
    or torn copy left under-replicated.
  * `RemoteBackend` — HTTP object store (the bundled
    `repro_torch.storage.httpserver.ObjectServer`, or any server speaking
    the same PUT/GET/HEAD/DELETE + list + rename protocol): pooled
    connections, bounded exponential-backoff retries, idempotency-safe
    temp-key puts.  ``tiered:remote`` fronts it with a **write-back**
    cache (dirty objects flush before eviction; `flush`/`close` is the
    durability barrier).
  * `FaultInjectingBackend` — seeded chaos wrapper (latency, transient
    errors, torn writes, hang-then-recover) for any of the above; the
    shared test infrastructure behind the conformance/chaos suites.

Selection: ``VSSConfig(backend=...)`` accepts an instance or a spec
string; with neither, the ``VSS_STORAGE_BACKEND`` env var (default
``local``) decides, so every benchmark runs against every backend.

Spec grammar (see `make_backend`):
    local | local:fsync | memory | sharded:<N> | tiered[:<cold spec>]
    | replicated[:<N>[:<R>[:<W>]]] | remote[:<url>] | remotes:<url>

``remotes:<url>`` is the untrusted-network composition: TLS on the
wire plus HMAC signed-request auth when a shared secret is provisioned
(``VSS_REMOTE_SECRET`` or ``VSSConfig.remote.secret``).  A write-back
``tiered:remote*`` store additionally keeps a crash-durable journal of
acknowledged-but-unflushed objects (`repro_torch.storage.journal`), so a
process crash never loses an acknowledged write.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.storage.base import (
    ObjectNotFound,
    ObjectStat,
    RangeNotSatisfiable,
    RecoveryReport,
    ScrubReport,
    StorageBackend,
    unwrap,
)
from repro_torch.storage.faults import FaultInjectingBackend, InjectedFault
from repro_torch.storage.httpserver import ObjectServer
from repro_torch.storage.journal import WriteBackJournal
from repro_torch.storage.localfs import LocalFSBackend
from repro_torch.storage.memory import MemoryBackend
from repro_torch.storage.recovery import scavenge, scrub, validate_gop_bytes
from repro_torch.storage.remote import RemoteAuthError, RemoteBackend, RemoteError
from repro_torch.storage.replicated import (
    ChildDownError,
    ReplicatedBackend,
    ReplicationError,
)
from repro_torch.storage.sharded import HashRing, ShardedBackend
from repro_torch.storage.signing import RequestSigner
from repro_torch.storage.tiered import TieredBackend

ENV_VAR = "VSS_STORAGE_BACKEND"
DEFAULT_SPEC = "local"
SECRET_ENV_VAR = "VSS_REMOTE_SECRET"
JOURNAL_DIRNAME = "_journal"


def make_backend(spec: str, root: str, *, registry=None,
                 instrument: bool = True,
                 hot_bytes: Optional[int] = None,
                 journal: bool = True,
                 journal_segment_bytes: Optional[int] = None,
                 secret: Optional[bytes] = None,
                 sig_ttl_s: Optional[float] = None,
                 ca_file: Optional[str] = None) -> StorageBackend:
    """Build a backend from a spec string; ``root`` anchors fs-backed
    layouts (each spec owns a distinct subtree so they never collide).

        local                    one volume under <root>
        local:fsync              same, fsync on every publish
        memory                   no persistence
        sharded:<N>              N LocalFS volumes under <root>/vol*
        tiered                   memory hot tier over local
        tiered:<spec>            memory hot tier over any cold spec
                                 (write-back when the cold tier is
                                 remote, write-through otherwise; the
                                 write-back composition keeps a
                                 crash-durable journal under
                                 <root>/_journal unless ``journal`` is
                                 False)
        replicated               3 LocalFS children, R=3 replicas, W=2
        replicated:<N>:<R>:<W>   N children under <root>/replica*,
                                 R = min(3, N) and W = majority(R)
                                 unless given
        remote                   self-hosted loopback ObjectServer
                                 over <root> (tests/CI: a real HTTP
                                 hop with zero external setup)
        remote:<url>             external object server at <url>
        remotes:<url>            external object server over TLS
                                 (https) — ``ca_file`` pins a
                                 self-signed server certificate

    ``secret`` (default: the ``VSS_REMOTE_SECRET`` env var) arms HMAC
    signed-request auth on every remote client this spec builds — and,
    for the self-hosted loopback server, on the server side too.

    Every level of a composed spec is wrapped with telemetry
    (`repro_torch.obs.InstrumentedBackend`), so a ``tiered:remote`` store
    reports cache-level ops under kind ``tiered`` AND the cold tier's
    network ops under kind ``remote``.  With the registry disabled (or
    ``instrument=False``) the bare backend is returned — zero wrapper
    frames on the hot path.  ``isinstance`` dispatch on the result must
    go through `repro_torch.storage.unwrap`."""
    from repro_torch.obs.instrument import instrument_backend

    def _wrap(backend: StorageBackend, kind: str) -> StorageBackend:
        if not instrument:
            return backend
        return instrument_backend(backend, kind=kind, registry=registry)

    if secret is None:
        env_secret = os.environ.get(SECRET_ENV_VAR)
        secret = env_secret.encode() if env_secret else None
    remote_kw = {"secret": secret, "ca_file": ca_file}
    if sig_ttl_s is not None:
        remote_kw["sig_ttl_s"] = sig_ttl_s

    spec = (spec or DEFAULT_SPEC).strip().lower()
    head, _, rest = spec.partition(":")
    if head in ("local", "localfs"):
        return _wrap(LocalFSBackend(root, fsync=rest == "fsync"), "localfs")
    if head == "memory":
        return _wrap(MemoryBackend(), "memory")
    if head == "sharded":
        n = int(rest) if rest else 2
        return _wrap(ShardedBackend.local(root, n), "sharded")
    if head == "remote":
        if rest:
            return _wrap(RemoteBackend(rest, registry=registry,
                                       **remote_kw), "remote")
        return _wrap(
            RemoteBackend.self_hosted(root, registry=registry,
                                      **remote_kw), "remote"
        )
    if head == "remotes":
        if not rest:
            raise ValueError(
                "remotes spec needs an explicit https url"
                " (remotes:https://host:port) — serving TLS requires a"
                " deployed certificate, so there is no self-hosted form"
            )
        url = rest if rest.startswith("https://") else f"https://{rest}"
        return _wrap(RemoteBackend(url, registry=registry, **remote_kw),
                     "remote")
    if head == "tiered":
        cold = make_backend(rest or DEFAULT_SPEC, root, registry=registry,
                            instrument=instrument, journal=journal,
                            secret=secret, sig_ttl_s=sig_ttl_s,
                            ca_file=ca_file)
        # a remote cold tier gets the write-back composition (a fast
        # local cache over a slow object store); every other cold
        # tier keeps the durable write-through discipline
        write_back = unwrap(cold, RemoteBackend) is not None
        tier_kw = {} if hot_bytes is None else {"hot_bytes": hot_bytes}
        if journal_segment_bytes is not None:
            tier_kw["journal_segment_bytes"] = journal_segment_bytes
        if write_back and journal:
            # crash durability for acknowledged-but-unflushed writes:
            # the journal lives on LOCAL disk next to the store, never
            # inside the cold tier's object namespace
            tier_kw["journal_dir"] = os.path.join(root, JOURNAL_DIRNAME)
        return _wrap(TieredBackend(
            cold, write_back=write_back,
            registry=registry, **tier_kw,
        ), "tiered")
    if head == "replicated":
        parts = [int(p) for p in rest.split(":") if p] if rest else []
        if len(parts) > 3:
            raise ValueError(f"unknown storage backend spec {spec!r}")
        n = parts[0] if parts else 3
        return _wrap(ReplicatedBackend.local(
            root, n,
            replicas=parts[1] if len(parts) > 1 else None,
            write_quorum=parts[2] if len(parts) > 2 else None,
            registry=registry,
        ), "replicated")
    raise ValueError(f"unknown storage backend spec {spec!r}")


__all__ = [
    "ENV_VAR",
    "DEFAULT_SPEC",
    "JOURNAL_DIRNAME",
    "SECRET_ENV_VAR",
    "ChildDownError",
    "FaultInjectingBackend",
    "HashRing",
    "InjectedFault",
    "LocalFSBackend",
    "MemoryBackend",
    "ObjectNotFound",
    "ObjectServer",
    "ObjectStat",
    "RangeNotSatisfiable",
    "RecoveryReport",
    "RemoteAuthError",
    "RemoteBackend",
    "RemoteError",
    "ReplicatedBackend",
    "ReplicationError",
    "RequestSigner",
    "ScrubReport",
    "ShardedBackend",
    "StorageBackend",
    "TieredBackend",
    "WriteBackJournal",
    "make_backend",
    "scavenge",
    "scrub",
    "unwrap",
    "validate_gop_bytes",
]
