"""`repro_torch.storage` — pluggable storage backends for GOP payloads.

Port of ``repro.storage``.  The catalog stays the control plane
(metadata, temporal index, LRU clock), while every payload byte moves
through a `StorageBackend` keyed by backend-relative object keys — the
catalog's ``gop.path`` column.

Backends in this package
  * `MemoryBackend` — dict-backed; tests, benchmarks.
  * `LocalFSBackend` — one file per object, atomic temp+``os.replace``
    publish, optional fsync, crash-recovery scavenger.

The reference's sharded, tiered, replicated and remote backends, the
write-back journal, request signing, the HTTP object server and the
fault injector are not ported yet (ROADMAP Queue 1 item 3); their specs
raise `NotImplementedError`.

Selection: ``VSSConfig(backend=...)`` accepts an instance or a spec
string; with neither, the ``VSS_STORAGE_BACKEND`` env var (default
``local``) decides.

Spec grammar (see `make_backend`):
    local | local:fsync | memory
"""
from __future__ import annotations

from repro_torch.storage.base import (
    ObjectNotFound,
    ObjectStat,
    RangeNotSatisfiable,
    RecoveryReport,
    ScrubReport,
    StorageBackend,
    unwrap,
)
from repro_torch.storage.localfs import LocalFSBackend
from repro_torch.storage.memory import MemoryBackend
from repro_torch.storage.recovery import scavenge, scrub, validate_gop_bytes

ENV_VAR = "VSS_STORAGE_BACKEND"
DEFAULT_SPEC = "local"


# specs of the reference that this package does not build yet, and the
# ROADMAP item that ports them
UNPORTED_SPECS = {
    "sharded": "ROADMAP Queue 1 item 3 (sharded backend)",
    "tiered": "ROADMAP Queue 1 item 3 (tiered backend, write-back journal)",
    "replicated": "ROADMAP Queue 1 item 3 (replicated backend)",
    "remote": "ROADMAP Queue 1 item 3 (remote backend, object server)",
    "remotes": "ROADMAP Queue 1 item 3 (remote backend over TLS, signing)",
}


def make_backend(spec: str, root: str, *, registry=None,
                 instrument: bool = True) -> StorageBackend:
    """Build a backend from a spec string; ``root`` anchors fs-backed
    layouts.

        local                    one volume under <root>
        local:fsync              same, fsync on every publish
        memory                   no persistence

    The reference's other specs (``sharded``, ``tiered``,
    ``replicated``, ``remote``, ``remotes``) raise `NotImplementedError`
    naming the ROADMAP item that ports them.

    Every backend is wrapped with telemetry
    (`repro_torch.obs.InstrumentedBackend`); with the registry disabled
    (or ``instrument=False``) the bare backend is returned.
    ``isinstance`` dispatch on the result must go through
    `repro_torch.storage.unwrap`."""
    from repro_torch.obs.instrument import instrument_backend

    def _wrap(backend: StorageBackend, kind: str) -> StorageBackend:
        if not instrument:
            return backend
        return instrument_backend(backend, kind=kind, registry=registry)

    spec = (spec or DEFAULT_SPEC).strip().lower()
    head, _, rest = spec.partition(":")
    if head in ("local", "localfs"):
        return _wrap(LocalFSBackend(root, fsync=rest == "fsync"), "localfs")
    if head == "memory":
        return _wrap(MemoryBackend(), "memory")
    if head in UNPORTED_SPECS:
        raise NotImplementedError(
            f"storage backend spec {spec!r} is not ported to repro_torch"
            f" yet: {UNPORTED_SPECS[head]}"
        )
    raise ValueError(f"unknown storage backend spec {spec!r}")


__all__ = [
    "ENV_VAR",
    "DEFAULT_SPEC",
    "UNPORTED_SPECS",
    "LocalFSBackend",
    "MemoryBackend",
    "ObjectNotFound",
    "ObjectStat",
    "RangeNotSatisfiable",
    "RecoveryReport",
    "ScrubReport",
    "StorageBackend",
    "make_backend",
    "scavenge",
    "scrub",
    "unwrap",
    "validate_gop_bytes",
]
