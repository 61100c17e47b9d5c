"""One coherent construction/policy surface for the store: ``VSSConfig``.

`VSS.__init__` grew thirteen keyword arguments across eight PRs; the
adaptive policy (profile.py) would have pushed it past twenty.  This
module consolidates every construction knob into a single frozen
dataclass with nested sub-configs per subsystem:

    VSSConfig(
        backend="tiered:remote",
        cache=CachePolicy(gamma=4.0),
        deferred=DeferredConfig(enabled=False),
        ingest=IngestConfig(workers=4, autosize=True),
        tiering=TieringConfig(hot_bytes=64 << 20),
        adaptive=AdaptiveConfig(enabled=True),
    )

Three entry points build one:

  * Python — construct directly; everything is a plain dataclass.
  * Environment — each scalar leaf field has a ``VSS_<PATH>`` override
    (``VSS_SOLVER``, ``VSS_CACHE_GAMMA``, ``VSS_INGEST_WORKERS``,
    ``VSS_ADAPTIVE_ENABLED``, ...) applied by :meth:`VSSConfig.with_env`.
    An override only replaces a field the caller left at its default:
    explicit Python arguments always win over the environment, matching
    the long-standing ``VSS_STORAGE_BACKEND`` semantics.
  * JSON — :meth:`VSSConfig.from_json` with the same strict
    unknown-key rejection as the serving tier's ``spec_from_json``
    (shared via :func:`strict_keys`), so a service boots from one file.

Live objects (a ``StorageBackend`` instance, a ``CostModel``, a
``MetricsRegistry``) are dependency injection, not policy; they remain
plain fields but are excluded from env/JSON parsing.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core import deferred as _deferred
from repro_torch.core import ingest as _ingest
from repro_torch.core.cache import CachePolicy
from repro_torch.obs import DEFAULT_TRACE_CAPACITY
from repro_torch.storage.journal import DEFAULT_SEGMENT_BYTES
from repro_torch.storage.signing import DEFAULT_SIG_TTL_S
from repro_torch.storage.tiered import DEFAULT_HOT_BYTES

ENV_PREFIX = "VSS"

DEFAULT_BUDGET_MULTIPLE = 10.0

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))


def parse_bool(raw: str, *, what: str = "value") -> bool:
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"{what}: expected a boolean, got {raw!r}")


def strict_keys(
    obj: Mapping[str, Any], allowed: Sequence[str], what: str
) -> Dict[str, Any]:
    """Reject unknown keys — the `spec_from_json` validation contract,
    shared so config files fail loudly on typos instead of silently
    ignoring a misspelled knob."""
    if not isinstance(obj, Mapping):
        raise ValueError(f"{what}: expected an object, got {type(obj).__name__}")
    unknown = sorted(set(obj) - set(allowed))
    if unknown:
        raise ValueError(
            f"{what}: unknown field(s) {unknown}; allowed: {sorted(allowed)}"
        )
    return dict(obj)


@dataclasses.dataclass(frozen=True)
class DeferredConfig:
    """§5.2 deferred compression knobs."""

    enabled: bool = True
    # fraction of the storage budget a video must exceed before the
    # background compressor considers it (paper's 25%)
    activation_fraction: float = _deferred.ACTIVATION_FRACTION


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Write-path pipeline sizing (§4 ingest)."""

    pipelined: bool = True
    workers: int = _ingest.DEFAULT_WORKERS
    queue_gops: int = _ingest.DEFAULT_QUEUE_GOPS
    # derive the initial workers/queue_gops from the calibrated
    # io_table at construction (slow backends get more concurrency);
    # runtime growth on backpressure additionally requires
    # adaptive.enabled
    autosize: bool = False


@dataclasses.dataclass(frozen=True)
class TieringConfig:
    """Hot-tier sizing for spec-built tiered backends.  Ignored when a
    pre-constructed backend instance is passed in (its own hot_bytes
    wins)."""

    hot_bytes: int = DEFAULT_HOT_BYTES
    # crash-durable write-back: journal every dirty admission under
    # <root>/objects/_journal (fsync'd before the put returns) so a
    # crash never drops an acknowledged write.  Only applies to the
    # write-back composition (tiered over a remote cold tier).
    journal: bool = True
    journal_segment_bytes: int = DEFAULT_SEGMENT_BYTES


@dataclasses.dataclass(frozen=True)
class RemoteConfig:
    """Authenticated transport for spec-built remote backends.

    ``secret`` arms HMAC signed-request auth (`repro_torch.storage.signing`)
    on every remote client the backend spec builds — and on the
    self-hosted loopback server's side too; the ``VSS_REMOTE_SECRET``
    env var provisions it without touching code.  ``ca_file`` points
    at a PEM bundle to trust for ``remotes:<url>`` (how a self-signed
    deployment pins its server certificate)."""

    secret: Optional[str] = None
    sig_ttl_s: float = DEFAULT_SIG_TTL_S
    ca_file: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Workload-adaptive format management (profile.py).

    ``profile`` is pure observation — it records the read stream and
    never changes behavior; ``enabled`` lets :class:`AdaptivePolicy`
    act on the profile (materialize hot views ahead of demand, re-tier
    hot/cold epochs, schedule deferred compression around live ingest,
    and grow the ingest pipeline under backpressure).
    """

    profile: bool = True
    enabled: bool = False
    # decay half-life (wall seconds) of the profiler's frequency/heat
    # counters: ~5 minutes means last-hour history matters, last-week
    # history doesn't
    half_life_s: float = 300.0
    # heat-bucket width in video-time seconds
    interval_s: float = 4.0
    # a view config whose decayed read count reaches this is "hot"
    # enough to materialize ahead of demand
    min_view_score: float = 3.0
    # per-adapt() cap on GOPs materialized (bounds write amplification)
    max_materialize_gops: int = 64
    # heat at/below this marks a bucket cold (demote its objects)
    cold_score: float = 0.05
    # compress_one() steps per adapt() tick when ingest is idle
    deferred_budget: int = 4
    # persist the profile every N recorded reads (plus on close)
    persist_every: int = 256


_CONFIG_FIELDS = (
    "backend", "budget_multiple", "solver", "cost_model", "cache",
    "deferred", "compaction", "use_pallas", "ingest", "tiering",
    "remote", "adaptive", "registry", "trace_capacity", "device",
)
# live-object fields: excluded from env overrides and JSON parsing
_OPAQUE_FIELDS = frozenset(("cost_model", "registry"))
# fields no environment variable may override: the device is chosen in
# code or in the config document, never behind the caller's back
_NO_ENV_FIELDS = frozenset(("device",))
# fields whose Optional[...] default hides the leaf type from inference
_OPTIONAL_TYPES = {"use_pallas": bool, "secret": str, "ca_file": str}


@dataclasses.dataclass(frozen=True)
class VSSConfig:
    """Everything `VSS(root, config=...)` needs beyond the root path."""

    # StorageBackend instance | spec string | None (VSS_STORAGE_BACKEND
    # env, then "local")
    backend: Any = None
    budget_multiple: float = DEFAULT_BUDGET_MULTIPLE
    solver: str = "dp"
    cost_model: Any = None  # Optional[CostModel]
    cache: CachePolicy = dataclasses.field(default_factory=CachePolicy)
    deferred: DeferredConfig = dataclasses.field(
        default_factory=DeferredConfig)
    compaction: bool = True
    use_pallas: Optional[bool] = None
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    tiering: TieringConfig = dataclasses.field(default_factory=TieringConfig)
    remote: RemoteConfig = dataclasses.field(default_factory=RemoteConfig)
    adaptive: AdaptiveConfig = dataclasses.field(
        default_factory=AdaptiveConfig)
    registry: Any = None  # Optional[MetricsRegistry]
    trace_capacity: int = DEFAULT_TRACE_CAPACITY
    # where the codec's device work runs: "cuda" launches the
    # hand-written kernels, "cpu" runs their plain PyTorch versions.
    # `use_pallas` (kept so a reference config document boots this
    # package) cannot pick the path: the device does.
    device: str = "cuda"

    def replace(self, **kw) -> "VSSConfig":
        return dataclasses.replace(self, **kw)

    # -- environment overrides -------------------------------------------
    def with_env(
        self, env: Optional[Mapping[str, str]] = None
    ) -> "VSSConfig":
        """Apply per-field ``VSS_*`` overrides for scalar leaves still at
        their dataclass default.  Nested fields join with underscores:
        ``VSS_CACHE_GAMMA``, ``VSS_DEFERRED_ENABLED``,
        ``VSS_ADAPTIVE_HALF_LIFE_S``, ...  (``VSS_STORAGE_BACKEND`` and
        ``VSS_TELEMETRY`` keep their existing store-level semantics and
        are not handled here.)"""
        if env is None:
            env = os.environ
        return _apply_env(self, ENV_PREFIX, env)

    # -- strict JSON ------------------------------------------------------
    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "VSSConfig":
        """Build from a parsed-JSON mapping with strict unknown-key
        rejection.  Only declarative fields are accepted — `backend`
        must be a spec string, and live objects (cost_model, registry)
        cannot come from JSON."""
        allowed = [f for f in _CONFIG_FIELDS if f not in _OPAQUE_FIELDS]
        data = strict_keys(obj, allowed, "VSSConfig")
        kw: Dict[str, Any] = {}
        for name, value in data.items():
            current = getattr(cls(), name)
            if dataclasses.is_dataclass(current):
                kw[name] = _nested_from_json(current, value, name)
            else:
                kw[name] = _coerce_scalar(name, value, current)
        return cls(**kw)


def _scalar_parser(name: str, default: Any):
    """env-string parser for a leaf field, inferred from its default."""
    if name in _OPTIONAL_TYPES:
        leaf = _OPTIONAL_TYPES[name]
    elif default is None:
        return None  # opaque (backend spec handled at store level)
    else:
        leaf = type(default)
    if leaf is bool:
        return lambda raw, what: parse_bool(raw, what=what)
    if leaf is int:
        return lambda raw, what: int(raw)
    if leaf is float:
        return lambda raw, what: float(raw)
    if leaf is str:
        return lambda raw, what: raw
    return None


def _apply_env(cfg, prefix: str, env: Mapping[str, str]):
    """Recursively rebuild `cfg` with env overrides on default-valued
    scalar leaves.  Works on any dataclass (frozen or not)."""
    defaults = type(cfg)()
    updates: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        if (f.name in _OPAQUE_FIELDS or f.name in _NO_ENV_FIELDS
                or f.name == "backend"):
            continue
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            nested = _apply_env(
                value, f"{prefix}_{f.name.upper()}", env)
            if nested != value:
                updates[f.name] = nested
            continue
        key = f"{prefix}_{f.name.upper()}"
        raw = env.get(key)
        if raw is None:
            continue
        if value != getattr(defaults, f.name):
            continue  # explicitly set in Python: wins over env
        parser = _scalar_parser(f.name, getattr(defaults, f.name))
        if parser is None:
            continue
        try:
            updates[f.name] = parser(raw, key)
        except ValueError as exc:
            raise ValueError(f"invalid env override {key}={raw!r}: {exc}")
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _nested_from_json(default_obj, value: Any, what: str):
    names = [f.name for f in dataclasses.fields(default_obj)]
    data = strict_keys(value, names, what)
    kw = {
        k: _coerce_scalar(f"{what}.{k}", v, getattr(default_obj, k))
        for k, v in data.items()
    }
    return dataclasses.replace(default_obj, **kw)


def _coerce_scalar(what: str, value: Any, default: Any):
    if value is None:
        return value
    if what.split(".")[-1] in _OPTIONAL_TYPES:
        leaf = _OPTIONAL_TYPES[what.split(".")[-1]]
    elif default is None:
        return value  # opaque (backend spec string)
    else:
        leaf = type(default)
    if leaf is bool:
        if not isinstance(value, bool):
            raise ValueError(f"{what}: expected a boolean, got {value!r}")
        return value
    if leaf is float and isinstance(value, (int, float)) \
            and not isinstance(value, bool):
        return float(value)
    if leaf is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{what}: expected an integer, got {value!r}")
        return value
    if not isinstance(value, leaf):
        raise ValueError(
            f"{what}: expected {leaf.__name__}, got {type(value).__name__}"
        )
    return value


def check_device(cfg: VSSConfig) -> None:
    """Raise unless ``cfg.device`` can run the codec as configured.

    ``"cuda"`` needs a visible CUDA device; the store never runs on
    quietly on the CPU.  ``use_pallas=False`` asked the reference for
    its plain oracle path, and on a CUDA device that would mean leaving
    the kernels, so it is refused too."""
    dev = torch.device(cfg.device)
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(
            f"device {cfg.device!r}: repro_torch runs on 'cuda' or 'cpu'")
    if cfg.use_pallas is False:
        raise ValueError(
            "use_pallas=False asks for the plain oracle path, but on a CUDA"
            " device the codec always runs its hand-written kernels; pass"
            " device='cpu' to run the plain PyTorch versions")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {cfg.device!r} requested but torch sees no CUDA device;"
            " pass VSSConfig(device='cpu') to run on the CPU")


# -- legacy keyword-argument shim --------------------------------------------

# old VSS.__init__ kwarg -> path into VSSConfig ("a.b" = nested field)
LEGACY_KWARGS: Dict[str, str] = {
    "backend": "backend",
    "budget_multiple": "budget_multiple",
    "solver": "solver",
    "cost_model": "cost_model",
    "cache_policy": "cache",
    "enable_deferred": "deferred.enabled",
    "enable_compaction": "compaction",
    "use_pallas": "use_pallas",
    "pipelined_ingest": "ingest.pipelined",
    "ingest_workers": "ingest.workers",
    "ingest_queue_gops": "ingest.queue_gops",
    "registry": "registry",
    "trace_capacity": "trace_capacity",
}


def config_from_legacy(
    config: Optional[VSSConfig], legacy: Mapping[str, Any]
) -> VSSConfig:
    """Fold deprecated ``VSS(...)`` keyword arguments into a config.
    `cache_policy=None` / `cost_model=None` mean "default", matching the
    old signature."""
    cfg = config if config is not None else VSSConfig()
    for name, value in legacy.items():
        path = LEGACY_KWARGS[name]
        if name in ("cache_policy", "cost_model") and value is None:
            continue
        if "." in path:
            outer, inner = path.split(".", 1)
            nested = dataclasses.replace(
                getattr(cfg, outer), **{inner: value})
            cfg = dataclasses.replace(cfg, **{outer: nested})
        else:
            cfg = dataclasses.replace(cfg, **{path: value})
    return cfg
