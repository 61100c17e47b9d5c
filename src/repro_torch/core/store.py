"""VSS — the storage manager (paper Figure 1 API).

The public surface is declarative: callers build immutable
`repro_torch.core.spec.ReadSpec` / `WriteSpec` values stating *what* view
they want (interval, resolution, ROI, fps, codec, quality) and the §3
planner decides *how* to materialize it.  ``read_spec``/``write_spec``/
``writer_spec`` take specs; the classic nine-keyword ``read()`` and
``write()``/``writer()`` remain as thin compatibility shims that build
the spec for you and go through the exact same planner.

``read_batch(specs)`` is the multi-request entry point a VDBMS issues
concurrent queries through: specs are grouped by logical video and
view configuration, ONE `SelectionProblem` per video covers the union
of every request's segments (a fragment chosen once serves every
overlapping request), GOP fetches are deduplicated across requests and
issued as a single ``backend.batch_get`` per plan, each GOP is decoded
at most once per batch, and cache admissions share one eviction pass
per video.  Plans price fragment I/O per storage tier via
``CostModel.io_cost`` + ``backend.kind_for``, so batched plans prefer
fragments on faster tiers.

Writes are streaming and non-blocking: ``writer()`` returns a handle
whose flushed GOPs become immediately queryable (prefix reads of a
video still being written are supported); visibility of the *final*
GOP is only guaranteed after ``close()``, matching the paper's caveat.
The logical-video row is registered at the FIRST flush, not at handle
creation, so an abandoned writer leaves nothing behind.  Ingest is
pipelined (§4, §6.5, `repro_torch.core.ingest`): writers encode on their own
thread and hand publish windows to the store's shared bounded queue,
whose workers issue the batched puts and windowed catalog commits —
encoding overlaps physical I/O within one stream and across N camera
streams.  ``close()`` stays a durability barrier, reads wait out the
queue for the videos they touch, and a failed put re-raises on the
owning writer's next call.

GOP payload bytes never touch the filesystem here: every object moves
through a `repro_torch.storage.StorageBackend` (``backend=`` parameter, spec
string, or the ``VSS_STORAGE_BACKEND`` env var), which owns atomicity,
sharding, tiering and crash recovery — the §2 physical-layout
transparency as an actually swappable layer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from collections.abc import Mapping as _Mapping
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import codec as _codec
from repro_torch import obs as _obs
from repro_torch import storage as _storage
from repro_torch.core import compact as _compact
from repro_torch.core import ingest as _ingest
from repro_torch.core import joint as _joint
from repro_torch.core import profile as _profile
from repro_torch.core.cache import CacheManager
from repro_torch.core.catalog import Catalog
from repro_torch.core.config import VSSConfig, check_device, config_from_legacy
from repro_torch.core.cost import ETA, CostModel, calibration_path
from repro_torch.core.deferred import DeferredCompressor, is_wrapped, unwrap_bytes
from repro_torch.core.features import MEMO_OUTCOMES, FeatureMemo
from repro_torch.core.fingerprint import CandidateIndex
from repro_torch.core.quality import QualityEstimator, exact_mse
from repro_torch.core.resize import resample
from repro_torch.core.select import (
    SegmentChoice,
    Selection,
    SelectionProblem,
    restrict_to_segments,
    solve,
)
from repro_torch.core.spec import ReadSpec, ResolvedRead, WriteSpec
from repro_torch.core.types import (
    DEFAULT_QUALITY_EPS_DB,
    Box,
    GopMeta,
    PhysicalMeta,
    chain_mse_bound,
    full_roi,
    tile_bounds,
    tile_key,
    tiles_covering,
)

DEFAULT_BUDGET_MULTIPLE = 10.0  # §4 administrator default
BULK_WRITE_BATCH_GOPS = 8  # GOPs per batch_put in the non-streaming path
_EPS = 1e-9
# ranged sub-GOP reads: below this object size a second round-trip costs
# more than the bytes it saves, and above this kept-fraction most of the
# object moves anyway — fall back to the plain full-object fetch
MIN_RANGED_BYTES = 4096
RANGED_HI_FRACTION = 0.75


@dataclasses.dataclass
class ReadPlan:
    segments: List[Tuple[float, float]]
    problem: SelectionProblem
    selection: Selection
    runs: List["Run"]  # indexed by SegmentChoice.video_idx
    plan_seconds: float

    def run_idx(self, seg_i: int) -> int:
        choice_i = self.selection.assignment[seg_i]
        return self.problem.choices[seg_i][choice_i].video_idx


class ReadResult:
    """Read output. For compressed outputs ``frames`` decodes lazily —
    pass-through reads (cache hit in the requested codec) never touch
    pixels unless the caller actually asks for them.  The lazy decode
    runs on ``device``, the store's."""

    def __init__(self, frames, codec, encoded, plan, fps, *, device: str):
        self._frames = frames
        self.codec = codec
        self.encoded: Optional[List[_codec.EncodedGOP]] = encoded
        self.plan: ReadPlan = plan
        self.fps = fps
        self.device = device

    @property
    def frames(self) -> np.ndarray:
        if self._frames is None:
            self._frames = np.concatenate(
                [_codec.decode_gop(e, device=self.device)
                 for e in self.encoded], axis=0
            )
        return self._frames

    @property
    def nbytes(self) -> int:
        if self.encoded is not None:
            return sum(e.nbytes for e in self.encoded)
        return self.frames.nbytes


@dataclasses.dataclass
class Run:
    """A contiguous run of live GOPs within one physical video."""

    physical: PhysicalMeta
    gops: List[GopMeta]

    @property
    def t_start(self) -> float:
        return self.gops[0].start_time(self.physical.fps, self.physical.t_start)

    @property
    def t_end(self) -> float:
        return self.gops[-1].end_time(self.physical.fps, self.physical.t_start)


def _stored_gop(data: bytes) -> _codec.EncodedGOP:
    """A stored GOP object's bytes, unwrapped where deferred compression
    wrapped them, as a GOP."""
    return _codec.deserialize_gop(unwrap_bytes(data) if is_wrapped(data)
                                  else data)


class _CatalogSnapshot:
    """One catalog round-trip per (video, table) per batch: candidate
    generation for N concurrent specs on the same video shares these
    lookups instead of re-querying SQLite N times."""

    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._originals: Dict[str, PhysicalMeta] = {}
        self._physicals: Dict[str, List[PhysicalMeta]] = {}
        self._gops: Dict[int, List[GopMeta]] = {}

    def original(self, name: str) -> PhysicalMeta:
        if name not in self._originals:
            oid = self.catalog.get_original_id(name)
            if oid is None:
                raise KeyError(f"unknown logical video {name!r}")
            self._originals[name] = self.catalog.get_physical(oid)
        return self._originals[name]

    def physicals(self, name: str) -> List[PhysicalMeta]:
        if name not in self._physicals:
            self._physicals[name] = self.catalog.physicals_for(name)
        return self._physicals[name]

    def gops(self, physical_id: int) -> List[GopMeta]:
        if physical_id not in self._gops:
            self._gops[physical_id] = self.catalog.gops_for(physical_id)
        return self._gops[physical_id]


class _BatchIO:
    """Cross-request fetch/decode dedupe for one ``read_batch`` call —
    and the read path's I/O measurement point.

    ``prefetch`` pulls every (deduplicated) GOP key a plan group needs
    in ONE ``backend.batch_get`` — the §3 multi-fragment I/O overlap,
    now spanning requests instead of one request's fragments.  Blobs
    and decoded frames live for the duration of the batch, so a GOP
    shared by several overlapping specs is fetched once and decoded
    once.

    Decoded frames go in through ``keep``, which counts the decode, and
    come out through ``lookup``, under one key: ``(gop_id, tile, hi)``,
    ``tile`` the ``(r, c)`` of a tiled GOP's object (None untiled) and
    ``hi`` the end of a prefix ``[0, hi)`` (None for every frame).

    ``stream=True`` (the single-spec ``read()``/``read_spec`` path)
    keeps the counters but retains nothing: each blob and decoded GOP
    is used and dropped, preserving the pre-batch peak-memory profile
    while fetch/decode telemetry still flows into the spec's trace.

    Telemetry per instance: ``totals`` covers every decode and every
    backend round-trip issued through this context; ``claim`` tells
    which planned keys `VSS._read_batch` has already attributed to a
    spec's share of a group fetch."""

    def __init__(self, backend: _storage.StorageBackend, *,
                 stream: bool = False):
        self.backend = backend
        self._stream = stream
        self._blobs: Dict[str, bytes] = {}
        self._decoded: Dict[tuple, np.ndarray] = {}
        self._claimed: set = set()
        self._gops_decoded = 0
        self._objects = 0
        self._bytes = 0
        self._seconds = 0.0

    def totals(self) -> Tuple[int, int, int, float]:
        """(GOPs decoded, objects fetched, bytes fetched, fetch seconds)
        so far."""
        return self._gops_decoded, self._objects, self._bytes, self._seconds

    def lookup(self, gop_id: int, tile: Optional[Tuple[int, int]] = None,
               hi: Optional[int] = None) -> Optional[np.ndarray]:
        """The frames kept under ``(gop_id, tile, hi)``, or None; a
        prefix is also cut from the whole object's frames."""
        whole = self._decoded.get((gop_id, tile, None))
        if whole is not None:
            return whole if hi is None else whole[:hi]
        return self._decoded.get((gop_id, tile, hi))

    def keep(self, frames: np.ndarray, gop_id: int,
             tile: Optional[Tuple[int, int]] = None,
             hi: Optional[int] = None) -> np.ndarray:
        """Count a decode; retain the frames for cross-spec sharing
        unless streaming."""
        self._gops_decoded += 1
        if not self._stream:
            self._decoded[(gop_id, tile, hi)] = frames
        return frames

    def held(self, key: str) -> Optional[bytes]:
        """The whole object under ``key`` if this batch fetched it."""
        return self._blobs.get(key)

    def claim(self, key: str) -> bool:
        """Claim a planned ``key`` for a spec's fetch span: False if the
        batch already fetched or claimed it."""
        if key in self._blobs or key in self._claimed:
            return False
        self._claimed.add(key)
        return True

    def _fetch(self, keys: Sequence[str], call) -> List[bytes]:
        """``call()``, one backend round trip for ``keys``, timed in a
        ``vss.store.fetch`` span and counted."""
        fs = _obs.span("vss.store.fetch", objects=len(keys), timed=True)
        with fs:
            blobs = call()
        self._seconds += fs.seconds
        self._objects += len(keys)
        self._bytes += sum(len(b) for b in blobs)
        return blobs

    def prefetch(self, keys: Sequence[str]) -> float:
        """Fetch the keys not yet held in one round trip; its seconds."""
        missing = [k for k in dict.fromkeys(keys) if k not in self._blobs]
        if not missing:
            return 0.0
        secs0 = self._seconds
        self._blobs.update(zip(missing, self._fetch(
            missing, lambda: self.backend.batch_get(missing))))
        return self._seconds - secs0

    def get(self, key: str) -> bytes:
        if key in self._blobs:
            return self._blobs[key]
        data, = self._fetch([key], lambda: [self.backend.get(key)])
        if not self._stream:
            self._blobs[key] = data
        return data

    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        if self._stream:
            uniq = list(dict.fromkeys(keys))
            got = dict(zip(uniq, self._fetch(
                uniq, lambda: self.backend.batch_get(uniq)))) if uniq else {}
            return [got[k] for k in keys]
        self.prefetch(keys)
        return [self._blobs[k] for k in keys]

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged fetch with the same telemetry as ``get``.  Partial
        bytes are never held — a later full read of the key must not
        alias a truncated payload."""
        data, = self._fetch(
            [key], lambda: [self.backend.get_range(key, start, length)])
        return data


@dataclasses.dataclass(frozen=True)
class StoreStats(_Mapping):
    """`VSS.stats` result: the classic catalog summary plus a typed
    view over the store's `repro_torch.obs` registry.  Mapping-compatible —
    ``stats["gops"]`` and friends keep working — with the read-path
    planner/fetch telemetry and an ingest snapshot alongside.  The
    registry-backed fields read zero when telemetry is disabled."""

    physical_videos: int
    gops: int
    bytes: int
    budget: int
    # read path (store-lifetime, not per-video)
    specs_read: int
    plan_groups: int
    specs_coalesced: int
    objects_fetched: int
    fetch_bytes: int
    gop_fetches_deduped: int
    gops_decoded: int
    predicted_io_seconds: float
    actual_io_seconds: float
    ingest: Optional[_ingest.IngestStats]

    def __getitem__(self, key):
        if isinstance(key, str) and not key.startswith("_"):
            try:
                return getattr(self, key)
            except AttributeError:
                pass
        raise KeyError(key)

    def __iter__(self):
        return (f.name for f in dataclasses.fields(self))

    def __len__(self) -> int:
        return len(dataclasses.fields(self))


_UNSET = object()  # legacy-kwarg sentinel: None is a meaningful value


class VSS:
    def __init__(
        self,
        root: str,
        *,
        config: Optional[VSSConfig] = None,
        # -- deprecated keyword arguments (pre-VSSConfig construction
        # surface).  Each still works, folds into `config`, and emits a
        # DeprecationWarning; see `repro_torch.core.config.LEGACY_KWARGS`.
        backend=_UNSET,
        budget_multiple=_UNSET,
        solver=_UNSET,
        cost_model=_UNSET,
        cache_policy=_UNSET,
        enable_deferred=_UNSET,
        enable_compaction=_UNSET,
        use_pallas=_UNSET,
        pipelined_ingest=_UNSET,
        ingest_workers=_UNSET,
        ingest_queue_gops=_UNSET,
        registry=_UNSET,
        trace_capacity=_UNSET,
    ):
        legacy = {
            name: value
            for name, value in (
                ("backend", backend),
                ("budget_multiple", budget_multiple),
                ("solver", solver),
                ("cost_model", cost_model),
                ("cache_policy", cache_policy),
                ("enable_deferred", enable_deferred),
                ("enable_compaction", enable_compaction),
                ("use_pallas", use_pallas),
                ("pipelined_ingest", pipelined_ingest),
                ("ingest_workers", ingest_workers),
                ("ingest_queue_gops", ingest_queue_gops),
                ("registry", registry),
                ("trace_capacity", trace_capacity),
            )
            if value is not _UNSET
        }
        if legacy:
            warnings.warn(
                f"VSS keyword argument(s) {sorted(legacy)} are deprecated;"
                " pass VSS(root, config=VSSConfig(...)) instead"
                " (see docs/api.md for the field mapping)",
                DeprecationWarning, stacklevel=2,
            )
            config = config_from_legacy(config, legacy)
        config = (config if config is not None else VSSConfig()).with_env()
        # before anything is opened: a CUDA store on a machine without
        # CUDA, or one asked for the plain path, fails here
        check_device(config)
        self.config = config
        self.device = config.device
        self.root = root
        os.makedirs(root, exist_ok=True)
        # telemetry: one registry threaded through every layer this
        # store builds (backend wrappers, ingest pipeline, planner
        # counters) + a bounded ring of per-request trace trees.  The
        # default is the process-global registry, so several stores in
        # one process expose one /metrics view while each component's
        # own handles keep per-instance stats exact.
        self.registry = (
            config.registry if config.registry is not None
            else _obs.default_registry()
        )
        self.tracer = _obs.Tracer(
            capacity=config.trace_capacity, enabled=self.registry.enabled
        )
        self.catalog = Catalog(os.path.join(root, "catalog.sqlite"))
        backend = config.backend
        if backend is None:
            backend = os.environ.get(_storage.ENV_VAR, _storage.DEFAULT_SPEC)
        made_backend = isinstance(backend, str)
        if made_backend:
            try:
                backend = _storage.make_backend(
                    backend, os.path.join(root, "objects"),
                    registry=self.registry,
                    hot_bytes=config.tiering.hot_bytes,
                    journal=config.tiering.journal,
                    journal_segment_bytes=config.tiering.journal_segment_bytes,
                    secret=(config.remote.secret.encode()
                            if config.remote.secret else None),
                    sig_ttl_s=config.remote.sig_ttl_s,
                    ca_file=config.remote.ca_file,
                )
            except BaseException:
                self.catalog.close()
                raise
        self.backend = backend
        tiered = _storage.unwrap(backend, _storage.TieredBackend)
        if tiered is not None:
            # hot-tier spill ordering = the catalog's LRU_VSS sequence
            # numbers; policy stays in cache.py / the catalog
            tiered.set_priority_fn(self.catalog.lru_for_paths)
        # scarce-connection backends (RemoteBackend's socket pool) grow
        # to cover the ingest worker pool — at least one connection per
        # concurrently-publishing worker; a minimum hint, so it never
        # shrinks a pool sized larger for read fan-out
        backend.configure_concurrency(max(1, int(config.ingest.workers)))
        # layout guard: the scavenger treats unresolvable keys as lost
        # data, so opening an existing store under a different placement
        # scheme must fail loudly instead of wiping the catalog
        fp = self.backend.layout_fingerprint()
        recorded = self.catalog.get_meta("storage_layout")
        if recorded != fp:
            if self.catalog.any_gops():
                # recorded None here means a pre-layout-stamp catalog
                # (absolute paths on a bare directory) — unmigratable.
                # Release what this constructor opened before raising:
                # callers that probe-and-retry (CheckpointManager) must
                # not accumulate sqlite handles and worker pools.
                self.catalog.close()
                if made_backend:
                    self.backend.close()
                raise ValueError(
                    f"store at {root!r} was created with storage layout"
                    f" {recorded!r} but opened with {fp!r}; reopen with a"
                    " matching backend (the startup scavenger would"
                    " otherwise treat every object as missing)"
                )
            self.catalog.set_meta("storage_layout", fp)
        # startup scavenger: reconcile objects against the catalog so a
        # crash mid-write never leaves a row pointing at a torn object.
        # A cleanly-closed store skips the O(objects) sweep.
        if self.catalog.get_meta("clean_shutdown") == "1":
            self.recovery = _storage.RecoveryReport()
        else:
            self.recovery = self.backend.recover(self.catalog)
            # writers register their logical row at first flush; a row
            # with no physicals is a pre-flush crash turd — drop it
            self.catalog.drop_empty_logicals()
        self.catalog.set_meta("clean_shutdown", "0")
        self.budget_multiple = config.budget_multiple
        self.solver = config.solver
        cost_model = config.cost_model
        if cost_model is None:
            # install-time calibration (α table + measured io_table)
            # persists next to the catalog; load it when present,
            # falling back to the shipped defaults (DEFAULT_IO_TABLE).
            # An unreadable table must never block the store — cost
            # models tune plans, they don't gate data.
            cal = calibration_path(root)
            if os.path.exists(cal):
                try:
                    cost_model = CostModel.load(cal)
                except (ValueError, KeyError, TypeError, OSError) as exc:
                    warnings.warn(
                        f"ignoring unreadable cost calibration {cal!r}"
                        f" ({exc}); using default tables — re-run"
                        " calibrate_io() to replace it"
                    )
        self.cost_model = cost_model or CostModel.default()
        self.policy = config.cache
        self.cache = CacheManager(self.catalog, self.policy,
                                  backend=self.backend)
        self.quality = QualityEstimator()
        self.deferred = DeferredCompressor(
            self.catalog, self.policy,
            activation_fraction=config.deferred.activation_fraction,
            backend=self.backend,
        )
        self.enable_deferred = config.deferred.enabled
        self.enable_compaction = config.compaction
        # shared per-store ingest pipeline (§4 write path): created
        # lazily so read-only stores never spawn worker threads
        self.pipelined_ingest = config.ingest.pipelined
        self.ingest_workers = config.ingest.workers
        self.ingest_queue_gops = config.ingest.queue_gops
        if config.ingest.autosize:
            # derive initial pipeline sizing from the calibrated
            # io_table: a slow publish round trip needs more windows in
            # flight (profile.py); runtime growth on backpressure is
            # the adaptive policy's job
            self.ingest_workers, self.ingest_queue_gops = (
                _profile.suggest_ingest_sizing(self.cost_model,
                                               self.backend)
            )
            self.backend.configure_concurrency(max(1, self.ingest_workers))
        self._ingest: Optional[_ingest.IngestPipeline] = None
        self._ingest_init = threading.Lock()
        self._m_joint = None  # joint_counters(), at first joint use
        # -- workload-adaptive format management (profile.py) -------------
        self.profiler: Optional[_profile.AccessProfiler] = None
        self.adaptive: Optional[_profile.AdaptivePolicy] = None
        if config.adaptive.profile or config.adaptive.enabled:
            self.profiler = _profile.AccessProfiler(
                _profile.profile_path(root),
                half_life_s=config.adaptive.half_life_s,
                interval_s=config.adaptive.interval_s,
                persist_every=config.adaptive.persist_every,
                registry=self.registry,
            )
        if config.adaptive.enabled:
            self.adaptive = _profile.AdaptivePolicy(
                self, self.profiler, config.adaptive)
            if tiered is not None:
                # heat-boosted spill order: same LRU_VSS base, but
                # objects in hot intervals outrank every cold one
                tiered.set_priority_fn(self.adaptive.priority_fn)
        # §3 planner / read-path telemetry (all no-ops when the registry
        # is disabled).  Counters are per-store handles: `stats()` reads
        # them back exactly, /metrics sums them across stores.
        reg = self.registry
        self._m_specs = reg.counter(
            "vss_read_specs_total", "ReadSpecs executed through read_batch")
        self._m_groups = reg.counter(
            "vss_read_plan_groups_total",
            "joint (video, view-config) plan groups solved")
        self._m_coalesced = reg.counter(
            "vss_read_specs_coalesced_total",
            "specs that rode another spec's joint plan group")
        self._m_dup_shared = reg.counter(
            "vss_read_duplicate_specs_shared_total",
            "exact-duplicate specs served from a batch sibling's result")
        self._m_objects = reg.counter(
            "vss_read_objects_fetched_total",
            "GOP objects fetched by the read path")
        self._m_fetch_bytes = reg.counter(
            "vss_read_fetch_bytes_total",
            "payload bytes fetched by the read path")
        self._m_dedup = reg.counter(
            "vss_read_gop_fetches_deduped_total",
            "planned GOP fetches served from the batch cache instead of"
            " the backend")
        self._m_decoded = reg.counter(
            "vss_read_gops_decoded_total", "GOPs decoded by the read path")
        self._m_plan_seconds = reg.histogram(
            "vss_read_plan_seconds", "per-spec section-3 planning time",
            buckets=_obs.LATENCY_BUCKETS)
        self._m_predicted_io = reg.counter(
            "vss_plan_predicted_io_seconds_total",
            "cost-model predicted I/O seconds for executed plans")
        self._m_actual_io = reg.counter(
            "vss_plan_actual_io_seconds_total",
            "measured backend fetch seconds for executed plans")
        self._m_ranged_fetches = reg.counter(
            "vss_read_ranged_fetches_total",
            "sub-GOP ranged fetches issued for edge-GOP trims")
        self._m_ranged_saved = reg.counter(
            "vss_read_ranged_bytes_saved_total",
            "bytes NOT moved because an edge-GOP trim fetched only the"
            " prefix it decodes")
        self._m_tile_reads = reg.counter(
            "vss_tile_reads_total",
            "tiled-physical reads that planned a strict tile subset")
        self._m_tile_fetches = reg.counter(
            "vss_tile_fetches_total",
            "tile objects fetched by the read path")
        self._last_scrub: Optional[Dict] = None
        self._metrics_server: Optional[_storage.ObjectServer] = None
        # write listeners: callables invoked with the logical video name
        # whenever its stored state advances (a writer hands off a
        # publish window, a writer closes, a drop).  The serving tier's
        # manifest cache invalidates through this seam.
        self._write_listeners: List = []

    def on_write(self, fn) -> None:
        """Register ``fn(name)`` to run when a logical video's stored
        state changes (publish-window handoff, writer close, drop).
        Listeners must be fast and must not raise — exceptions are
        swallowed so a broken observer can never poison a write."""
        self._write_listeners.append(fn)

    def _notify_write(self, name: str) -> None:
        for fn in list(self._write_listeners):
            try:
                fn(name)
            except Exception:  # noqa: BLE001 - observers never gate writes
                pass

    @property
    def ingest(self) -> _ingest.IngestPipeline:
        """The store's shared `IngestPipeline` — every pipelined writer
        (one per camera stream) submits publish windows here, so N
        concurrent streams interleave their batched puts through one
        bounded queue and worker pool."""
        if self._ingest is None:
            with self._ingest_init:
                if self._ingest is None:
                    self._ingest = _ingest.IngestPipeline(
                        self.backend, self.catalog,
                        workers=self.ingest_workers,
                        queue_gops=self.ingest_queue_gops,
                        registry=self.registry,
                    )
        return self._ingest

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def writer_spec(
        self, spec: WriteSpec, *, batch_gops: int = 1,
        pipelined: Optional[bool] = None,
    ) -> "VSSWriter":
        """Open a streaming writer for ``spec``.  ``batch_gops`` > 1
        buffers encoded GOPs and publishes them through one
        ``backend.batch_put`` per window (amortized I/O + one catalog
        transaction) at the cost of prefix-visibility granularity.

        ``pipelined`` (default: the store's ``pipelined_ingest``) hands
        publish windows to the shared `IngestPipeline` so encoding and
        physical I/O overlap — the writer thread keeps encoding while
        workers drain the bounded queue.  ``close()`` remains a
        durability barrier either way, and a failed put re-raises on
        this writer's next ``append``/``close``; ``pipelined=False``
        publishes synchronously on the appending thread (the pre-
        pipeline behaviour, kept for baselines and debugging)."""
        if not isinstance(spec, WriteSpec):
            raise TypeError(f"writer_spec takes a WriteSpec, got {spec!r}")
        if self.catalog.logical_exists(spec.name):
            raise ValueError(
                f"{spec.name!r} already exists (no-overwrite policy)"
            )
        return VSSWriter(self, spec, batch_gops=batch_gops,
                         pipelined=pipelined)

    def write_spec(self, spec: WriteSpec, frames: np.ndarray) -> PhysicalMeta:
        """Bulk write: all of ``frames`` under one spec (GOP publishes
        are batched — nothing needs to be queryable mid-write)."""
        w = self.writer_spec(spec, batch_gops=BULK_WRITE_BATCH_GOPS)
        w.append(frames)
        return w.close()

    # -- keyword compatibility shims ---------------------------------------
    def writer(
        self,
        name: str,
        *,
        fps: float = 30.0,
        codec: str = "rgb",
        gop_frames: Optional[int] = None,
        budget_bytes: Optional[int] = None,
        t_start: float = 0.0,
    ) -> "VSSWriter":
        return self.writer_spec(WriteSpec(
            name=name, fps=fps, codec=codec, gop_frames=gop_frames,
            budget_bytes=budget_bytes, t_start=t_start,
        ))

    def write(
        self,
        name: str,
        frames: np.ndarray,  # (T, H, W, C) uint8
        *,
        fps: float = 30.0,
        codec: str = "rgb",
        gop_frames: Optional[int] = None,
        budget_bytes: Optional[int] = None,
    ) -> PhysicalMeta:
        return self.write_spec(WriteSpec(
            name=name, fps=fps, codec=codec, gop_frames=gop_frames,
            budget_bytes=budget_bytes,
        ), frames)

    # ------------------------------------------------------------------
    # read path (§3)
    # ------------------------------------------------------------------
    def read_spec(self, spec: ReadSpec) -> ReadResult:
        return self.read_batch([spec])[0]

    def read(
        self,
        name: str,
        *,
        t: Optional[Tuple[float, float]] = None,
        resolution: Optional[Tuple[int, int]] = None,  # (width, height)
        roi: Optional[Box] = None,
        fps: Optional[float] = None,
        codec: str = "rgb",
        quality_eps_db: float = DEFAULT_QUALITY_EPS_DB,
        cache: bool = True,
        method: Optional[str] = None,
    ) -> ReadResult:
        """Keyword compatibility shim over ``read_spec``."""
        return self.read_spec(ReadSpec(
            name=name, t=t, resolution=resolution, roi=roi, fps=fps,
            codec=codec, quality_eps_db=quality_eps_db, cache=cache,
            method=method,
        ))

    def read_batch(self, specs: Sequence[ReadSpec]) -> List[ReadResult]:
        """Plan and execute many reads jointly (order-preserving).

        Specs are grouped by (video, view configuration); each group is
        planned as ONE `SelectionProblem` over the union of its
        intervals, every plan's GOP keys are prefetched in a single
        ``backend.batch_get``, each GOP is decoded at most once per
        batch, exact-duplicate specs share one execution, and cache
        admissions run one eviction/compaction pass per video.  Raises
        on the first failing spec (same exceptions the single-read path
        raises for that spec)."""
        specs = list(specs)
        for sp in specs:
            if not isinstance(sp, ReadSpec):
                raise TypeError(f"read_batch takes ReadSpecs, got {sp!r}")
        if not specs:
            return []
        # read-your-writes: wait out any publish windows still queued in
        # the ingest pipeline for the videos this batch touches, so
        # mid-stream prefix reads observe everything already appended
        if self._ingest is not None:
            self._ingest.barrier({sp.name for sp in specs})
        self.deferred.mark_busy()
        try:
            with _obs.span("vss.store.read_batch", parent=None):
                return self._read_batch(specs)
        finally:
            self.deferred.mark_idle()

    def _read_batch(self, specs: List[ReadSpec]) -> List[ReadResult]:
        snap = _CatalogSnapshot(self.catalog)
        resolved = [sp.resolve(snap.original(sp.name)) for sp in specs]
        if self.profiler is not None:
            # pure observation, after resolve and before planning: the
            # profile never changes what this batch plans or returns
            self.profiler.record_batch(resolved)
        # per-spec trace roots (plan → fetch → decode → admit children);
        # None when telemetry is off — zero span bookkeeping on the
        # disabled path
        roots: Optional[List[_obs.Span]] = None
        if self.tracer.enabled:
            roots = [
                _obs.Span("read", spec=r.name, t0=r.s, t1=r.e,
                          codec=r.codec, batch_size=len(specs))
                for r in resolved
            ]

        # -- plan: one joint problem per (video, view-config) group --------
        groups: Dict[tuple, List[int]] = {}
        for i, r in enumerate(resolved):
            groups.setdefault(r.plan_key(), []).append(i)
        plans: List[Optional[ReadPlan]] = [None] * len(specs)
        for members in groups.values():
            for i, plan in zip(
                members,
                self._plan_group([resolved[i] for i in members], snap),
            ):
                plans[i] = plan
        if roots is not None:
            self._m_specs.inc(len(specs))
            self._m_groups.inc(len(groups))
            self._m_coalesced.inc(len(specs) - len(groups))
            for i, plan in enumerate(plans):
                self._m_plan_seconds.observe(plan.plan_seconds)
                sp = _obs.Span(
                    "plan", segments=len(plan.segments),
                    group_size=len(groups[resolved[i].plan_key()]),
                )
                sp.dur_s = plan.plan_seconds
                roots[i].children.append(sp)

        # -- prefetch: one batch_get per plan group, deduped per video.
        # A single-spec batch (the read()/read_spec path) streams
        # instead: there is nothing to share, and the per-run-group
        # fetch pattern has the lower peak memory (no blob/decode
        # retention across the call) — its _BatchIO only carries the
        # telemetry counters.
        single = len(specs) == 1
        ios: Dict[str, _BatchIO] = {
            name: _BatchIO(self.backend, stream=single)
            for name in dict.fromkeys(r.name for r in resolved)
        }
        if not single:
            for members in groups.values():
                io = ios[resolved[members[0]].name]
                keys: List[str] = []
                claims: List[Tuple[int, int, List[str]]] = []
                for i in members:
                    objs = self._plan_objects(plans[i])
                    keys.extend(g.path for g in objs)
                    if roots is not None:
                        claims.append(
                            (i, len(objs), self._claim_fetches(io, objs))
                        )
                wall = io.prefetch(keys)
                if roots is not None:
                    self._fetch_spans(roots, io, claims, wall)
        elif roots is not None:
            # price the plan before execution fetches anything (a
            # tiered key must be costed at the tier that will actually
            # serve it, not the hot tier it lands in afterwards)
            self._claim_fetches(
                ios[resolved[0].name], self._plan_objects(plans[0])
            )

        # -- execute: duplicates share one materialization.  Within each
        # video group, higher-priority specs materialize first, and
        # among equal priorities the tightest deadline goes first (QoS:
        # urgent requests see their results earliest); results stay
        # order-preserving regardless.
        first_pos: Dict[str, int] = {}
        for i, r in enumerate(resolved):
            first_pos.setdefault(r.name, i)
        inf = float("inf")
        exec_order = sorted(
            range(len(specs)),
            key=lambda i: (
                first_pos[resolved[i].name], -specs[i].priority,
                specs[i].deadline_ms
                if specs[i].deadline_ms is not None else inf,
                i,
            ),
        )
        done: Dict[tuple, Tuple[Optional[np.ndarray], Optional[list]]] = {}
        results: List[Optional[ReadResult]] = [None] * len(specs)
        for i in exec_order:
            r = resolved[i]
            plan, io = plans[i], ios[r.name]
            rkey = r.result_key()
            root = roots[i] if roots is not None else None
            if rkey in done:
                frames, encoded = done[rkey]
                # duplicates share the execution, not the buffers: each
                # result stays independently mutable, as it would be
                # from sequential reads
                frames = None if frames is None else frames.copy()
                encoded = None if encoded is None else list(encoded)
                if root is not None:
                    self._m_dup_shared.inc()
                    root.children.append(
                        _obs.Span("decode", shared=True, gops=0)
                    )
                results[i] = ReadResult(frames, r.codec, encoded, plan,
                                        r.fps, device=self.device)
                continue
            totals0 = io.totals()
            # measured around the execution, fetches made inside it
            # included: they are also its own ``fetch`` children
            with _obs.span("vss.store.decode", parent=root) as dsp:
                if r.codec != "rgb":
                    frames = None
                    encoded = self._execute_encoded(
                        plan, r.roi, r.resolution, r.fps, r.codec,
                        r.scale_to, io,
                    )
                else:
                    encoded = None
                    frames = self._execute(
                        plan, r.roi, r.resolution, r.fps, io
                    )
            done[rkey] = (frames, encoded)
            if r.codec == "rgb" and self.enable_deferred:
                self.deferred.on_uncompressed_read(r.name)
            if dsp is not None:
                gops, objects, nbytes, secs = (
                    t - t0 for t, t0 in zip(io.totals(), totals0)
                )
                dsp.attrs["gops"] = gops
                if objects:
                    # the round trips made inside the execution (the
                    # streaming path, ranged prefixes), summed
                    fsp = _obs.Span(
                        "fetch", inline=True, objects=objects, bytes=nbytes
                    )
                    fsp.dur_s = secs
                    root.children.insert(len(root.children) - 1, fsp)
            results[i] = ReadResult(frames, r.codec, encoded, plan, r.fps,
                                    device=self.device)

        # -- cache admission + batched eviction/compaction (§4) ------------
        admitted_names: List[str] = []
        admitted_keys: set = set()
        for i, r in enumerate(resolved):
            if not specs[i].cache or r.result_key() in admitted_keys:
                continue
            admitted_keys.add(r.result_key())
            out = results[i]
            with _obs.span(
                None, name="admit",
                parent=roots[i] if roots is not None else None,
                video=r.name,
            ):
                self._admit(
                    r.name, out._frames, out.encoded, r.s, r.e, r.roi,
                    r.resolution, r.fps, r.codec, plans[i],
                )
            admitted_names.append(r.name)
        if admitted_names:
            with _obs.span("vss.store.evict", parent=None):
                self.cache.evict_for_batch(admitted_names)
            if self.enable_compaction:
                with _obs.span("vss.store.compact", parent=None):
                    for name in dict.fromkeys(admitted_names):
                        _compact.compact(self.catalog, name, self.backend)

        if roots is not None:
            for io in ios.values():
                gops, objects, nbytes, secs = io.totals()
                self._m_objects.inc(objects)
                self._m_fetch_bytes.inc(nbytes)
                self._m_decoded.inc(gops)
                self._m_actual_io.inc(secs)
            for root in roots:
                self.tracer.record(root.finish())

        return results

    # -- read-path telemetry helpers ----------------------------------------
    def _claim_fetches(
        self, io: _BatchIO, objs: List[GopMeta]
    ) -> List[str]:
        """Attribute one spec's share of its group fetch: the plan's
        object keys nobody in the batch has fetched or claimed yet.
        Each claimed fetch is priced through the cost model BEFORE the
        fetch happens (a tiered key must be priced at the tier that
        serves it, not the hot tier it lands in afterwards)."""
        new_keys: List[str] = []
        predicted = 0.0
        for g in objs:
            if not io.claim(g.path):
                continue
            new_keys.append(g.path)
            predicted += self.cost_model.io_cost(
                self.backend.kind_for(g.path), g.nbytes
            )
        self._m_predicted_io.inc(predicted)
        return new_keys

    def _fetch_spans(
        self, roots: List[_obs.Span], io: _BatchIO,
        claims: List[Tuple[int, int, List[str]]], fetch_wall: float,
    ) -> None:
        """One fetch span per plan-group member, with the objects and
        bytes it claimed (the sizes of the blobs the fetch brought).
        The group's batch_get is one round trip: its measured seconds
        go to the first member's span, and the others are marked
        ``shared``."""
        for n, (i, planned, new_keys) in enumerate(claims):
            self._m_dedup.inc(planned - len(new_keys))
            sp = _obs.Span(
                "fetch",
                objects=len(new_keys),
                bytes=sum(len(io.held(k)) for k in new_keys),
                planned=planned,
                dedup_hits=planned - len(new_keys),
            )
            if n == 0:
                sp.dur_s = fetch_wall
            else:
                sp.attrs["shared"] = True
            roots[i].children.append(sp)

    # -- joint planning ----------------------------------------------------
    def _plan_group(
        self, members: List[ResolvedRead], snap: _CatalogSnapshot
    ) -> List[ReadPlan]:
        """Plan every member of one (video, view-config) group.

        Overlapping/touching member intervals merge into components;
        each component gets ONE problem over the union of its members'
        segments, solved once, then restricted back to per-member
        plans — a fragment the solver picks for a shared segment serves
        every member that demanded it."""
        r0 = members[0]
        order = sorted(range(len(members)), key=lambda i: members[i].s)
        components: List[Tuple[float, float, List[int]]] = []
        for i in order:
            m = members[i]
            if components and m.s <= components[-1][1] + _EPS:
                cs, ce, idxs = components[-1]
                components[-1] = (cs, max(ce, m.e), idxs + [i])
            else:
                components.append((m.s, m.e, [i]))

        plans: List[Optional[ReadPlan]] = [None] * len(members)
        for cs, ce, idxs in components:
            ps = _obs.span("vss.store.plan", parent=None, timed=True)
            with ps:
                runs = self._candidate_runs(
                    r0.name, cs, ce, r0.roi, r0.fps, r0.codec, r0.scale_to,
                    r0.spec.quality_eps_db, snap,
                )
                if not runs:
                    raise RuntimeError(
                        "no admissible fragments cover the read")
                intervals = [(members[i].s, members[i].e) for i in idxs]
                problem, segs = self._build_joint_problem(
                    runs, intervals, cs, ce, r0.codec, r0.fps, r0.scale_to,
                    r0.roi,
                )
                selection = solve(problem, r0.spec.method or self.solver)
            plan_seconds = ps.seconds
            for i in idxs:
                m = members[i]
                indices = [
                    k for k, (a, b) in enumerate(segs)
                    if a >= m.s - _EPS and b <= m.e + _EPS
                ]
                if not indices:
                    # the member's whole interval fell below the sliver
                    # filter inside a larger component: re-plan it alone
                    # so the single-read fallback (one segment spanning
                    # exactly [s, e)) applies — never serve a
                    # neighbouring segment's frames
                    plans[i] = self._plan_group([m], snap)[0]
                    continue
                sub_problem, sub_sel = restrict_to_segments(
                    problem, selection, indices
                )
                plans[i] = ReadPlan(
                    list(sub_problem.segments), sub_problem, sub_sel, runs,
                    plan_seconds,
                )
        return plans

    # -- candidates ------------------------------------------------------
    def _original(self, name: str) -> PhysicalMeta:
        oid = self.catalog.get_original_id(name)
        if oid is None:
            raise KeyError(f"unknown logical video {name!r}")
        return self.catalog.get_physical(oid)

    def _candidate_runs(
        self, name, s, e, roi, out_fps, out_codec, scale_to, eps_db,
        snap: Optional[_CatalogSnapshot] = None,
    ) -> List[Run]:
        snap = snap or _CatalogSnapshot(self.catalog)
        runs: List[Run] = []
        for p in snap.physicals(name):
            if not p.covers_roi(roi):
                continue
            if p.fps < out_fps or (p.fps / out_fps) % 1.0 > 1e-9:
                continue  # only integer frame-rate division
            if not self.quality.admissible(
                p.mse_bound, p.is_original or p.parent_is_original,
                scale_from=p.scale, scale_to=scale_to,
                out_codec=out_codec, eps_db=eps_db,
                fragment_codec=p.codec,
            ):
                continue
            gops = snap.gops(p.physical_id)
            # split into contiguous runs (eviction leaves gaps)
            cur: List[GopMeta] = []
            for g in gops:
                if cur and g.start_frame != (
                    cur[-1].start_frame + cur[-1].num_frames
                ):
                    runs.append(Run(p, cur))
                    cur = []
                cur.append(g)
            if cur:
                runs.append(Run(p, cur))
        # clip to the read interval
        out = [
            r for r in runs if r.t_start < e - 1e-9 and r.t_end > s + 1e-9
        ]
        return out

    # -- problem construction (§3.1) ---------------------------------------
    def _passthrough_ok(self, p: PhysicalMeta, out_codec, out_fps, scale_to,
                        roi) -> bool:
        """Encoded GOPs can be returned verbatim: same codec, same
        sampling density, same fps, identical spatial extent, and an
        untiled layout (tile objects must be stitched, never returned
        as-is)."""
        return (
            p.codec == out_codec
            and p.codec != "rgb"
            and p.fps == out_fps
            and abs(p.scale - scale_to) < 1e-9
            and tuple(p.roi) == tuple(roi)
            and p.tiles == (1, 1)
        )

    def _build_joint_problem(
        self, runs: List[Run], intervals: List[Tuple[float, float]],
        cs, ce, out_codec, out_fps, scale_to, roi,
    ) -> Tuple[SelectionProblem, List[Tuple[float, float]]]:
        """One problem covering the union [cs, ce) of ``intervals``.

        Transition points are run boundaries AND every request's
        endpoints (so per-request restriction falls on segment
        boundaries); ``demands`` counts the requests needing each
        segment.  With a single interval this reduces exactly to the
        single-read §3.1 construction."""
        pts = {cs, ce}
        for r in runs:
            for t in (r.t_start, r.t_end):
                if cs < t < ce:
                    pts.add(t)
        for (s, e) in intervals:
            for t in (s, e):
                if cs < t < ce:
                    pts.add(t)
        pts = sorted(pts)
        # fractional cached-view boundaries can create sub-frame slivers
        # that contain no frame sample — they carry no pixels, drop them
        min_dur = 0.5 / out_fps
        segments = [
            (a, b) for a, b in zip(pts[:-1], pts[1:]) if b - a >= min_dur
        ]
        if not segments:
            segments = [(cs, ce)]
        choices: List[List[SegmentChoice]] = []
        for (a, b) in segments:
            segment_choices = []
            for vi, r in enumerate(runs):
                if r.t_start > a + 1e-9 or r.t_end < b - 1e-9:
                    continue
                segment_choices.append(
                    self._choice_for(vi, r, a, b, out_codec, out_fps,
                                     scale_to, roi)
                )
            if not segment_choices:
                raise RuntimeError(
                    f"no fragment covers segment [{a},{b}) — lossless cover"
                    " violated"
                )
            choices.append(segment_choices)
        demands = [
            sum(1 for (s, e) in intervals
                if a >= s - _EPS and b <= e + _EPS) or 1
            for (a, b) in segments
        ]
        return SelectionProblem(segments, choices, demands), segments

    def _choice_for(self, vi, run: Run, a, b, out_codec, out_fps, scale_to,
                    roi) -> SegmentChoice:
        p = run.physical
        frames = max(1, int(round((b - a) * p.fps)))
        ppf = p.width * p.height
        # tiled layout: an ROI read touches only the tiles covering its
        # box, so both the decode work and the fetched bytes scale with
        # the covered region instead of the full frame — priced here so
        # a tiled fragment competes like any other candidate
        tile_cover: Optional[List[int]] = None
        n_tiles = 1
        if p.tiles != (1, 1):
            rows, cols = tiles_covering(
                p.tiles, p.width, p.height, self._local_box(p, roi)
            )
            tile_cover = [r * p.tiles[1] + c for r in rows for c in cols]
            n_tiles = p.tiles[0] * p.tiles[1]
            ys, xs = tile_bounds(p.height, p.tiles[0]), tile_bounds(
                p.width, p.tiles[1]
            )
            ppf = (ys[rows[-1]][1] - ys[rows[0]][0]) * (
                xs[cols[-1]][1] - xs[cols[0]][0]
            )
        if self._passthrough_ok(p, out_codec, out_fps, scale_to, roi):
            # byte copy of already-encoded GOPs — no decode chain at all
            c_t = self.cost_model.passthrough_cost(frames * ppf)
        else:
            c_t = self.cost_model.transcode_cost(
                p.codec, out_codec, frames * ppf, ppf
            )
        # backend-aware I/O (beyond-paper): price fetching this
        # fragment's GOP objects from whatever tier currently serves
        # them, so otherwise-equal candidates resolve to the faster
        # one.  A GOP straddling several segments is fetched once, so
        # its cost is amortized by frame overlap — summed over the
        # run's segments it charges the full fetch exactly once.
        f0, f1 = self._clamp_frames(run, p.frame_at(a), p.frame_at(b))
        for g in run.gops:
            ov = min(g.start_frame + g.num_frames, f1) - max(
                g.start_frame, f0
            )
            if ov > 0 and g.joint_ref is None:
                nbytes, objects = g.nbytes, 1
                if tile_cover is not None:
                    if g.tile_sizes and len(g.tile_sizes) == n_tiles:
                        nbytes = sum(g.tile_sizes[i] for i in tile_cover)
                    else:
                        nbytes = int(
                            g.nbytes * len(tile_cover) / n_tiles
                        )
                    objects = len(tile_cover)
                c_t += (ov / g.num_frames) * self.cost_model.io_cost(
                    self.backend.kind_for(g.path), nbytes, objects
                )
        # look-back (§3.1): frames from the containing GOP's start to the
        # entry frame must be decoded if we *enter* the video here.
        lookback = 0.0
        if p.codec != "rgb":
            entry = p.frame_at(a)
            g = self._gop_containing(run, entry)
            offset = entry - g.start_frame
            if offset > 0:
                ind, dep = 1, offset - 1  # the GOP's I-frame + P-frames
                alpha_dec = self.cost_model.alpha(p.codec, "rgb", ppf)
                lookback = alpha_dec * ppf * (ind + ETA * dep)
        return SegmentChoice(vi, c_t, lookback)

    @staticmethod
    def _local_box(p: PhysicalMeta, roi: Box) -> Box:
        """An original-coordinate ROI box in ``p``'s local pixel
        coordinates (its stored resolution)."""
        return (
            int(round((roi[0] - p.roi[0]) * p.scale)),
            int(round((roi[1] - p.roi[1]) * p.scale)),
            int(round((roi[2] - p.roi[0]) * p.scale)),
            int(round((roi[3] - p.roi[1]) * p.scale)),
        )

    @staticmethod
    def _clamp_frames(run: Run, f0: int, f1: int) -> Tuple[int, int]:
        """Clamp a frame interval to the run's stored extent (fractional
        read times can round one frame past the last GOP)."""
        lo = run.gops[0].start_frame
        hi = run.gops[-1].start_frame + run.gops[-1].num_frames
        f0 = max(lo, min(f0, hi - 1))
        f1 = max(f0 + 1, min(f1, hi))
        return f0, f1

    @staticmethod
    def _gop_containing(run: Run, frame: int) -> GopMeta:
        for g in run.gops:
            if g.start_frame <= frame < g.start_frame + g.num_frames:
                return g
        return run.gops[-1]

    # -- execution ---------------------------------------------------------
    def _plan_objects(self, plan: ReadPlan) -> List[GopMeta]:
        """Every plain GOP this plan's execution will touch
        (jointly-compressed GOPs reconstruct through their own segment
        objects and are skipped)."""
        objs: List[GopMeta] = []
        for run_idx, a, b in self._grouped_segments(plan):
            run = plan.runs[run_idx]
            p = run.physical
            if p.tiles != (1, 1):
                # tile objects are fetched per-ROI at extract time; a
                # whole-GOP prefetch would defeat the layout's point
                continue
            f0, f1 = self._clamp_frames(
                run, p.frame_at(a), p.frame_at(b)
            )
            for g in run.gops:
                gs, ge = g.start_frame, g.start_frame + g.num_frames
                if gs >= f1 or ge <= f0 or g.joint_ref is not None:
                    continue
                if self._trim_eligible(g, min(f1, ge) - gs, p):
                    # served by a ranged prefix fetch, not a full get
                    continue
                objs.append(g)
        return objs

    @staticmethod
    def _grouped_segments(plan: ReadPlan) -> List[Tuple[int, float, float]]:
        """Consecutive segments served by the same run, merged, so the
        decode chain is walked once per contiguous selection."""
        grouped: List[Tuple[int, float, float]] = []
        for i, (a, b) in enumerate(plan.segments):
            run_idx = plan.run_idx(i)
            if grouped and grouped[-1][0] == run_idx and abs(
                grouped[-1][2] - a
            ) < 1e-9:
                grouped[-1] = (run_idx, grouped[-1][1], b)
            else:
                grouped.append((run_idx, a, b))
        return grouped

    def _execute(
        self, plan: ReadPlan, roi: Box, resolution, out_fps, io: _BatchIO,
    ) -> np.ndarray:
        pieces: List[np.ndarray] = []
        touched: List[int] = []
        tiled = False
        for run_idx, a, b in self._grouped_segments(plan):
            run = plan.runs[run_idx]
            piece, gop_ids = self._extract(
                run, a, b, roi, resolution, out_fps, io
            )
            pieces.append(piece)
            touched.extend(gop_ids)
            tiled = run.physical.tiles != (1, 1)
        self.catalog.touch_gops(touched)
        if len(pieces) == 1 and tiled:
            # a tiled run's assembly is already fresh memory of its own
            # (a bilinear resize's comes back strided: laid out anew)
            return np.ascontiguousarray(pieces[0])
        with _obs.span("vss.store.concat"):
            return np.concatenate(pieces, axis=0)

    def _execute_encoded(
        self, plan: ReadPlan, roi: Box, resolution, out_fps, out_codec,
        scale_to, io: _BatchIO,
    ) -> List[_codec.EncodedGOP]:
        """Produce the encoded result; same-codec fragments pass through."""
        out: List[_codec.EncodedGOP] = []
        touched: List[int] = []
        for run_idx, a, b in self._grouped_segments(plan):
            run = plan.runs[run_idx]
            if self._passthrough_ok(run.physical, out_codec, out_fps,
                                    scale_to, roi):
                encs, gop_ids = self._extract_encoded(run, a, b, out_codec, io)
                out.extend(encs)
            else:
                piece, gop_ids = self._extract(
                    run, a, b, roi, resolution, out_fps, io
                )
                out.extend(
                    _codec.encode_gop(chunk, out_codec,
                                      device=self.device)
                    for _, chunk in _codec.split_into_gops(piece, out_codec)
                )
            touched.extend(gop_ids)
        self.catalog.touch_gops(touched)
        return out

    def _extract_encoded(
        self, run: Run, a, b, out_codec, io: _BatchIO,
    ) -> Tuple[List[_codec.EncodedGOP], List[int]]:
        """Byte-level GOP pass-through; partial edge GOPs are trimmed
        through a decode→re-encode of just that GOP."""
        p = run.physical
        f0, f1 = self._clamp_frames(run, p.frame_at(a), p.frame_at(b))
        out: List[_codec.EncodedGOP] = []
        gop_ids: List[int] = []
        for g in run.gops:
            gs, ge = g.start_frame, g.start_frame + g.num_frames
            if gs >= f1 or ge <= f0:
                continue
            gop_ids.append(g.gop_id)
            if gs >= f0 and ge <= f1:  # fully inside: verbatim bytes
                out.append(_stored_gop(io.get(g.path)))
            else:  # edge GOP: decode, trim, re-encode (the look-back cost)
                lo = max(f0 - gs, 0)
                hi = min(f1, ge) - gs
                if self._trim_eligible(g, hi, p):
                    frames = self._load_gop_prefix(g, hi, io)[lo:]
                else:
                    frames = self._load_gop_frames(g, io)[lo:hi]
                out.append(
                    _codec.encode_gop(frames, out_codec,
                                      device=self.device)
                )
        return out, gop_ids

    def _extract(
        self, run: Run, a, b, roi: Box, resolution, out_fps, io: _BatchIO,
    ) -> Tuple[np.ndarray, List[int]]:
        p = run.physical
        f0, f1 = self._clamp_frames(run, p.frame_at(a), p.frame_at(b))
        gops = [
            g for g in run.gops
            if g.start_frame < f1 and g.start_frame + g.num_frames > f0
        ]
        # spatial crop box (ROI → this video's local pixel coords)
        lx0, ly0, lx1, ly1 = self._local_box(p, roi)
        ox = oy = 0  # origin of the loaded pixel region
        step = int(round(p.fps / out_fps))
        base = gops[0].start_frame
        if p.tiles != (1, 1):
            # already the selected frames of the box alone: the cut
            # below takes the whole of it
            frames, (ox, oy) = self._load_tiled_frames(
                p, gops, (lx0, ly0, lx1, ly1),
                slice(f0 - base, f1 - base, max(step, 1)), io
            )
        else:
            tail = gops[-1]
            hi = min(f1, tail.start_frame + tail.num_frames) - tail.start_frame
            if self._trim_eligible(tail, hi, p):
                # TVC residuals are closed-loop per-pixel, so a byte
                # prefix of the GOP decodes frames [0, hi) bit-exactly —
                # fetch only those bytes instead of the whole object
                parts = self._load_gops_frames(gops[:-1], io)
                parts.append(self._load_gop_prefix(tail, hi, io))
            else:
                parts = self._load_gops_frames(gops, io)
            with _obs.span("vss.store.concat"):
                frames = np.concatenate(parts, axis=0)
            frames = frames[f0 - base : f1 - base]
            # frame-rate division
            if step > 1:
                frames = frames[::step]
        frames = frames[:, ly0 - oy : ly1 - oy, lx0 - ox : lx1 - ox]
        # resample to the requested resolution
        frames = resample(frames, resolution, device=self.device)
        return frames, [g.gop_id for g in gops]

    def _decode_gop_bytes(self, data: bytes) -> np.ndarray:
        return _codec.decode_gop(_stored_gop(data), device=self.device)

    def gop_frames(self, g: GopMeta, source=None) -> np.ndarray:
        """``g``'s frames, its objects fetched through ``source`` (``get``
        and ``batch_get``); a joint GOP is rebuilt from its record's
        segment objects.  By default ``source`` is the backend, outside
        any read: no fetch span, no trace node, no read counter (the
        joint pass loads stored GOPs so); a read hands its `_BatchIO`."""
        source = self.backend if source is None else source
        if g.joint_ref is not None:
            return _joint.reconstruct_gop(self, g, source)
        return self._decode_gop_bytes(source.get(g.path))

    def _load_gop_frames(self, g: GopMeta, io: _BatchIO) -> np.ndarray:
        frames = io.lookup(g.gop_id)
        if frames is None:
            frames = io.keep(self.gop_frames(g, io), g.gop_id)
        return frames

    def _load_gops_frames(
        self, gops: Sequence[GopMeta], io: _BatchIO
    ) -> List[np.ndarray]:
        """Load many GOPs' frames; plain payloads go through one
        ``batch_get`` so sharded/remote backends overlap the I/O.  Blobs
        and decoded frames are shared through ``io`` across every
        request in the batch (each GOP decodes at most once)."""
        plain = [
            g for g in gops
            if g.joint_ref is None and io.lookup(g.gop_id) is None
        ]
        blobs = dict(zip(
            (g.gop_id for g in plain),
            io.batch_get([g.path for g in plain]),
        ))
        return [
            io.keep(self._decode_gop_bytes(blobs[g.gop_id]), g.gop_id)
            if g.gop_id in blobs else self._load_gop_frames(g, io)
            for g in gops
        ]

    # -- ranged sub-GOP reads ------------------------------------------
    def _trim_eligible(self, g: GopMeta, hi: int, p: PhysicalMeta) -> bool:
        """True when frames ``[0, hi)`` of ``g`` can be served by a
        ranged byte-prefix fetch instead of a full-object get.

        Requires a plainly-stored object (not joint, not deferred-zstd
        wrapped, not tiled), a genuine trim (``0 < hi < num_frames``)
        that saves enough of the tail to be worth a second round-trip
        (``hi`` at most `RANGED_HI_FRACTION` of the GOP), and an object
        big enough for ranged I/O to beat one small get."""
        return (
            g.joint_ref is None
            and not g.zwrapped
            and p.tiles == (1, 1)
            and 0 < hi < g.num_frames
            and hi <= RANGED_HI_FRACTION * g.num_frames
            and g.nbytes >= MIN_RANGED_BYTES
        )

    def _load_gop_prefix(
        self, g: GopMeta, hi: int, io: _BatchIO
    ) -> np.ndarray:
        """Decode frames ``[0, hi)`` of ``g`` from a byte prefix.

        Probes the first `HEADER_PROBE_BYTES` of the object, reads the
        v2 header's per-frame offset table, and fetches only the bytes
        up to frame ``hi``'s chunk boundary.  Falls back to the full
        object when the header is unparseable (legacy v1 TVC blobs) or
        lacks offsets.  The prefix decode is bit-exact: TVC residuals
        are closed-loop per-pixel, so frames [0, hi) depend only on
        bytes [0, offsets[hi])."""
        frames = io.lookup(g.gop_id, hi=hi)  # or cut from the whole GOP
        if frames is not None:
            return frames
        blob = io.held(g.path)
        if blob is not None:  # another spec full-fetched the blob
            return self._decode_gop_bytes(blob)[:hi]
        probe = io.get_range(
            g.path, 0, min(_codec.HEADER_PROBE_BYTES, g.nbytes)
        )
        try:
            codec_name, shape, offsets, pstart = _codec.parse_gop_header(
                probe
            )
        except ValueError:
            return self._load_gop_frames(g, io)[:hi]  # not a v2 blob
        t, h, w, c = shape
        if codec_name == "rgb":
            end = pstart + hi * h * w * c
            sub_offsets = None
        elif offsets is not None and hi < len(offsets):
            end = pstart + offsets[hi]
            sub_offsets = tuple(offsets[: hi + 1])
        else:
            return self._load_gop_frames(g, io)[:hi]
        if end > len(probe):
            probe += io.get_range(g.path, len(probe), end - len(probe))
        enc = _codec.EncodedGOP(
            codec_name, (hi, h, w, c), probe[pstart:end], sub_offsets
        )
        frames = _codec.decode_gop(enc, device=self.device)
        self._m_ranged_fetches.inc()
        self._m_ranged_saved.inc(max(0, g.nbytes - len(probe)))
        return io.keep(frames, g.gop_id, hi=hi)

    # -- tiled reads ---------------------------------------------------
    def _load_tiled_frames(
        self,
        p: PhysicalMeta,
        gops: Sequence[GopMeta],
        box: Box,
        frames: slice,
        io: _BatchIO,
    ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Load the tiles of ``gops`` covering local-pixel ``box`` and
        assemble the answer in one pass: ``frames`` (of the GOPs' frames
        end to end) of the box's pixels, each copied once from its tile
        into fresh memory.  Returns the answer and the pixel origin
        ``(ox, oy)`` of its first pixel.

        Each tile is an independently-encoded object, so an ROI read
        fetches and decodes only ``len(rows) * len(cols)`` tiles per
        GOP instead of the full frame.  The answer is what stitching the
        covering tiles and slicing ``[frames, y0:y1, x0:x1]`` would give,
        a box past the covered region clamped as a slice clamps."""
        rows, cols = tiles_covering(p.tiles, p.width, p.height, box)
        ys = tile_bounds(p.height, p.tiles[0])
        xs = tile_bounds(p.width, p.tiles[1])
        ox, oy = xs[cols[0]][0], ys[rows[0]][0]
        # one batched fetch of every not-yet-decoded tile
        need = [
            (g.gop_id, (r, c), tile_key(g.path, r, c))
            for g in gops for r in rows for c in cols
            if io.lookup(g.gop_id, (r, c)) is None
        ]
        blobs = {}
        if need:
            blobs = dict(zip(
                ((gid, tile) for gid, tile, _ in need),
                io.batch_get([k for _, _, k in need]),
            ))
            self._m_tile_fetches.inc(len(need))
        if len(rows) * len(cols) < p.tiles[0] * p.tiles[1]:
            self._m_tile_reads.inc()
        decoded: Dict[Tuple[int, int, int], np.ndarray] = {}
        for g in gops:
            for r in rows:
                for c in cols:
                    tile = io.lookup(g.gop_id, (r, c))
                    if tile is None:
                        tile = io.keep(
                            self._decode_gop_bytes(blobs[g.gop_id, (r, c)]),
                            g.gop_id, (r, c),
                        )
                    decoded[g.gop_id, r, c] = tile
        # the box and frame range as slices of the stitched region
        # would resolve them
        y0, y1, _ = slice(box[1] - oy, box[3] - oy).indices(
            ys[rows[-1]][1] - oy)
        x0, x1, _ = slice(box[0] - ox, box[2] - ox).indices(
            xs[cols[-1]][1] - ox)
        y0, y1 = y0 + oy, max(y0, y1) + oy
        x0, x1 = x0 + ox, max(x0, x1) + ox
        # each covering tile's overlap with the box, where it goes in
        # the answer and where it lies in the tile; a tile the box
        # misses is skipped
        parts = []
        for r in rows:
            ty0, ty1 = max(ys[r][0], y0), min(ys[r][1], y1)
            for c in cols:
                tx0, tx1 = max(xs[c][0], x0), min(xs[c][1], x1)
                if ty0 < ty1 and tx0 < tx1:
                    parts.append((r, c, (
                        slice(ty0 - y0, ty1 - y0), slice(tx0 - x0, tx1 - x0),
                    ), (
                        slice(ty0 - ys[r][0], ty1 - ys[r][0]),
                        slice(tx0 - xs[c][0], tx1 - xs[c][0]),
                    )))
        corner = decoded[gops[0].gop_id, rows[0], cols[0]]
        sizes = [len(decoded[g.gop_id, rows[0], cols[0]]) for g in gops]
        sel = range(*frames.indices(sum(sizes)))
        out = np.empty((len(sel), y1 - y0, x1 - x0) + corner.shape[3:],
                       corner.dtype)
        with _obs.span("vss.store.stitch", bytes=out.nbytes):
            g0 = 0  # the GOP's first frame, end to end
            for g, n in zip(gops, sizes):
                # the answer's frames [k0, k1) are this GOP's
                k0 = max(0, -((sel.start - g0) // sel.step))
                k1 = min(len(sel), -((sel.start - g0 - n) // sel.step))
                if k0 < k1:
                    fs = slice(sel[k0] - g0, sel[k1 - 1] - g0 + 1, sel.step)
                    for r, c, (dy, dx), (sy, sx) in parts:
                        out[k0:k1, dy, dx] = \
                            decoded[g.gop_id, r, c][fs, sy, sx]
                g0 += n
        return out, (x0, y0)

    # ------------------------------------------------------------------
    # joint compression driver (§5.1) — candidate search + Algorithm 1
    # ------------------------------------------------------------------
    def apply_joint_compression(
        self,
        names: Optional[Sequence[str]] = None,
        *,
        merge: str = "unprojected",
        tau_db: float = 24.0,
        max_pairs: int = 64,
    ) -> List[int]:
        """Find overlapping GOP pairs across logical videos and jointly
        compress them. Returns the created joint record ids."""
        names = list(names or self.catalog.list_logical())
        # each frame's features once a pass, shared by the candidate
        # search and Algorithm 1; dropped when the pass returns
        memo = FeatureMemo(self.joint_counters().features)
        index = CandidateIndex(device=self.device, features=memo)
        owner: Dict[int, str] = {}
        for name in names:
            for p in self.catalog.physicals_for(name):
                if not p.is_original or p.tiles != (1, 1):
                    # tiled GOPs have no single whole-frame object to
                    # rewrite as a joint segment — leave them alone
                    continue
                for g in self.catalog.gops_for(p.physical_id):
                    if g.joint_ref is not None:
                        continue
                    index.add_gop(g.gop_id, self.gop_frames(g))
                    owner[g.gop_id] = name
        joint_ids: List[int] = []
        used: set = set()
        pairs = index.find_pairs()
        self.joint_counters().candidates.inc(len(pairs))
        for a, b, _n in pairs:
            if len(joint_ids) >= max_pairs:
                break
            if a in used or b in used:
                continue
            if owner[a] == owner[b]:
                continue  # pairs must span different logical videos (§5.1)
            jid = _joint.jointly_compress_gops(
                self, a, b, merge=merge, tau_db=tau_db, features=memo
            )
            if jid is not None:
                joint_ids.append(jid)
                used.add(a)
                used.add(b)
        return joint_ids

    def joint_counters(self):
        """The joint counters in the store's registry
        (`joint.JointCounters`), registered at the store's first joint
        pass or first rebuild of a joint GOP, so a store that does
        neither exposes none of them."""
        if self._m_joint is None:
            reg = self.registry
            self._m_joint = _joint.JointCounters(
                pairs={o: reg.counter(
                    "vss_joint_pairs_total",
                    "GOP pairs Algorithm 1 ran on, by its outcome",
                    labels={"outcome": o}) for o in _joint.OUTCOMES},
                candidates=reg.counter(
                    "vss_joint_candidates_total",
                    "GOP pairs the candidate search returned"),
                gops=reg.counter("vss_joint_gops_total",
                                 "GOPs the joint pass stored jointly"),
                features={o: reg.counter(
                    "vss_joint_features_total",
                    "frame feature lookups of the joint pass, by whether"
                    " the features were computed or reused",
                    labels={"outcome": o}) for o in MEMO_OUTCOMES},
                rebuilds={s: reg.counter(
                    "vss_joint_rebuilds_total",
                    "jointly stored GOPs rebuilt from their record, by"
                    " side", labels={"side": s}) for s in _joint.SIDES},
                rebuild_frames=reg.counter(
                    "vss_joint_rebuild_frames_total",
                    "frames the rebuilds of joint GOPs returned"),
            )
        return self._m_joint

    # -- cache admission (§4) ----------------------------------------------
    def _admit(
        self, name, frames, encoded, s, e, roi, resolution, out_fps,
        out_codec, plan: ReadPlan,
    ) -> Optional[int]:
        original = self._original(name)
        # skip admission when the result is identical in configuration to
        # an existing full-coverage view (nothing new to materialize)
        for p in self.catalog.physicals_for(name):
            if (
                p.codec == out_codec
                and (p.width, p.height) == tuple(resolution)
                and p.roi == roi
                and p.fps == out_fps
                and p.covers_time(s, e)
            ):
                return None
        # step error: resample + compression, measured on a sample
        parent = plan.runs[plan.run_idx(0)].physical
        with _obs.span("vss.store.admit_step_mse"):
            step_mse = self._measure_step_mse(
                parent, frames, encoded, out_codec, resolution, roi
            )
        bound = chain_mse_bound(
            parent.mse_bound, step_mse,
            parent.is_original,
        )
        with _obs.span("vss.store.admit_catalog"):
            pid = self.catalog.add_physical(
                name, resolution[0], resolution[1], out_fps, out_codec, roi,
                s, e, bound, parent_is_original=parent.is_original,
                is_original=False,
            )
            tick = self.catalog.lru_clock()
        with _obs.span("vss.store.admit_put"):
            if encoded is not None:
                chunks = [
                    (enc, _codec.serialize_gop(enc)) for enc in encoded
                ]
                starts: List[int] = []
                start = 0
                for enc, _data in chunks:
                    starts.append(start)
                    start += enc.num_frames
            else:
                split = [
                    (start, _codec.encode_gop(chunk, "rgb"))
                    for start, chunk in _codec.split_into_gops(frames, "rgb")
                ]
                chunks = [
                    (enc, _codec.serialize_gop(enc)) for _s, enc in split
                ]
                starts = [s0 for s0, _enc in split]
            keys = [f"{name}/{pid}/{i}.tvc" for i in range(len(chunks))]
            # publish-then-index, batch-wide: every object is durable
            # (atomic puts, fanned out by sharded backends) before any
            # catalog row that references it exists
            self.backend.batch_put([
                (key, data) for key, (_enc, data) in zip(keys, chunks)
            ])
        with _obs.span("vss.store.admit_catalog"):
            self.catalog.add_gops([
                (pid, i, starts[i], chunks[i][0].num_frames,
                 len(chunks[i][1]), keys[i], tick)
                for i in range(len(chunks))
            ])
        return pid

    def _measure_step_mse(
        self, parent: PhysicalMeta, frames, encoded, out_codec, resolution,
        roi,
    ) -> float:
        """Exact step error on a sample (§3.2 'periodically samples...')."""
        if frames is None:
            # pass-through result: no pixels were materialized; use the
            # predicted (MBPP-style) compression estimate instead
            comp_mse = self.quality.compression_mse(out_codec)
        elif encoded is not None:
            n = min(4, frames.shape[0])
            sample = frames[:n]
            decoded = _codec.decode_gop(encoded[0], device=self.device)
            sample_rt = decoded[:n]
            comp_mse = exact_mse(sample_rt, sample)
            self.quality.observe_compression(out_codec, comp_mse)
        else:
            comp_mse = 0.0
        scale_to = resolution[0] / max(roi[2] - roi[0], 1)
        res_mse = self.quality.resample_mse(parent.scale, scale_to)
        return res_mse + comp_mse

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    def stats(self, name: str) -> StoreStats:
        """Catalog summary for ``name`` plus this store's read-path
        telemetry (a typed view over the `repro_torch.obs` registry handles).
        Mapping-compatible: ``stats(name)["gops"]`` keeps working."""
        if self._ingest is not None:  # count fully-indexed state only
            self._ingest.barrier({name})
        physicals = self.catalog.physicals_for(name)
        return StoreStats(
            physical_videos=len(physicals),
            gops=sum(
                len(self.catalog.gops_for(p.physical_id)) for p in physicals
            ),
            bytes=self.catalog.total_bytes(name),
            budget=self.catalog.get_budget(name),
            specs_read=int(self._m_specs.value),
            plan_groups=int(self._m_groups.value),
            specs_coalesced=int(self._m_coalesced.value),
            objects_fetched=int(self._m_objects.value),
            fetch_bytes=int(self._m_fetch_bytes.value),
            gop_fetches_deduped=int(self._m_dedup.value),
            gops_decoded=int(self._m_decoded.value),
            predicted_io_seconds=float(self._m_predicted_io.value),
            actual_io_seconds=float(self._m_actual_io.value),
            ingest=self._ingest.stats() if self._ingest is not None else None,
        )

    def recent_traces(self, n: Optional[int] = None) -> List[Dict]:
        """The last ``n`` (default: all retained) read-request trace
        trees, oldest first, as JSON-ready dicts: one ``read`` root per
        `ReadSpec` with ``plan`` → ``fetch`` → ``decode`` → ``admit``
        children (see `repro_torch.obs.trace.Span.to_dict` for the schema).
        Empty when telemetry is disabled."""
        return self.tracer.recent(n)

    def health(self) -> Dict:
        """Liveness/readiness snapshot — the body behind ``GET
        /healthz``.  ``status`` is ``"ok"`` unless the backend probe
        fails or the ingest pipeline has queued windows with no live
        worker to drain them; per-layer blocks carry the detail."""
        t0 = time.perf_counter()
        backend_ok, backend_err = True, None
        try:
            self.backend.exists("healthz-probe")
        except Exception as exc:  # noqa: BLE001 - a health probe maps
            # every failure mode to "unreachable", it never raises
            backend_ok, backend_err = False, f"{type(exc).__name__}: {exc}"
        backend = {
            "ok": backend_ok,
            "probe_seconds": time.perf_counter() - t0,
        }
        if backend_err:
            backend["error"] = backend_err
        ingest: Dict = {"started": self._ingest is not None}
        ingest_ok = True
        if self._ingest is not None:
            st = self._ingest.stats()
            workers_alive = self._ingest.workers_alive()
            ingest.update(
                workers_alive=workers_alive,
                queued_gops=st.queued_gops,
                errors=st.errors,
            )
            # workers=0 publishes inline — queued windows with zero
            # LIVE workers is only a failure when workers were asked for
            ingest_ok = (
                self._ingest.configured_workers == 0
                or workers_alive > 0
                or st.queued_gops == 0
            )
            ingest["ok"] = ingest_ok
        scrub: Dict = {
            "startup_recovery_clean": self.recovery.clean,
            "last_scrub": self._last_scrub,
        }
        return {
            "status": "ok" if backend_ok and ingest_ok else "degraded",
            "backend": backend,
            "ingest": ingest,
            "scrub": scrub,
        }

    def start_metrics_server(
        self, *, host: str = "127.0.0.1", port: int = 0
    ) -> _storage.ObjectServer:
        """Expose this store's ``GET /metrics`` (Prometheus text) and
        ``GET /healthz`` (JSON) over HTTP.  Starts (once) a store-less
        `ObjectServer` — object routes answer 503 — on a daemon thread;
        the returned server's ``.url`` is the scrape target and
        ``close()`` (or closing the store) shuts it down."""
        if self._metrics_server is None:
            self._metrics_server = _storage.ObjectServer(
                None, host=host, port=port,
                registry=self.registry, health=self.health,
            )
        return self._metrics_server

    def scrub(self, *, collect_orphans: bool = False):
        """On-demand integrity pass over every object the catalog
        references.  On a `ReplicatedBackend` this is the self-healing
        scrub: every replica of every GOP is fetched and validated
        (`validate_gop_bytes`), under-replicated / torn / divergent
        objects are re-replicated from a healthy copy, and misplaced
        replicas are pruned — run it after replacing a failed volume to
        restore full replication.  On single-copy backends it degrades
        to the startup scavenge.  Queued ingest windows are drained
        first so the scrub sees a settled catalog.

        ``collect_orphans`` additionally deletes objects no catalog row
        references.  Leave it off (the default) unless writes are
        quiesced: publishes are put-then-index, so a concurrent
        writer's freshly published window is indistinguishable from an
        orphan and collecting it would manufacture an
        indexed-but-missing GOP.  Startup recovery — which runs before
        any writer exists — always collects."""
        if self._ingest is not None:
            self._ingest.drain()
        report = self.backend.scrub(self.catalog,
                                    collect_orphans=collect_orphans)
        self._last_scrub = {
            "t_wall": time.time(),
            "clean": report.clean,
            "report": (
                dataclasses.asdict(report)
                if dataclasses.is_dataclass(report) else repr(report)
            ),
        }
        return report

    def drop(self, name: str) -> None:
        """Delete a logical video: catalog rows and backend objects."""
        if self._ingest is not None:  # don't race in-flight publishes
            self._ingest.barrier({name})
        for key in self.catalog.drop_logical(name):
            self.backend.delete(key)
        if self.profiler is not None:
            self.profiler.forget(name)
        self._notify_write(name)

    def adapt(self) -> Dict:
        """Run one adaptive-policy tick (profile.py): materialize hot
        derived views ahead of demand, promote/demote tier placement by
        interval heat, schedule deferred compression around live
        ingest, and grow the pipeline under backpressure.  Returns a
        report of the decisions taken.  A no-op (empty report) unless
        ``config.adaptive.enabled``."""
        if self.adaptive is None:
            return {"enabled": False}
        return self.adaptive.run_once()

    def calibrate_io(
        self, backends: Optional[Dict[str, _storage.StorageBackend]] = None,
        *, save: bool = True, **kw,
    ) -> Dict[str, Tuple[float, float]]:
        """Measure I/O profiles on this store's actual backend (the
        install-time fig22 step) and fold them into the live cost
        model.  With ``save`` (default), the whole model — α table plus
        the measured io_table — persists to ``calibration_path(root)``,
        which `VSS` loads on every later startup; stores without the
        file keep using `DEFAULT_IO_TABLE`.  ``backends`` maps extra
        {kind: backend} pairs to measure (e.g. a candidate remote
        store); the store's own backend contributes its
        ``calibration_targets()`` — the tier a cache miss would pay
        for, so a ``tiered:remote`` store calibrates the remote
        profile rather than filing measurements under a wrapper
        kind."""
        from repro_torch.core import cost as _cost

        if backends is None:
            backends = {}
        for kind, b in self.backend.calibration_targets().items():
            backends.setdefault(kind, b)
        kw.setdefault("device", self.device)
        table = _cost.calibrate_io(backends, **kw)
        self.cost_model.io_table.update(table)
        if save:
            self.cost_model.save(calibration_path(self.root))
        return table

    def close(self):
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._ingest is not None:
            # land every queued publish window, then stop the workers —
            # close() is a store-wide durability barrier
            self._ingest.drain()
            self._ingest.close()
        self.deferred.stop_background()
        if self.profiler is not None:
            try:
                self.profiler.save()  # the profile survives reopen
            except OSError:
                pass  # a full disk must not block a clean shutdown
        self.catalog.set_meta("clean_shutdown", "1")
        self.catalog.close()
        self.backend.close()


class VSSWriter:
    """Streaming, non-blocking writer: flushed GOPs are queryable.

    The logical video is registered at the FIRST flush — abandoning a
    writer that never flushed leaves no catalog state at all (the
    orphaned-logical bug the startup scavenger also cleans for older
    stores).  With ``batch_gops`` > 1, encoded GOPs buffer and publish
    through one ``backend.batch_put`` + one catalog transaction per
    window; the publish-before-index order holds batch-wide.

    Pipelined mode (the default) submits each publish window to the
    store's shared `IngestPipeline` instead of blocking on the put:
    encoding continues on this thread while workers drain the queue,
    and N writers (one per camera) interleave their windows through the
    same pool.  ``close()`` is still a durability barrier — it returns
    only after every window is durable and indexed — and a failed put
    re-raises here on the next ``append``/``close``, never silently
    dropping a GOP.  Mid-stream reads stay correct because the store
    waits out this video's queued windows before planning."""

    def __init__(self, store: VSS, spec: WriteSpec, *, batch_gops: int = 1,
                 pipelined: Optional[bool] = None):
        self.store = store
        self.spec = spec
        self.name = spec.name
        self.fps = spec.fps
        self.codec = spec.codec
        self.gop_frames = spec.gop_frames
        self.budget_bytes = spec.budget_bytes
        self.tiles = spec.tiles  # (rows, cols) tile grid, or None
        self.batch_gops = max(1, int(batch_gops))
        if pipelined is None:
            pipelined = store.pipelined_ingest
        self._channel = store.ingest.channel(spec.name) if pipelined else None
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._next_frame = 0
        self._next_idx = 0
        self._pid: Optional[int] = None
        self._bytes_written = 0
        self._t_start = spec.t_start
        self._closed = False
        # encoded GOPs awaiting one batched publish:
        # (key, [(object key, data), ...], nframes, tile_sizes) — one
        # object for the ordinary layout, rows*cols objects when tiled
        self._pending: List[
            Tuple[str, List[Tuple[str, bytes]], int, Optional[List[int]]]
        ] = []

    def _ensure_physical(self, frame_shape) -> None:
        if self._pid is not None:
            return
        # register the logical row only now that bytes are in flight —
        # raises ValueError if another writer won the race for the name
        self.store.catalog.create_logical(self.name, self.budget_bytes or 0)
        h, w, c = frame_shape
        roi = full_roi(w, h)
        self._pid = self.store.catalog.add_physical(
            self.name, w, h, self.fps, self.codec, roi,
            self._t_start, self._t_start, mse_bound=0.0,
            parent_is_original=True, is_original=True,
            tiles=self.tiles or (1, 1),
        )
        self.store.catalog.set_original(self.name, self._pid)
        if self.gop_frames is None:
            self.gop_frames = (
                _codec.gop.frames_per_uncompressed_gop((h, w, c))
                if self.codec == "rgb"
                else _codec.gop.DEFAULT_COMPRESSED_GOP_FRAMES
            )

    def _check_pipeline_error(self) -> None:
        """Exact error propagation: a window that failed in a worker
        re-raises on the owning writer's next call.  The writer is
        poisoned — its queued windows were discarded by the pipeline
        (indexing past the failure would fake a durable prefix)."""
        if self._channel is not None and self._channel.error is not None:
            self._closed = True
            raise self._channel.error

    def append(self, frames: np.ndarray) -> None:
        self._check_pipeline_error()
        if self._closed:
            raise RuntimeError("writer closed")
        frames = np.asarray(frames, np.uint8)
        self._ensure_physical(frames.shape[1:])
        self._buf.append(frames)
        self._buffered += frames.shape[0]
        while self._buffered >= self.gop_frames:
            with _obs.span("vss.writer.concat", parent=None):
                chunk = np.concatenate(self._buf, axis=0)
            # consume the buffer BEFORE flushing: if the flush's publish
            # fails, the frames live in _pending (buffered back for the
            # retry) — leaving them here too would re-encode them twice
            rest = chunk[self.gop_frames :]
            self._buf = [rest] if rest.shape[0] else []
            self._buffered = rest.shape[0]
            self._flush_gop(chunk[: self.gop_frames])

    def _flush_gop(self, chunk: np.ndarray) -> None:
        with _obs.span("vss.writer.flush_gop", parent=None):
            key = f"{self.name}/{self._pid}/{self._next_idx}.tvc"
            tile_sizes: Optional[List[int]] = None
            if self.tiles is not None:
                # tiled layout: encode each spatial tile as its own
                # independently-decodable object so ROI reads can fetch and
                # decode only the tiles covering their box.  TVC residuals
                # are per-pixel, so the split is lossless — stitching the
                # tiles back reproduces the whole-frame encode bit-exactly.
                rr, cc = self.tiles
                items: List[Tuple[str, bytes]] = []
                tile_sizes = []
                for r, (y0, y1) in enumerate(tile_bounds(chunk.shape[1], rr)):
                    for c, (x0, x1) in enumerate(
                        tile_bounds(chunk.shape[2], cc)
                    ):
                        enc = _codec.encode_gop(
                            np.ascontiguousarray(chunk[:, y0:y1, x0:x1]),
                            self.codec, device=self.store.device,
                        )
                        data = _codec.serialize_gop(enc)
                        items.append((tile_key(key, r, c), data))
                        tile_sizes.append(len(data))
            else:
                enc = _codec.encode_gop(chunk, self.codec,
                                        device=self.store.device)
                items = [(key, _codec.serialize_gop(enc))]
            self._pending.append((key, items, chunk.shape[0], tile_sizes))
            self._next_idx += 1
            if len(self._pending) >= self.batch_gops:
                self._publish_pending()

    def _publish_pending(self) -> None:
        """Turn the buffered GOPs into one `PublishWindow` and hand it
        off — to the shared pipeline (non-blocking; backpressure when
        the queue is full) or, for blocking writers, executed inline.
        Both paths run the identical publish-then-index protocol (crash
        safety: see repro_torch.storage.recovery): the whole window is
        durable before any row references it, rows index in one
        windowed catalog transaction, and only then does the prefix
        horizon advance (§2 streaming writes)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        base_idx = self._next_idx - len(pending)
        rows = []
        items: List[Tuple[str, bytes]] = []
        start = self._next_frame
        for j, (key, gop_items, nframes, tile_sizes) in enumerate(pending):
            nbytes = sum(len(d) for _, d in gop_items)
            row = (self._pid, base_idx + j, start, nframes, nbytes, key)
            if tile_sizes is not None:
                row += (json.dumps(tile_sizes),)
            rows.append(row)
            items.extend(gop_items)
            start += nframes
        window = _ingest.PublishWindow(
            pid=self._pid,
            items=items,
            rows=rows,
            t_end=self._t_start + start / self.fps,
        )
        try:
            if self._channel is None:
                _ingest.publish_window(
                    self.store.backend, self.store.catalog, window
                )
            else:
                self.store.ingest.submit(self._channel, window)
        except BaseException:
            # nothing from this window was handed off (an inline publish
            # failed before indexing; a rejected submit never queued):
            # restore the buffer so the writer's frame accounting still
            # matches the catalog and a retrying caller republishes the
            # identical window instead of indexing past a phantom hole
            self._pending = pending + self._pending
            raise
        self._next_frame = start
        self._bytes_written += window.nbytes
        # provisional budget: grows with the stream so cache admission
        # (and the adaptive policy's ahead-of-demand materialization)
        # works DURING live ingest — a zero budget until close() would
        # evict every view the moment it lands.  close() writes the
        # final figure with the same formula.
        self.store.catalog.set_budget(self.name, self.budget_bytes or int(
            self.store.budget_multiple * max(self._bytes_written, 1)
        ))
        # the video's readable state is advancing (the pipeline indexes
        # asynchronously, but readers barrier on this video before
        # planning, so invalidating at handoff is always conservative)
        self.store._notify_write(self.name)

    def close(self) -> PhysicalMeta:
        self._check_pipeline_error()
        if self._buffered:
            chunk = np.concatenate(self._buf, axis=0)
            self._flush_gop(chunk)
            self._buf, self._buffered = [], 0
        self._publish_pending()
        if self._channel is not None:
            # durability barrier: every window durable AND indexed (or
            # the failure re-raises) before close() returns
            self.store.ingest.flush(self._channel)
        self._closed = True
        if self._pid is None:
            raise ValueError(
                f"writer for {self.name!r} closed with no frames appended"
            )
        budget = self.budget_bytes or int(
            self.store.budget_multiple * max(self._bytes_written, 1)
        )
        self.store.catalog.set_budget(self.name, budget)
        self.store._notify_write(self.name)
        return self.store.catalog.get_physical(self._pid)
