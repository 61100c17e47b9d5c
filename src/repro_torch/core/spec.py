"""Declarative read/write specs — the Figure 1 API as immutable values.

The paper's premise is that callers state *what* view they want
(interval, resolution, ROI, fps, codec, quality) and the §3 planner
decides *how* to materialize it.  `ReadSpec` and `WriteSpec` make that
request a first-class value: validated and canonicalized once at
construction (codec aliases resolved, intervals ordered, ROI boxes
well-formed), hashable so batches can be deduplicated, and independent
of any `VSS` instance so a VDBMS can build plans of specs long before
it holds a store handle.

Validation happens in two stages:

  * construction — everything checkable without a catalog: codec
    canonicalization, interval ordering, ROI well-formedness, positive
    fps/resolution, known solver method;
  * ``ReadSpec.resolve(original)`` — everything relative to the stored
    video: interval defaulting and clamping against the original's
    bounds (sub-epsilon float slop is clamped, genuinely out-of-range
    reads raise), ROI containment in the original frame, native
    resolution/fps defaulting.

``VSS.read()/write()/writer()`` are thin keyword shims that build a
spec and call ``read_spec``/``write_spec``/``writer_spec``; the batched
entry point ``VSS.read_batch`` takes a list of `ReadSpec`s and plans
them jointly (see `repro_torch.core.store`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.codec import canonical_codec
from repro_torch.core.types import (
    Box,
    DEFAULT_QUALITY_EPS_DB,
    PhysicalMeta,
)

_EPS = 1e-9
SOLVER_METHODS = (None, "dp", "z3", "greedy", "brute")


def _check_interval(t) -> Tuple[float, float]:
    try:
        s, e = float(t[0]), float(t[1])
    except (TypeError, ValueError, IndexError):
        raise ValueError(f"t must be a (start, end) pair, got {t!r}") from None
    if not (math.isfinite(s) and math.isfinite(e)):
        raise ValueError(f"non-finite read interval {t!r}")
    if e <= s:
        raise ValueError("empty read interval")
    return (s, e)


def _check_roi(roi) -> Box:
    try:
        x0, y0, x1, y1 = (int(v) for v in roi)
    except (TypeError, ValueError):
        raise ValueError(
            f"roi must be an (x0, y0, x1, y1) box, got {roi!r}"
        ) from None
    if x0 < 0 or y0 < 0 or x1 <= x0 or y1 <= y0:
        raise ValueError(f"degenerate roi {roi!r}")
    return (x0, y0, x1, y1)


def _check_resolution(resolution) -> Tuple[int, int]:
    try:
        w, h = int(resolution[0]), int(resolution[1])
    except (TypeError, ValueError, IndexError):
        raise ValueError(
            f"resolution must be a (width, height) pair, got {resolution!r}"
        ) from None
    if w <= 0 or h <= 0:
        raise ValueError(f"non-positive resolution {resolution!r}")
    return (w, h)


@dataclasses.dataclass(frozen=True)
class ReadSpec:
    """One declarative read request over a logical video.

    ``None`` fields default to the stored original's native value at
    resolve time (full interval, full ROI, native resolution/fps).
    """

    name: str
    t: Optional[Tuple[float, float]] = None
    resolution: Optional[Tuple[int, int]] = None  # (width, height)
    roi: Optional[Box] = None  # original-coordinate box, half-open
    fps: Optional[float] = None
    codec: str = "rgb"
    quality_eps_db: float = DEFAULT_QUALITY_EPS_DB
    cache: bool = True
    method: Optional[str] = None  # solver override; None = store default
    # QoS hint: within one video's plan group, ``read_batch`` executes
    # higher-priority specs first (ties keep submission order).  It does
    # not change *what* is planned or returned — only the order work is
    # materialized in, so urgent requests see their results earliest.
    priority: int = 0
    # Deadline budget in milliseconds, relative to batch submission.
    # Within equal priority, ``read_batch`` materializes tighter
    # deadlines first (None sorts last); the serving tier additionally
    # sheds requests whose deadline expired before dispatch.  Like
    # ``priority`` it never changes what is planned or returned.
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"bad logical video name {self.name!r}")
        object.__setattr__(self, "codec", canonical_codec(self.codec))
        if self.t is not None:
            object.__setattr__(self, "t", _check_interval(self.t))
        if self.roi is not None:
            object.__setattr__(self, "roi", _check_roi(self.roi))
        if self.resolution is not None:
            object.__setattr__(
                self, "resolution", _check_resolution(self.resolution)
            )
        if self.fps is not None:
            fps = float(self.fps)
            if not math.isfinite(fps) or fps <= 0:
                raise ValueError(f"non-positive fps {self.fps!r}")
            object.__setattr__(self, "fps", fps)
        eps_db = float(self.quality_eps_db)
        if not math.isfinite(eps_db):
            raise ValueError(f"non-finite quality_eps_db {eps_db!r}")
        object.__setattr__(self, "quality_eps_db", eps_db)
        if self.method not in SOLVER_METHODS:
            raise ValueError(
                f"unknown solver method {self.method!r}"
                f" (expected one of {SOLVER_METHODS[1:]})"
            )
        try:
            priority = int(self.priority)
        except (TypeError, ValueError):
            raise ValueError(
                f"priority must be an integer, got {self.priority!r}"
            ) from None
        object.__setattr__(self, "priority", priority)
        if self.deadline_ms is not None:
            try:
                deadline = float(self.deadline_ms)
            except (TypeError, ValueError):
                raise ValueError(
                    f"deadline_ms must be a number, got {self.deadline_ms!r}"
                ) from None
            if not math.isfinite(deadline) or deadline < 0:
                raise ValueError(f"bad deadline_ms {self.deadline_ms!r}")
            object.__setattr__(self, "deadline_ms", deadline)

    # -- catalog-relative resolution ------------------------------------
    def resolve(self, original: PhysicalMeta) -> "ResolvedRead":
        """Fill defaults from the stored original and validate bounds."""
        s, e = self.t if self.t is not None else (
            original.t_start, original.t_end
        )
        if s < original.t_start - _EPS or e > original.t_end + _EPS:
            raise ValueError(
                f"read [{s},{e}) outside original interval"
                f" [{original.t_start},{original.t_end})"
            )
        # clamp float slop (never widens the interval)
        s = max(s, original.t_start)
        e = min(e, original.t_end)
        roi = self.roi or original.roi
        ox0, oy0, ox1, oy1 = original.roi
        x0, y0, x1, y1 = roi
        if x0 < ox0 or y0 < oy0 or x1 > ox1 or y1 > oy1:
            raise ValueError(
                f"roi {roi!r} outside frame bounds {original.roi!r}"
            )
        fps = self.fps or original.fps
        rw, rh = x1 - x0, y1 - y0
        resolution = self.resolution or (
            int(round(rw * original.scale)), int(round(rh * original.scale))
        )
        return ResolvedRead(
            spec=self, s=s, e=e, roi=roi, fps=fps, resolution=resolution,
            scale_to=resolution[0] / rw,
        )


@dataclasses.dataclass(frozen=True)
class ResolvedRead:
    """A `ReadSpec` with all defaults filled against the stored original."""

    spec: ReadSpec
    s: float
    e: float
    roi: Box
    fps: float
    resolution: Tuple[int, int]
    scale_to: float

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def codec(self) -> str:
        return self.spec.codec

    def plan_key(self) -> tuple:
        """Requests with equal plan keys want the *same view* of the same
        video (possibly over different intervals) and can share one joint
        `SelectionProblem` — a fragment chosen once serves all of them."""
        return (
            self.spec.name, self.spec.codec, self.fps, self.roi,
            self.resolution, self.spec.quality_eps_db, self.spec.method,
        )

    def result_key(self) -> tuple:
        """Full identity of the materialized output: duplicates within a
        batch execute once and share the result payload."""
        return self.plan_key() + (self.s, self.e)


@dataclasses.dataclass(frozen=True)
class WriteSpec:
    """Parameters of one streaming or bulk write."""

    name: str
    fps: float = 30.0
    codec: str = "rgb"
    gop_frames: Optional[int] = None
    budget_bytes: Optional[int] = None
    t_start: float = 0.0
    # tiled physical layout: split each GOP into (rows, cols)
    # independently-encoded tile objects so ROI reads fetch and decode
    # only the tiles covering their box.  None / (1, 1) = untiled.
    tiles: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"bad logical video name {self.name!r}")
        object.__setattr__(self, "codec", canonical_codec(self.codec))
        if self.tiles is not None:
            try:
                tr, tc = int(self.tiles[0]), int(self.tiles[1])
            except (TypeError, ValueError, IndexError):
                raise ValueError(
                    f"tiles must be a (rows, cols) pair, got {self.tiles!r}"
                ) from None
            if tr < 1 or tc < 1:
                raise ValueError(f"bad tile grid {self.tiles!r}")
            object.__setattr__(
                self, "tiles", None if (tr, tc) == (1, 1) else (tr, tc)
            )
        fps = float(self.fps)
        if not math.isfinite(fps) or fps <= 0:
            raise ValueError(f"non-positive fps {self.fps!r}")
        object.__setattr__(self, "fps", fps)
        if self.gop_frames is not None and int(self.gop_frames) <= 0:
            raise ValueError(f"non-positive gop_frames {self.gop_frames!r}")
        if self.budget_bytes is not None and int(self.budget_bytes) < 0:
            raise ValueError(f"negative budget_bytes {self.budget_bytes!r}")
        if not math.isfinite(float(self.t_start)):
            raise ValueError(f"non-finite t_start {self.t_start!r}")
