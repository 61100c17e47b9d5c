"""Core data model: logical/physical videos, GOP metadata, read parameters.

Mirrors the paper's §2 organization: a *logical video* is a named
collection of *physical videos* (materialized views); each physical
video is a sequence of independently-decodable GOP objects plus a
temporal index. Reads/writes are parameterized by Temporal (interval,
fps), Spatial (resolution, ROI) and Physical (codec, quality) params.

Coordinate conventions
  * time is float seconds; a physical video at `fps` stores frame k at
    time t0 + k/fps,
  * ROI boxes are (x0, y0, x1, y1) in *original* (m0) pixel coordinates,
    half-open; a physical video's stored resolution is its ROI extent
    times its `scale` (scale 1.0 = original sampling density).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

Box = Tuple[int, int, int, int]  # x0, y0, x1, y1 (original coords, half-open)

DEFAULT_QUALITY_EPS_DB = 40.0  # τ: ≥40dB is considered lossless (paper §3.1)
NEAR_LOSSLESS_DB = 30.0
JOINT_ABORT_DB = 24.0  # §5.1.2 recovery threshold


@dataclasses.dataclass(frozen=True)
class TemporalParams:
    start: float  # seconds, inclusive
    end: float  # seconds, exclusive
    fps: Optional[float] = None  # None = source fps

    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class SpatialParams:
    resolution: Optional[Tuple[int, int]] = None  # (width, height); None = native
    roi: Optional[Box] = None  # None = full frame


@dataclasses.dataclass(frozen=True)
class PhysicalParams:
    codec: str = "rgb"
    quality_eps_db: float = DEFAULT_QUALITY_EPS_DB  # ε quality cutoff (PSNR dB)


@dataclasses.dataclass
class GopMeta:
    gop_id: int
    physical_id: int
    index: int  # position within the physical video
    start_frame: int
    num_frames: int
    nbytes: int
    path: str
    zwrapped: bool = False  # deferred-zstd-wrapped raw GOP (§5.2)
    lru_seq: int = 0
    joint_ref: Optional[int] = None  # joint-compression record id (§5.1)
    # per-tile object sizes (row-major), for GOPs of a tiled physical
    # video; None for the ordinary one-object-per-GOP layout.  The
    # planner prices an ROI read's covering-tile subset from these.
    tile_sizes: Optional[Tuple[int, ...]] = None

    def start_time(self, fps: float, t0: float) -> float:
        return t0 + self.start_frame / fps

    def end_time(self, fps: float, t0: float) -> float:
        return t0 + (self.start_frame + self.num_frames) / fps


@dataclasses.dataclass
class PhysicalMeta:
    physical_id: int
    logical: str
    width: int
    height: int
    fps: float
    codec: str
    roi: Box  # in original coordinates
    t_start: float
    t_end: float
    mse_bound: float  # accumulated MSE bound vs m0 (§3.2 transitive bound)
    parent_is_original: bool
    is_original: bool
    created: float
    # physical layout: each GOP is split into tiles_r x tiles_c
    # independently-encoded tile objects (<path>/t<r>_<c>), so an ROI
    # read fetches and decodes only the tiles covering its box.
    # (1, 1) = the ordinary one-object-per-GOP layout.
    tiles: Tuple[int, int] = (1, 1)

    @property
    def scale(self) -> float:
        return self.width / max(self.roi[2] - self.roi[0], 1)

    def covers_time(self, start: float, end: float, eps: float = 1e-9) -> bool:
        return self.t_start <= start + eps and self.t_end >= end - eps

    def covers_roi(self, roi: Box) -> bool:
        x0, y0, x1, y1 = self.roi
        qx0, qy0, qx1, qy1 = roi
        return x0 <= qx0 and y0 <= qy0 and x1 >= qx1 and y1 >= qy1

    def frame_at(self, t: float, t0: Optional[float] = None) -> int:
        t0 = self.t_start if t0 is None else t0
        return int(round((t - t0) * self.fps))


@dataclasses.dataclass
class Fragment:
    """A contiguous piece of a physical video considered for a read."""

    physical: PhysicalMeta
    t_start: float
    t_end: float

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    def num_pixels(self) -> int:
        frames = max(1, int(round(self.duration * self.physical.fps)))
        return frames * self.physical.width * self.physical.height


def full_roi(width: int, height: int) -> Box:
    return (0, 0, width, height)


# -- tiled physical layout ---------------------------------------------------
def tile_bounds(extent: int, n: int) -> List[Tuple[int, int]]:
    """Split ``[0, extent)`` into ``n`` near-equal half-open bands —
    the ONE definition of tile geometry, shared by the writer (split),
    the read path (stitch) and the planner (pricing), so the three can
    never disagree about where a tile starts."""
    return [((extent * i) // n, (extent * (i + 1)) // n) for i in range(n)]


def tile_key(path: str, r: int, c: int) -> str:
    """Object key of one tile of a GOP whose catalog path is ``path``."""
    return f"{path}/t{r}_{c}"


def tile_keys(path: str, tiles: Tuple[int, int]) -> List[str]:
    """All of a tiled GOP's object keys, row-major."""
    rr, cc = tiles
    return [tile_key(path, r, c) for r in range(rr) for c in range(cc)]


def tiles_covering(
    tiles: Tuple[int, int], width: int, height: int, box: Box
) -> Tuple[List[int], List[int]]:
    """(row indices, col indices) of the tile grid overlapping the
    local-pixel box ``(x0, y0, x1, y1)`` of a ``width``x``height``
    frame."""
    rr, cc = tiles
    rows = [
        r for r, (y0, y1) in enumerate(tile_bounds(height, rr))
        if y0 < box[3] and y1 > box[1]
    ]
    cols = [
        c for c, (x0, x1) in enumerate(tile_bounds(width, cc))
        if x0 < box[2] and x1 > box[0]
    ]
    return rows, cols


def mse_to_psnr(mse: float, peak: float = 255.0) -> float:
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def psnr_to_mse(psnr_db: float, peak: float = 255.0) -> float:
    if math.isinf(psnr_db):
        return 0.0
    return peak * peak / (10.0 ** (psnr_db / 10.0))


def chain_mse_bound(
    parent_bound: float, step_mse: float, parent_is_original: bool
) -> float:
    """§3.2: MSE(f0,f2) ≤ 2·(MSE(f0,f1) + MSE(f1,f2)).

    When the parent *is* m0 the step error is exact and needs no
    doubling; chains of length ≥2 pay the factor-2 bound.
    """
    if parent_is_original:
        return step_mse
    return 2.0 * (parent_bound + step_mse)
