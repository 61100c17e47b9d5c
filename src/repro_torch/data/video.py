"""Synthetic Visual-Road-like video generation.

The paper evaluates on the Visual Road benchmark (a driving simulation
rendered at 1K/2K/4K with configurable horizontal camera overlap) plus
two real datasets (Robotcar ~stereo overlap, Waymo ~15% overlap). This
module procedurally generates equivalent structure at any scale:

  * a textured panoramic "world" (smoothed noise + high-contrast
    buildings so feature detection has corners to find),
  * moving "cars" (colored rectangles with distinct hues — the §6.4
    application searches for cars by color histogram),
  * N camera views cropped from the panorama with a configurable
    horizontal overlap; the second camera can apply a mild projective
    distortion (ground-truth homography returned for oracle tests) and
    can pan over time (the §5.1.2 dynamic-camera scenarios).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

CAR_COLORS = {
    "red": (220, 40, 40),
    "blue": (40, 60, 220),
    "green": (40, 200, 60),
    "white": (235, 235, 235),
    "yellow": (230, 210, 40),
}


@dataclasses.dataclass
class Car:
    color_name: str
    row: int  # lane top row (panorama coords)
    speed: float  # px / frame
    x0: float  # start column
    w: int = 24
    h: int = 12

    def box_at(self, t: int, pan_w: int) -> Tuple[int, int, int, int]:
        x = int(self.x0 + self.speed * t) % pan_w
        return x, self.row, x + self.w, self.row + self.h


def _smooth_noise(rng, h, w, passes=3, k=9) -> np.ndarray:
    x = rng.random((h, w), dtype=np.float32)
    for _ in range(passes):
        c = np.cumsum(x, axis=0)
        x = (np.vstack([c[k:], np.tile(c[-1], (k, 1))]) - c) / k
        c = np.cumsum(x, axis=1)
        x = (np.hstack([c[:, k:], np.tile(c[:, -1:], (1, k))]) - c) / k
    x -= x.min()
    x /= max(x.max(), 1e-6)
    return x


def make_world(
    rng: np.random.Generator, height: int, pan_width: int
) -> np.ndarray:
    """Static panorama background (H, Wp, 3) uint8."""
    base = _smooth_noise(rng, height, pan_width)
    sky = np.linspace(1.0, 0.45, height, dtype=np.float32)[:, None]
    img = np.stack(
        [
            90 + 110 * base * sky,
            100 + 100 * base * sky,
            120 + 90 * sky + 20 * base,
        ],
        axis=-1,
    )
    # "buildings": high-contrast rectangles with window grids (corners!)
    n_buildings = max(4, pan_width // 120)
    for _ in range(n_buildings):
        bw = int(rng.integers(30, 80))
        bh = int(rng.integers(height // 4, height // 2))
        bx = int(rng.integers(0, max(pan_width - bw, 1)))
        by = height // 2 - bh
        shade = float(rng.uniform(30, 90))
        img[by : by + bh, bx : bx + bw] = shade
        for wy in range(by + 4, by + bh - 4, 10):
            for wx in range(bx + 4, bx + bw - 4, 10):
                img[wy : wy + 5, wx : wx + 5] = 200 + 40 * rng.random()
    # road band
    road_top = int(height * 0.62)
    img[road_top:] = 70
    for lx in range(0, pan_width, 40):
        img[(road_top + height) // 2 - 2 : (road_top + height) // 2,
            lx : lx + 20] = 220
    return np.clip(img, 0, 255).astype(np.uint8)


def make_cars(
    rng: np.random.Generator, height: int, pan_width: int, n_cars: int
) -> List[Car]:
    names = list(CAR_COLORS)
    road_top = int(height * 0.62)
    cars = []
    for i in range(n_cars):
        cars.append(
            Car(
                color_name=names[int(rng.integers(0, len(names)))],
                row=int(rng.integers(road_top + 4, height - 20)),
                speed=float(rng.uniform(1.0, 4.0)) * (1 if i % 2 else -1),
                x0=float(rng.uniform(0, pan_width)),
            )
        )
    return cars


def render_panorama(
    world: np.ndarray, cars: List[Car], t: int
) -> np.ndarray:
    frame = world.copy()
    h, pan_w, _ = world.shape
    for car in cars:
        x0, y0, x1, y1 = car.box_at(t, pan_w)
        x1 = min(x1, pan_w)
        y1 = min(y1, h)
        frame[y0:y1, x0:x1] = CAR_COLORS[car.color_name]
    return frame


def _perspective_h(height: int, width: int, strength: float) -> np.ndarray:
    """Mild projective transform (bulges one side, as in Figure 6)."""
    return np.array(
        [
            [1.0 + 0.02 * strength, 0.01 * strength, 0.0],
            [0.015 * strength, 1.0 + 0.01 * strength, -0.5 * strength],
            [strength * 2e-5, strength * 1e-5, 1.0],
        ],
        dtype=np.float32,
    )


def _sample_view(
    pano: np.ndarray, hmat: np.ndarray, width: int, height: int
) -> np.ndarray:
    """view[y, x] = pano(hmat @ [x, y, 1]) with bilinear sampling."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size, np.float32)])
    src = hmat.astype(np.float32) @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    h, w, _ = pano.shape
    x0 = np.clip(np.floor(sx).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(np.int32), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)[:, None]
    fy = np.clip(sy - y0, 0, 1)[:, None]
    p = pano.astype(np.float32)
    out = (
        p[y0, x0] * (1 - fy) * (1 - fx)
        + p[y0, x0 + 1] * (1 - fy) * fx
        + p[y0 + 1, x0] * fy * (1 - fx)
        + p[y0 + 1, x0 + 1] * fy * fx
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8).reshape(
        height, width, 3
    )


def synthesize_road(
    num_frames: int,
    width: int = 192,
    height: int = 108,
    *,
    n_cars: int = 6,
    seed: int = 0,
) -> np.ndarray:
    """Single-camera clip (T, H, W, 3) uint8."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, height, width)
    cars = make_cars(rng, height, width, n_cars)
    return np.stack(
        [render_panorama(world, cars, t) for t in range(num_frames)]
    )


def synthesize_overlapping_pair(
    num_frames: int,
    width: int = 192,
    height: int = 108,
    *,
    overlap: float = 0.5,
    n_cars: int = 6,
    seed: int = 0,
    projective_strength: float = 1.0,
    pan_speed: float = 0.0,  # right-camera pan in px/frame (§5.1.2 dynamic)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two overlapping camera views + ground-truth homography.

    Returns (left (T,H,W,3), right (T,H,W,3), H_rl (3,3)) where H_rl maps
    right-view pixel coordinates into left-view coordinates at t=0:
    ``left(H_rl @ x) == right(x)`` inside the overlap region.
    """
    rng = np.random.default_rng(seed)
    offset = width * (1.0 - overlap)
    pan_width = int(np.ceil(offset + width * 1.3)) + 8
    world = make_world(rng, height, pan_width)
    cars = make_cars(rng, height, pan_width, n_cars)

    hp = _perspective_h(height, width, projective_strength)
    lefts, rights = [], []
    for t in range(num_frames):
        pano = render_panorama(world, cars, t)
        lefts.append(pano[:, :width].copy())
        shift = np.array(
            [[1, 0, offset + pan_speed * t], [0, 1, 0], [0, 0, 1]],
            dtype=np.float32,
        )
        rights.append(_sample_view(pano, shift @ hp, width, height))
    # right pixel x → pano coords (shift @ hp) @ x; pano coords == left
    # coords for columns < width, so H_rl = shift @ hp (at t = 0)
    shift0 = np.array(
        [[1, 0, offset], [0, 1, 0], [0, 0, 1]], dtype=np.float32
    )
    h_rl = (shift0 @ hp).astype(np.float32)
    h_rl /= h_rl[2, 2]
    return np.stack(lefts), np.stack(rights), h_rl
