"""Seeded road-camera frames, drawn on the device.

A PyTorch rewrite of the ideas in ``src/repro_torch/data/video.py``
(``synthesize_road``), sized for full-resolution frames: a textured
panorama (smoothed noise, buildings with lit window grids, a road with
lane marks), coloured cars driving both ways, and cameras that pan
slowly across it.  The pan moves every textured pixel by a quarter of a
pixel each frame (at 1080p) and a little sensor noise is added, so the
codec's residuals are neither zero (a still image) nor noise: the clip
compresses like camera video (about 0.09 of the raw bytes in the h264
tier).  Two cameras see the panorama with a
horizontal overlap, as Visual Road's camera pairs do.

Everything is drawn by one ``torch.Generator`` on the frames' device,
in a few large calls; the same seed gives the same frames.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

CAR_COLOURS = ((220, 40, 40), (40, 60, 220), (40, 200, 60),
               (235, 235, 235), (230, 210, 40))
SEED_MASK = (1 << 63) - 1


@dataclasses.dataclass
class Scene:
    """A panorama and its cars; cameras crop views out of it."""

    world: torch.Tensor  # (3, H, Wp) float32
    cars: torch.Tensor  # (n, 7): row, h, w, x0, speed, colour index, _
    width: int  # camera width
    pan_px: float  # pan amplitude, pixels
    pan_period: int  # frames for one sweep and back
    noise: float  # sensor noise, standard deviation in grey levels
    generator: torch.Generator


def _smooth(x: torch.Tensor, k: int, passes: int) -> torch.Tensor:
    k |= 1  # odd, so the padded pool keeps the size
    for _ in range(passes):
        x = F.avg_pool2d(x, (k, 1), stride=1, padding=(k // 2, 0),
                         count_include_pad=False)
        x = F.avg_pool2d(x, (1, k), stride=1, padding=(0, k // 2),
                         count_include_pad=False)
    return x


def make_scene(height: int, width: int, *, cameras: int, overlap: float,
               seed: int, device: str, noise_seed: Optional[int] = None
               ) -> Scene:
    """The panorama and cars from ``seed``; the sensor noise from the same
    generator, or from ``noise_seed`` where given (a fixed scene whose
    noise alone changes with the run's seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    u = max(1, height // 108)  # the original's sizes were for 108 rows
    offset = int(round(width * (1.0 - overlap)))
    pan_px = 3.0 * u  # a quarter of a pixel a frame at 1080p
    pan_w = width + offset * (cameras - 1) + int(pan_px) + 2
    base = torch.rand((1, 1, height, pan_w), generator=gen, device=device)
    base = _smooth(base, 9 * u, 3)[0, 0]
    base = (base - base.min()) / (base.max() - base.min()).clamp_min(1e-6)
    fine = _smooth(torch.rand((1, 1, height, pan_w), generator=gen,
                              device=device), 3, 1)[0, 0]
    sky = torch.linspace(1.0, 0.45, height, device=device)[:, None]
    world = torch.stack([90 + 110 * base * sky, 100 + 100 * base * sky,
                         120 + 90 * sky + 20 * base]) + 24 * (fine - 0.5)
    ys = torch.arange(height, device=device)[:, None]
    xs = torch.arange(pan_w, device=device)[None, :]
    n_build = max(4, pan_w // (120 * u))
    r = torch.rand((n_build, 5), generator=gen, device=device).tolist()
    for bw_r, bh_r, bx_r, shade_r, lit_r in r:
        bw = int((30 + 50 * bw_r) * u)
        bh = int(height / 4 + bh_r * height / 4)
        bx = int(bx_r * max(pan_w - bw, 1))
        by = height // 2 - bh
        inside = (ys >= by) & (ys < by + bh) & (xs >= bx) & (xs < bx + bw)
        lit = (inside & (ys >= by + 4 * u) & (ys < by + bh - 4 * u)
               & (xs >= bx + 4 * u) & (xs < bx + bw - 4 * u)
               & ((ys - by - 4 * u) % (10 * u) < 5 * u)
               & ((xs - bx - 4 * u) % (10 * u) < 5 * u))
        world = torch.where(inside, 30 + 60 * shade_r, world)
        world = torch.where(lit, 200 + 40 * lit_r, world)
    road_top = int(height * 0.62)
    mid = (road_top + height) // 2
    road = ys >= road_top
    marks = (ys >= mid - 2 * u) & (ys < mid) & (xs % (40 * u) < 20 * u)
    world = torch.where(road, 70 + 12 * (fine - 0.5), world)
    world = torch.where(marks, 220.0, world)
    n_cars = 6 * max(1, width // 192)
    cr = torch.rand((n_cars, 4), generator=gen, device=device)
    cars = torch.stack([
        road_top + 4 * u + cr[:, 0] * (height - road_top - 20 * u),
        torch.full((n_cars,), 12.0 * u, device=device),
        torch.full((n_cars,), 24.0 * u, device=device),
        cr[:, 1] * pan_w,
        (1.0 + 3.0 * cr[:, 2]) * u * torch.where(
            torch.arange(n_cars, device=device) % 2 == 1, 1.0, -1.0),
        torch.floor(cr[:, 3] * len(CAR_COLOURS)),
        torch.zeros(n_cars, device=device),
    ], dim=1)
    if noise_seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(noise_seed & SEED_MASK)
    return Scene(world.clamp(0, 255), cars, width, pan_px, 240, 1.0, gen)


def camera_offset(scene: Scene, camera: int, overlap: float) -> float:
    return camera * round(scene.width * (1.0 - overlap))


def render(scene: Scene, t0: int, count: int, *, camera: int = 0,
           overlap: float = 0.3) -> torch.Tensor:
    """Frames [t0, t0 + count) of one camera: (count, H, W, 3) uint8 on
    the scene's device."""
    world = scene.world
    dev = world.device
    _, height, pan_w = world.shape
    w = scene.width
    t = torch.arange(t0, t0 + count, device=dev, dtype=torch.float32)
    phase = torch.remainder(t, scene.pan_period) / scene.pan_period
    pan = scene.pan_px * (1.0 - torch.abs(2.0 * phase - 1.0))
    left = camera_offset(scene, camera, overlap) + pan  # (count,)
    x = left[:, None] + torch.arange(w, device=dev)[None, :]  # (count, W)
    x0 = torch.floor(x).long().clamp(0, pan_w - 2)
    a = (x - x0).clamp(0, 1)[:, None, None, :]  # (count, 1, 1, W)
    rows = world[None]  # (1, 3, H, Wp)
    idx0 = x0[:, None, None, :].expand(count, 3, height, w)
    g0 = torch.gather(rows.expand(count, -1, -1, -1), 3, idx0)
    g1 = torch.gather(rows.expand(count, -1, -1, -1), 3, idx0 + 1)
    frames = g0 * (1 - a) + g1 * a  # (count, 3, H, W)
    ys = torch.arange(height, device=dev)
    colours = torch.tensor(CAR_COLOURS, dtype=torch.float32, device=dev)
    for row, ch, cw, cx0, speed, colour, _ in scene.cars.tolist():
        cx = torch.remainder(cx0 + speed * t, pan_w) - left  # (count,)
        cols = torch.arange(w, device=dev)[None, :]
        in_x = (cols >= cx[:, None]) & (cols < cx[:, None] + cw)
        in_y = (ys >= int(row)) & (ys < int(row) + int(ch))
        mask = in_y[None, :, None] & in_x[:, None, :]  # (count, H, W)
        frames = torch.where(mask[:, None], colours[int(colour)][
            None, :, None, None], frames)
    noise = torch.randn(frames.shape, generator=scene.generator,
                        device=dev) * scene.noise
    out = torch.clamp(torch.round(frames + noise), 0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()
