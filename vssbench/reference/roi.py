"""What a region read and a tiled write should give, worked out from the
written frames.

The benchmark's own statement of the tiled layout (``VSSWriter._flush_gop``
and ``VSS._load_tiled_frames`` in ``src/repro_torch/core/store.py``):

- a (rows, cols) grid splits a frame of extent E into n near-equal
  half-open bands ``[E * i // n, E * (i + 1) // n)``, in each direction;
- each GOP's tile (r, c) is its own TVC2 object: the tier's encoding of
  that tile's pixels alone (``tvc.encode`` and ``tvc.blob``);
- a read of the box ``(x0, y0, x1, y1)`` (half-open pixels) at its own
  size returns the frames ``[f0, f1)`` of the stored original cut to the
  box.  The codec's residuals are per pixel, so a tile decodes to the
  same pixels as the same place in the whole frame's decode.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch

from vssbench.reference import tvc

Box = Tuple[int, int, int, int]


def bands(extent: int, n: int) -> List[Tuple[int, int]]:
    """The ``n`` half-open bands of ``[0, extent)`` a grid cuts."""
    return [(extent * i // n, extent * (i + 1) // n) for i in range(n)]


def tile_box(height: int, width: int, tiles: Sequence[int], r: int,
             c: int) -> Box:
    """Pixel box ``(x0, y0, x1, y1)`` of tile (r, c)."""
    y0, y1 = bands(height, tiles[0])[r]
    x0, x1 = bands(width, tiles[1])[c]
    return x0, y0, x1, y1


def covering(height: int, width: int, tiles: Sequence[int], box: Box
             ) -> List[Tuple[int, int]]:
    """The tiles (r, c) a box overlaps, row-major."""
    x0, y0, x1, y1 = box
    rows = [r for r, (a, b) in enumerate(bands(height, tiles[0]))
            if a < y1 and b > y0]
    cols = [c for c, (a, b) in enumerate(bands(width, tiles[1]))
            if a < x1 and b > x0]
    return [(r, c) for r in rows for c in cols]


def crop(recon: torch.Tensor, f0: int, f1: int, box: Box) -> torch.Tensor:
    """Frames ``[f0, f1)`` of the stored clip ``recon`` (T, H, W, C)
    uint8, cut to ``box``."""
    x0, y0, x1, y1 = box
    return recon[f0:f1, y0:y1, x0:x1]


def tile_blob(frames: torch.Tensor, t: tvc.Tier, tiles: Sequence[int],
              r: int, c: int,
              pool: Optional[ThreadPoolExecutor] = None) -> bytes:
    """The TVC2 object of tile (r, c) of one GOP's frames (T, H, W, C)
    uint8."""
    _, h, w, _ = frames.shape
    x0, y0, x1, y1 = tile_box(h, w, tiles, r, c)
    part = frames[:, y0:y1, x0:x1].contiguous()
    iframe, resid, _ = tvc.encode(part, t)
    return tvc.blob(iframe, resid, t, part.shape, pool)
