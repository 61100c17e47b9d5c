"""GOP partitioning (paper §2).

Compressed writes keep their as-ingested GOP size. Uncompressed (RGB)
writes are partitioned into blocks of ≤25 MB (the size of one RGB 4K
frame) or single frames when a frame alone exceeds that threshold —
verbatim from the paper's prototype policy.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

UNCOMPRESSED_BLOCK_BYTES = 25 * 1024 * 1024
DEFAULT_COMPRESSED_GOP_FRAMES = 30  # codecs "typically fix size to 30–300"


def frames_per_uncompressed_gop(frame_shape: Tuple[int, int, int]) -> int:
    h, w, c = frame_shape
    per_frame = h * w * c  # uint8
    return max(1, UNCOMPRESSED_BLOCK_BYTES // per_frame)


def split_into_gops(
    frames: np.ndarray,  # (T, H, W, C) uint8
    codec: str,
    *,
    gop_frames: int | None = None,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yields (start_frame, frames_chunk) per GOP."""
    t = frames.shape[0]
    if gop_frames is None:
        if codec in ("rgb", "raw"):
            gop_frames = frames_per_uncompressed_gop(frames.shape[1:])
        else:
            gop_frames = DEFAULT_COMPRESSED_GOP_FRAMES
    for s in range(0, t, gop_frames):
        yield s, frames[s : s + gop_frames]
