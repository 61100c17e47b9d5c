"""The benchmark's own copy of the TVC codec's arithmetic and blob format.

A frozen, plain-PyTorch restatement of the tiers in
``src/repro_torch/codec/tvc.py`` and the recon chain in
``src/repro_torch/kernels/ref.py`` (closed-loop DPCM):

    iframe  = frames[0]
    r_t     = frames[t] - recon_{t-1}
    rq_t    = clip(round(r_t / q), lo, hi)
    recon_t = clip(recon_{t-1} + rq_t * q, 0, 255)

and of the TVC2 blob: ``b"TVC2" ++ u32le(len(header)) ++ header ++
payload``, the header ``json.dumps({"codec", "shape", "offsets"})`` and
the payload one compressed stream per frame: the I-frame's uint8
planes, then each residual's planes in the tier's integer type.  The
streams are zstd at level 3 where the ``zstandard`` wheel is installed
and zlib at level 3 where it is not, as the codec chooses; a stream's
first bytes say which.

It imports nothing of the program: the yardstick stays fixed whatever a
later change does to the codec.  Tensors may live on any device; the
quotient is a true division by a same-device tensor, so it rounds as
IEEE division does on the CPU and the card alike.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

try:  # the entropy stage follows the codec: zstd where installed
    import zstandard
except ImportError:  # pragma: no cover - depends on the machine
    zstandard = None

MAGIC_V2 = b"TVC2"
HEADER_BYTES = 8192  # always holds the header of a GOP of 30 frames
LEVEL = 3
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def compress(data: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=LEVEL).compress(data)
    return zlib.compress(data, LEVEL)


def decompress(data: bytes) -> bytes:
    if data[:4] == ZSTD_MAGIC:
        if zstandard is None:
            raise ValueError("a zstd stream, and no zstandard wheel")
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str
    q: float
    resid_bits: int

    @property
    def lo(self) -> int:
        return -(2 ** (self.resid_bits - 1))

    @property
    def hi(self) -> int:
        return 2 ** (self.resid_bits - 1) - 1

    @property
    def np_dtype(self):
        return np.int16 if self.resid_bits == 16 else np.int8


TIERS = {
    "tvc-ll": Tier("tvc-ll", 1.0, 16),
    "tvc-hi": Tier("tvc-hi", 2.0, 8),
    "tvc-med": Tier("tvc-med", 8.0, 8),
    "tvc-lo": Tier("tvc-lo", 24.0, 8),
}
ALIASES = {"lossless": "tvc-ll", "hevc": "tvc-hi", "h264": "tvc-med"}


def tier(name: str) -> Tier:
    return TIERS[ALIASES.get(name, name)]


def encode(frames: torch.Tensor, t: Tier
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, H, W, C) uint8 -> (iframe (C, H, W) uint8, residuals
    (T-1, C, H, W) int16 holding the quantized values, recon (T, H, W, C)
    uint8: what a decoder reproduces)."""
    x = frames.permute(0, 3, 1, 2).to(torch.float32)
    q = torch.tensor(t.q, dtype=torch.float32, device=x.device)
    recon = x[0]
    resid = torch.empty((x.shape[0] - 1, *x.shape[1:]), dtype=torch.int16,
                        device=x.device)
    out = torch.empty_like(x)
    out[0] = recon
    for i in range(1, x.shape[0]):
        rq = torch.clamp(torch.round((x[i] - recon) / q), t.lo, t.hi)
        recon = torch.clamp(recon + rq * q, 0.0, 255.0)
        resid[i - 1] = rq.to(torch.int16)
        out[i] = recon
    return (x[0].to(torch.uint8), resid,
            out.to(torch.uint8).permute(0, 2, 3, 1).contiguous())


def decode(iframe: torch.Tensor, resid: torch.Tensor, t: Tier
           ) -> torch.Tensor:
    """Inverse of `encode`: (T, H, W, C) uint8."""
    recon = iframe.to(torch.float32)
    out = torch.empty((resid.shape[0] + 1, *recon.shape),
                      dtype=torch.float32, device=recon.device)
    out[0] = recon
    for i in range(resid.shape[0]):
        recon = torch.clamp(recon + resid[i].to(torch.float32) * t.q,
                            0.0, 255.0)
        out[i + 1] = recon
    return out.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _chunks(iframe: np.ndarray, resid: np.ndarray) -> List[bytes]:
    return [iframe.tobytes()] + [resid[i].tobytes()
                                 for i in range(resid.shape[0])]


def blob(iframe: torch.Tensor, resid: torch.Tensor, t: Tier,
         shape: Sequence[int], pool: Optional[ThreadPoolExecutor] = None
         ) -> bytes:
    """The serialized TVC2 object of one encoded GOP."""
    raw = _chunks(iframe.cpu().numpy(),
                  resid.cpu().numpy().astype(t.np_dtype))
    mapper = pool.map if pool is not None else map
    parts = list(mapper(compress, raw))
    offsets = [0]
    for p in parts:
        offsets.append(offsets[-1] + len(p))
    header = json.dumps({"codec": t.name, "shape": tuple(shape),
                         "offsets": offsets}).encode()
    return (MAGIC_V2 + len(header).to_bytes(4, "little") + header
            + b"".join(parts))


def parse(data: bytes) -> Tuple[str, Tuple[int, ...], Tuple[int, ...], bytes]:
    """(codec, shape, offsets, payload) of a TVC2 object; raises
    ValueError for anything else."""
    if data[:4] != MAGIC_V2:
        raise ValueError("not a TVC2 object")
    hlen = int.from_bytes(data[4:8], "little")
    head = json.loads(data[8:8 + hlen].decode())
    return (head["codec"], tuple(head["shape"]), tuple(head["offsets"]),
            data[8 + hlen:])


def inflate(codec: str, shape: Sequence[int], offsets: Sequence[int],
            payload: bytes, device: str,
            pool: Optional[ThreadPoolExecutor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stored GOP's I-frame (C, H, W) uint8 and residuals (T-1, C, H, W)
    int16 on ``device``."""
    t_, h, w, c = shape
    tr = tier(codec)
    spans = [payload[offsets[i]:offsets[i + 1]]
             for i in range(len(offsets) - 1)]
    mapper = pool.map if pool is not None else map
    raw = list(mapper(decompress, spans))
    if len(raw) != t_:
        raise ValueError(f"{len(raw)} chunks for {t_} frames")
    iframe = torch.from_numpy(
        np.frombuffer(raw[0], np.uint8).reshape(c, h, w).copy())
    resid = np.stack([np.frombuffer(r, tr.np_dtype).reshape(c, h, w)
                      for r in raw[1:]]) if t_ > 1 else np.zeros(
                          (0, c, h, w), tr.np_dtype)
    return (iframe.to(device),
            torch.from_numpy(resid.astype(np.int16)).to(device))


def decode_payload(codec: str, shape: Sequence[int],
                   offsets: Sequence[int], payload: bytes, device: str,
                   pool: Optional[ThreadPoolExecutor] = None
                   ) -> torch.Tensor:
    """(T, H, W, C) uint8 frames of an encoded GOP's payload."""
    iframe, resid = inflate(codec, shape, offsets, payload, device, pool)
    return decode(iframe, resid, tier(codec))
