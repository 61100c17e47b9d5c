"""TVC — the tensor video codec, on PyTorch and CUDA.

A port of ``repro.codec.tvc``; it writes byte-identical blobs.  VSS ships
its own codec instead of H264/HEVC/NVENC
that preserves every structural property the paper's storage manager
exploits:

  * GOPs are independently decodable (no cross-GOP references),
  * within a GOP, frame 0 is an I-frame (independent frame, set A) and
    frames 1.. are closed-loop-quantized temporal residuals (dependent
    frames Δ−A) — decoding frame t requires the look-back chain, which
    is what the paper's look-back cost c_l models,
  * quality tiers trade bitrate for PSNR (like codec CRF levels),
  * transform+quantize runs on-device (hand-written CUDA kernels); the entropy
    stage (zstd over the quantized residual planes) runs host-side,
    exactly where NVENC's CABAC would sit.

Tiers (residual quantization step q; PSNR is re-encode quality for
uint8 payloads, MSE ≈ q²/12):

  tvc-ll  q=1,  int16 residuals  → lossless               (alias: "lossless")
  tvc-hi  q=2,  int8             → ≈53 dB                 (alias: "hevc")
  tvc-med q=8,  int8             → ≈41 dB (τ boundary)    (alias: "h264")
  tvc-lo  q=24, int8             → ≈31 dB (near-lossless)

The aliases let the paper's experiments ("read H264 as HEVC") be written
verbatim against this store.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

try:  # optional: the entropy stage prefers zstd, falls back to zlib
    import zstandard
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None

from repro_torch.kernels import ops
from repro_torch.obs.registry import default_registry
from repro_torch.obs.trace import span

RGB = "rgb"  # raw uncompressed uint8 frames


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str
    q: float
    resid_bits: int  # 8 or 16
    zstd_level: int

    @property
    def lo(self) -> int:
        return -(2 ** (self.resid_bits - 1))

    @property
    def hi(self) -> int:
        return 2 ** (self.resid_bits - 1) - 1

    @property
    def resid_dtype(self):
        return np.int16 if self.resid_bits == 16 else np.int8


TIERS = {
    "tvc-ll": Tier("tvc-ll", q=1.0, resid_bits=16, zstd_level=3),
    "tvc-hi": Tier("tvc-hi", q=2.0, resid_bits=8, zstd_level=3),
    "tvc-med": Tier("tvc-med", q=8.0, resid_bits=8, zstd_level=3),
    "tvc-lo": Tier("tvc-lo", q=24.0, resid_bits=8, zstd_level=3),
}

CODEC_ALIASES = {
    "lossless": "tvc-ll",
    "hevc": "tvc-hi",
    "h264": "tvc-med",
    "raw": RGB,
}

VMIN, VMAX = 0.0, 255.0  # uint8 payload dynamic range


def canonical_codec(name: str) -> str:
    name = name.lower()
    name = CODEC_ALIASES.get(name, name)
    if name != RGB and name not in TIERS:
        raise ValueError(f"unknown codec {name!r}")
    return name


def is_compressed_codec(name: str) -> bool:
    return canonical_codec(name) != RGB


@dataclasses.dataclass
class EncodedGOP:
    """One independently-decodable unit, ready for (de)serialization."""

    codec: str  # canonical codec name
    shape: Tuple[int, int, int, int]  # (T, H, W, C)
    payload: bytes  # per-frame zstd chunks (TVC, see offsets) / raw (RGB)
    # cumulative payload byte offsets of the T per-frame chunks (unit 0 =
    # the compressed I-frame, unit i = frame i's compressed residual), so
    # offsets[i] .. offsets[i+1] brackets frame i and a payload *prefix*
    # [0, offsets[hi]) decodes frames [0, hi).  None for RGB (offsets are
    # analytic: i*H*W*C) and for legacy single-stream TVC1 payloads.
    offsets: Optional[Tuple[int, ...]] = None

    @property
    def num_frames(self) -> int:
        return self.shape[0]

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    @property
    def pixels(self) -> int:
        t, h, w, c = self.shape
        return t * h * w * c

    @property
    def mbpp(self) -> float:
        """Mean bits per pixel — the paper's compression-error predictor."""
        return 8.0 * self.nbytes / max(self.pixels, 1)


# zstd frames open with a fixed magic; a zlib stream's 2-byte header
# (CMF/FLG) can never alias it because 0x28,0xB5 fails zlib's FCHECK —
# so the payload itself flags which entropy codec produced it and mixed
# environments (written with the wheel, read without, or vice versa)
# round-trip.
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"
# the span of each entropy stage names the coder that ran
_DEFLATE = "vss.codec.deflate." + ("zlib" if zstandard is None else "zstd")


def _zstd(data, level: int) -> bytes:
    """``data``: any C-contiguous buffer."""
    with span(_DEFLATE):
        if zstandard is not None:
            return zstandard.ZstdCompressor(level=level).compress(data)
        return zlib.compress(data, min(max(level, 1), 9))


def _unzstd(data: bytes, size: int) -> bytes:
    """``size``: the raw bytes the stream holds, so zlib allocates its
    output once (and releases the GIL once, which lets pooled chunks
    inflate side by side)."""
    if data[:4] == _ZSTD_FRAME_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "GOP payload is zstd-compressed but the zstandard wheel"
                " is not installed"
            )
        with span("vss.codec.inflate.zstd"):
            return zstandard.ZstdDecompressor().decompress(data)
    with span("vss.codec.inflate.zlib"):
        return zlib.decompress(data, bufsize=size)


# The entropy stage codes a chunked GOP's frames on one process-wide pool
# of host threads (zlib and zstd release the GIL while they code, and the
# chunks are independent streams, so the bytes are the same) once the
# GOP's chunks average at least this many raw bytes.  On an H100 host
# (zlib) a hand-off costs 15 us a chunk in a GOP's burst, 2.3 % of
# inflating 256 KiB of a 4K residual plane and 5.7 % of 128 KiB
# (PERF.md, section 6).  Smaller GOPs (small frames, small tiles)
# stay on the caller's thread.
POOL_MIN_CHUNK_BYTES = 256 << 10

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _pool_width() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        return os.cpu_count() or 1


@functools.lru_cache(maxsize=None)
def _entropy_gops(stage: str, mode: str):
    return default_registry().counter(
        "vss_codec_entropy_gops_total",
        "GOPs whose chunks the codec's entropy stage coded, by direction"
        " and by whether they ran on the host thread pool or inline",
        labels={"stage": stage, "mode": mode})


@functools.lru_cache(maxsize=None)
def _pool_threads_gauge():
    return default_registry().gauge(
        "vss_codec_entropy_pool_threads",
        "threads of the codec's entropy host pool, once it is made")


def _entropy_pool() -> ThreadPoolExecutor:
    """The shared pool, made at first use as wide as the CPUs this
    process may run on.  Its tasks are single coder calls that never
    submit to it, so callers on any number of threads cannot deadlock
    it."""
    global _pool
    with _pool_lock:
        if _pool is None:
            width = _pool_width()
            _pool = ThreadPoolExecutor(
                width, thread_name_prefix="vss-entropy")
            _pool_threads_gauge().set(width)
        return _pool


def _forget_pool_after_fork() -> None:
    # a forked child has the pool object but none of its threads
    global _pool, _pool_lock
    _pool = None
    _pool_lock = threading.Lock()


os.register_at_fork(after_in_child=_forget_pool_after_fork)


def _code_chunks(fn: Callable, jobs: List[tuple], raw_bytes: int,
                 stage: str) -> List[bytes]:
    """``[fn(*job) for job in jobs]``, one job a chunk, in order: on the
    entropy pool when there are two chunks or more and they average at
    least ``POOL_MIN_CHUNK_BYTES`` of the GOP's ``raw_bytes``, else
    inline.  Each pooled call runs in a copy of the caller's context, so
    its span joins the caller's trace tree (a read's decode node); a
    coder's error is raised here as it was raised there."""
    if len(jobs) < 2 or raw_bytes < len(jobs) * POOL_MIN_CHUNK_BYTES:
        _entropy_gops(stage, "inline").inc()
        return [fn(*job) for job in jobs]
    _entropy_gops(stage, "pool").inc()
    pool = _entropy_pool()
    futures = [pool.submit(contextvars.copy_context().run, fn, *job)
               for job in jobs]
    return [f.result() for f in futures]


def _resid_torch_dtype(tier: Tier) -> torch.dtype:
    return torch.int16 if tier.resid_bits == 16 else torch.int8


def encode_gop(
    frames: np.ndarray,  # (T, H, W, C) uint8
    codec: str,
    *,
    device: str = "cuda",
) -> EncodedGOP:
    """Encode one GOP.  ``device`` runs the delta codec: ``"cuda"`` (the
    default) launches the CUDA kernel, ``"cpu"`` its plain version."""
    codec = canonical_codec(codec)
    frames = np.asarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if codec == RGB:
        with span("vss.codec.rgb_pack"):
            return EncodedGOP(RGB, (t, h, w, c), frames.tobytes())
    tier = TIERS[codec]
    if t == 1:
        iframe_u8 = np.ascontiguousarray(np.moveaxis(frames[0], -1, 0))
        resid = np.zeros((0, c, h, w), tier.resid_dtype)
    else:
        # upload uint8, widen on the device: 4x fewer bytes over the bus
        with span("vss.codec.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        ifr, res = ops.delta_encode(
            ops.to_planar(x), q=tier.q, lo=tier.lo, hi=tier.hi,
            vmin=VMIN, vmax=VMAX, resid_dtype=_resid_torch_dtype(tier),
        )
        # the host waits here for the kernel too
        with span("vss.codec.d2h"):
            iframe_u8 = ifr.cpu().numpy().astype(np.uint8)
            resid = res.cpu().numpy()
    # one independently-compressed chunk per frame (I-frame, then each
    # residual): a payload prefix [0, offsets[hi]) decodes frames
    # [0, hi) without touching — or even fetching — the rest
    return _chunked_gop(codec, (t, h, w, c), iframe_u8, resid, tier)


def _chunked_gop(
    codec: str,
    shape: Tuple[int, int, int, int],
    iframe_u8: np.ndarray,
    resid: np.ndarray,
    tier: Tier,
) -> EncodedGOP:
    planes = [np.ascontiguousarray(iframe_u8)]
    planes.extend(np.ascontiguousarray(r) for r in resid)
    chunks = _code_chunks(_zstd, [(p, tier.zstd_level) for p in planes],
                          iframe_u8.nbytes + resid.nbytes, "deflate")
    offsets = [0]
    for ch in chunks:
        offsets.append(offsets[-1] + len(ch))
    return EncodedGOP(codec, shape, b"".join(chunks), tuple(offsets))


def _raw_payload(enc: EncodedGOP) -> bytearray:
    """Decompressed ``iframe_u8 ++ residuals`` bytes for a TVC GOP,
    whatever its payload format (chunked v2 or legacy single-stream).
    A bytearray, so tensors can view it without a copy."""
    t, h, w, c = enc.shape
    isz = h * w * c
    rsz = isz * TIERS[enc.codec].resid_bits // 8
    raw_bytes = isz + (t - 1) * rsz
    if enc.offsets is not None:
        off = enc.offsets
        jobs = [(enc.payload[off[i]:off[i + 1]], isz if i == 0 else rsz)
                for i in range(len(off) - 1)]
    else:
        jobs = [(enc.payload, raw_bytes)]
    return bytearray().join(_code_chunks(_unzstd, jobs, raw_bytes,
                                         "inflate"))


def _planes(enc: EncodedGOP, tier: Tier, device: str):
    """The GOP's I-frame (C,H,W) f32 and residuals (T-1,C,H,W) in the
    tier's integer type, on ``device``."""
    t, h, w, c = enc.shape
    raw = _raw_payload(enc)
    isz = h * w * c
    iframe = torch.frombuffer(raw, dtype=torch.uint8, count=isz)
    resid = torch.frombuffer(
        raw, dtype=_resid_torch_dtype(tier), offset=isz,
        count=(t - 1) * isz,
    ) if t > 1 else torch.zeros(0, dtype=_resid_torch_dtype(tier))
    with span("vss.codec.h2d"):
        iframe = iframe.to(device).reshape(c, h, w).to(torch.float32)
        resid = resid.to(device).reshape(t - 1, c, h, w)
    return iframe, resid


def prefix_gop(enc: EncodedGOP, hi: int) -> EncodedGOP:
    """The sub-GOP holding frames [0, hi) of ``enc``, sliced without any
    decode work.  Requires a random-access payload (RGB, or a chunked
    TVC payload with offsets); raises ValueError otherwise."""
    t, h, w, c = enc.shape
    if not 0 < hi <= t:
        raise ValueError(f"prefix [0,{hi}) outside GOP of {t} frames")
    if hi == t:
        return enc
    if enc.codec == RGB:
        return EncodedGOP(RGB, (hi, h, w, c), enc.payload[: hi * h * w * c])
    if enc.offsets is None:
        raise ValueError("legacy single-stream payload has no offsets")
    return EncodedGOP(enc.codec, (hi, h, w, c),
                      enc.payload[: enc.offsets[hi]], enc.offsets[: hi + 1])


def _to_uint8_frames(planar: torch.Tensor) -> np.ndarray:
    """(T, C, H, W) f32 -> host (T, H, W, C) uint8, rounded and clipped
    on the device so only bytes cross the bus."""
    out = torch.clamp(torch.round(ops.from_planar(planar)), 0, 255)
    out = out.to(torch.uint8).contiguous()
    with span("vss.codec.d2h"):
        return out.cpu().numpy()


def decode_gop(
    enc: EncodedGOP,
    *,
    device: str = "cuda",
) -> np.ndarray:
    """Returns (T, H, W, C) uint8 frames.  ``device`` runs the recon
    chain: ``"cuda"`` (the default) launches the CUDA kernel, ``"cpu"``
    its plain version."""
    t, h, w, c = enc.shape
    if enc.codec == RGB:
        with span("vss.codec.rgb_unpack"):
            return np.frombuffer(enc.payload, np.uint8).reshape(
                t, h, w, c).copy()
    tier = TIERS[enc.codec]
    iframe, resid = _planes(enc, tier, device)
    if t == 1:
        planar = iframe[None]
    else:
        # the kernel reads the tier's int8/int16 residuals directly; the
        # reference widens them to int32 first, with equal values
        planar = ops.delta_decode(iframe, resid, q=tier.q, vmin=VMIN,
                                  vmax=VMAX)
    return _to_uint8_frames(planar)


def transcode_gop(
    enc: EncodedGOP,
    codec: str,
    *,
    scale_factor: int = 1,
    device: str = "cuda",
) -> EncodedGOP:
    """Transcode a GOP to another codec, optionally box-downsampling by
    ``scale_factor``. TVC→TVC with T>1 uses the fused transcode kernel
    (decode→pool→re-encode without materializing frames in device
    memory); every other combination goes decode → (pool) → encode.
    """
    codec = canonical_codec(codec)
    t, h, w, c = enc.shape
    f = scale_factor
    if f > 1 and (h % f or w % f):
        raise ValueError(f"scale factor {f} must divide ({h},{w})")
    fused = (
        enc.codec != RGB
        and codec != RGB
        and t > 1
        and h % f == 0
        and w % f == 0
    )
    if fused:
        tin = TIERS[enc.codec]
        tout = TIERS[codec]
        iframe, resid = _planes(enc, tin, device)
        io, ro = ops.transcode(
            iframe, resid, q_in=tin.q, q_out=tout.q, factor=f,
            lo=tout.lo, hi=tout.hi, vmin=VMIN, vmax=VMAX,
            resid_dtype=_resid_torch_dtype(tout),
        )
        oh, ow = h // f, w // f
        # the pooled I-frame is fractional and is stored truncated, while
        # the residual chain started from the untruncated value — the
        # reference's behaviour, kept so the blobs are identical
        with span("vss.codec.d2h"):
            iframe_out = io.cpu().numpy()
            resid_out = ro.cpu().numpy()
        return _chunked_gop(codec, (t, oh, ow, c),
                            iframe_out.astype(np.uint8), resid_out, tout)
    frames = decode_gop(enc, device=device)
    if f > 1:
        planar = ops.to_planar(torch.from_numpy(frames).to(device))
        # jnp's mean in the reference is lowered to a multiply by the
        # f32 reciprocal of the count; this is the same arithmetic
        small = planar.reshape(t, c, h // f, f, w // f, f).sum(dim=(3, 5))
        frames = _to_uint8_frames(small * (1.0 / (f * f)))
    return encode_gop(frames, codec, device=device)


# --------------------------------------------------------------------------
# byte-level (de)serialization — one GOP per storage object, as in §2
# --------------------------------------------------------------------------
#
# Blob formats (both readable forever):
#   TVC1: magic ++ hlen(u32le) ++ json{"codec","shape"} ++ payload —
#         payload is raw RGB bytes or ONE compressed stream (legacy).
#   TVC2: same framing, header additionally carries "offsets" (the
#         cumulative per-frame chunk offsets, length T+1) and the
#         payload is the concatenation of T independently-compressed
#         chunks — the byte index that makes ranged sub-GOP reads pay
#         only for the frames they decode.
# RGB GOPs keep writing TVC1: their frame offsets are analytic (i*H*W*C
# from the shape), so the header needs no table for random access.

_MAGIC = b"TVC1"
_MAGIC_V2 = b"TVC2"
_MAGICS = (_MAGIC, _MAGIC_V2)

# one storage read of this size always covers magic + header for any
# plausible GOP (a T=600 offset table is < 5 KiB of JSON)
HEADER_PROBE_BYTES = 8192


def serialize_gop(enc: EncodedGOP) -> bytes:
    meta = {"codec": enc.codec, "shape": enc.shape}
    if enc.codec != RGB and enc.offsets is not None:
        meta["offsets"] = list(enc.offsets)
        magic = _MAGIC_V2
    else:
        magic = _MAGIC
    header = json.dumps(meta).encode()
    return magic + len(header).to_bytes(4, "little") + header + enc.payload


def parse_gop_header(data: bytes):
    """Parse the blob header from a *prefix* of a serialized GOP.

    Returns ``(codec, shape, offsets, payload_start)`` — ``offsets`` is
    None for legacy/RGB blobs.  Raises ValueError when ``data`` is not a
    TVC blob or is too short to hold the whole header."""
    if data[:4] not in _MAGICS:
        raise ValueError("not a TVC GOP object")
    if len(data) < 8:
        raise ValueError("truncated TVC header")
    hlen = int.from_bytes(data[4:8], "little")
    if len(data) < 8 + hlen:
        raise ValueError("truncated TVC header")
    header = json.loads(data[8 : 8 + hlen].decode())
    offsets = header.get("offsets")
    return (
        header["codec"],
        tuple(header["shape"]),
        tuple(offsets) if offsets is not None else None,
        8 + hlen,
    )


def deserialize_gop(data: bytes) -> EncodedGOP:
    codec, shape, offsets, start = parse_gop_header(data)
    return EncodedGOP(codec, shape, data[start:], offsets)
