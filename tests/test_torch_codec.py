"""The port's TVC codec against the reference's, on the CPU: blobs must
be byte-identical (magic, header JSON, per-frame offsets, entropy-chunk
flag, tier table), and a blob from either package decodes bit-exactly
in the other."""
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from repro import codec as jcodec
from repro.codec import tvc as jtvc
from repro_torch import codec as tcodec
from repro_torch.codec import tvc as ttvc
from repro_torch.obs.registry import default_registry

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)

TIERS = ["tvc-ll", "tvc-hi", "tvc-med", "tvc-lo", "rgb"]


def _clip(seed, t=6, h=24, w=40):
    """A textured, moving clip: smooth gradient plus noise, shifted per
    frame, so residuals cover small and clipped values alike."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h) * 5, np.arange(w) * 3)[..., None]
            + rng.integers(0, 60, (h, w, 3)))
    frames = [np.roll(base, 2 * i, axis=1) + rng.integers(-9, 10, (h, w, 3))
              for i in range(t)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("tier", TIERS)
def test_serialized_blobs_identical(tier):
    clip = _clip(1)
    a = jcodec.serialize_gop(jcodec.encode_gop(clip, tier))
    b = tcodec.serialize_gop(tcodec.encode_gop(clip, tier, device="cpu"))
    assert a == b


@pytest.mark.parametrize("tier", TIERS)
def test_single_frame_gop_identical(tier):
    clip = _clip(2, t=1, h=17, w=13)
    a = jcodec.serialize_gop(jcodec.encode_gop(clip, tier))
    b = tcodec.serialize_gop(tcodec.encode_gop(clip, tier, device="cpu"))
    assert a == b
    assert np.array_equal(
        tcodec.decode_gop(tcodec.deserialize_gop(a), device="cpu"),
        jcodec.decode_gop(jcodec.deserialize_gop(b)))


@pytest.mark.parametrize("tier", TIERS)
def test_cross_decode_both_directions(tier):
    clip = _clip(3, t=5, h=17, w=13)  # odd sizes: misaligned int16 views
    ja = jcodec.serialize_gop(jcodec.encode_gop(clip, tier))
    tb = tcodec.serialize_gop(tcodec.encode_gop(clip, tier, device="cpu"))
    ref_frames = jcodec.decode_gop(jcodec.deserialize_gop(ja))
    assert np.array_equal(
        tcodec.decode_gop(tcodec.deserialize_gop(ja), device="cpu"),
        ref_frames)
    assert np.array_equal(jcodec.decode_gop(jcodec.deserialize_gop(tb)),
                          ref_frames)


def test_header_and_prefix_agree():
    clip = _clip(4, t=8)
    blob = tcodec.serialize_gop(tcodec.encode_gop(clip, "tvc-hi",
                                                  device="cpu"))
    assert tcodec.parse_gop_header(blob) == jcodec.parse_gop_header(blob)
    assert blob[:4] == b"TVC2"
    jenc, tenc = jcodec.deserialize_gop(blob), tcodec.deserialize_gop(blob)
    for hi in (1, 3, 8):
        jp, tp = jcodec.prefix_gop(jenc, hi), tcodec.prefix_gop(tenc, hi)
        assert (tp.payload, tp.offsets, tp.shape) == (
            jp.payload, jp.offsets, jp.shape)
        assert np.array_equal(tcodec.decode_gop(tp, device="cpu"),
                              jcodec.decode_gop(jp))
    rgb = tcodec.encode_gop(clip, "rgb", device="cpu")
    assert tcodec.prefix_gop(rgb, 2).payload == jcodec.prefix_gop(
        jcodec.encode_gop(clip, "rgb"), 2).payload
    with pytest.raises(ValueError):
        tcodec.parse_gop_header(b"NOPE" + blob[4:])


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("src,dst", [("tvc-hi", "tvc-med"),
                                     ("tvc-ll", "tvc-lo")])
def test_fused_transcode_blobs_identical(factor, src, dst):
    """Includes the reference's truncating cast of the pooled I-frame
    (the residual chain starts from the untruncated value)."""
    clip = _clip(5, t=6, h=24, w=40)
    enc = jcodec.encode_gop(clip, src)
    a = jcodec.serialize_gop(jcodec.transcode_gop(enc, dst,
                                                  scale_factor=factor))
    b = tcodec.serialize_gop(tcodec.transcode_gop(
        tcodec.deserialize_gop(jcodec.serialize_gop(enc)), dst,
        scale_factor=factor, device="cpu"))
    assert a == b


@pytest.mark.parametrize("src,dst,factor", [("tvc-hi", "rgb", 2),
                                            ("rgb", "tvc-med", 2),
                                            ("rgb", "tvc-hi", 1)])
def test_unfused_transcode_blobs_identical(src, dst, factor):
    clip = _clip(6, t=4, h=24, w=40)
    enc = jcodec.encode_gop(clip, src)
    a = jcodec.serialize_gop(jcodec.transcode_gop(enc, dst,
                                                  scale_factor=factor))
    b = tcodec.serialize_gop(tcodec.transcode_gop(
        tcodec.encode_gop(clip, src, device="cpu"), dst,
        scale_factor=factor, device="cpu"))
    assert a == b


def test_codec_tables_match_reference():
    assert tcodec.TIERS == {k: tcodec.Tier(v.name, v.q, v.resid_bits,
                                           v.zstd_level)
                            for k, v in jcodec.TIERS.items()}
    assert tcodec.CODEC_ALIASES == jcodec.CODEC_ALIASES
    assert tcodec.HEADER_PROBE_BYTES == jcodec.HEADER_PROBE_BYTES
    assert tcodec.UNCOMPRESSED_BLOCK_BYTES == jcodec.UNCOMPRESSED_BLOCK_BYTES
    for name in ("HEVC", "h264", "lossless", "raw", "tvc-lo"):
        assert tcodec.canonical_codec(name) == jcodec.canonical_codec(name)


def test_cuda_is_the_default_device():
    """Without a card the default device raises instead of running on
    quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    clip = _clip(7, t=2, h=8, w=8)
    with pytest.raises((RuntimeError, AssertionError)):
        tcodec.encode_gop(clip, "tvc-hi")


# ---------------------------------------------------------------------------
# the entropy stage on the host thread pool: same bytes, same errors
# ---------------------------------------------------------------------------
CODED_TIERS = ["tvc-ll", "tvc-hi", "tvc-med", "tvc-lo"]
# each chunk of a 720p frame is above the pool's threshold
BIG = dict(t=4, h=720, w=1280)


@pytest.fixture(scope="module")
def big_clip():
    return _clip(11, **BIG)


@pytest.fixture(params=["machine", "zlib"])
def coder(request, monkeypatch):
    """The machine's coder (zstd where the wheel is installed), and zlib
    (the card's: its Python has no zstandard) in both packages."""
    if request.param == "zlib":
        monkeypatch.setattr(ttvc, "zstandard", None)
        monkeypatch.setattr(jtvc, "zstandard", None)
    return request.param


def _gops(stage, mode):
    return default_registry().value("vss_codec_entropy_gops_total",
                                    {"stage": stage, "mode": mode})


def _inline(monkeypatch):
    """Keep every GOP on the caller's thread: the loop before the pool."""
    monkeypatch.setattr(ttvc, "POOL_MIN_CHUNK_BYTES", 1 << 62)


def test_big_shape_is_above_the_threshold():
    isz = BIG["h"] * BIG["w"] * 3
    assert isz >= ttvc.POOL_MIN_CHUNK_BYTES
    assert 24 * 40 * 3 < ttvc.POOL_MIN_CHUNK_BYTES  # `_clip`'s default


@pytest.mark.parametrize("tier", CODED_TIERS)
def test_pooled_blob_equals_inline_and_reference(tier, coder, big_clip,
                                                 monkeypatch):
    before = _gops("deflate", "pool")
    pooled = tcodec.serialize_gop(tcodec.encode_gop(big_clip, tier,
                                                    device="cpu"))
    assert _gops("deflate", "pool") == before + 1
    assert pooled == jcodec.serialize_gop(jcodec.encode_gop(big_clip, tier))
    with monkeypatch.context() as m:
        _inline(m)
        inline = tcodec.serialize_gop(tcodec.encode_gop(big_clip, tier,
                                                        device="cpu"))
    assert _gops("deflate", "pool") == before + 1
    assert pooled == inline
    assert pooled[:4] == b"TVC2"


@pytest.mark.parametrize("tier", CODED_TIERS)
def test_pooled_inflate_round_trips_with_prefixes(tier, coder, big_clip):
    enc = tcodec.encode_gop(big_clip, tier, device="cpu")
    blob = tcodec.serialize_gop(enc)
    jenc = jcodec.deserialize_gop(blob)
    ref = jcodec.decode_gop(jenc)
    before = _gops("inflate", "pool")
    assert np.array_equal(
        tcodec.decode_gop(tcodec.deserialize_gop(blob), device="cpu"), ref)
    assert _gops("inflate", "pool") == before + 1
    for hi in (2, 3):
        prefix = tcodec.prefix_gop(enc, hi)
        assert np.array_equal(tcodec.decode_gop(prefix, device="cpu"),
                              jcodec.decode_gop(jcodec.prefix_gop(jenc, hi)))
    assert _gops("inflate", "pool") == before + 3
    if tier == "tvc-ll":  # lossless: the prefix is the clip's own frames
        assert np.array_equal(ref, big_clip)


@pytest.mark.parametrize("stage", ["deflate", "inflate"])
def test_pool_engages_by_size_alone(stage, big_clip):
    """A GOP of small frames, or of one chunk, stays inline; a GOP whose
    chunks are large goes to the pool, once a GOP whatever its chunks."""
    cases = [(_clip(12), "inline"), (big_clip[:1], "inline"),
             (big_clip, "pool")]
    for frames, mode in cases:
        enc = None if stage == "deflate" else tcodec.encode_gop(
            frames, "tvc-hi", device="cpu")
        pool, inline = _gops(stage, "pool"), _gops(stage, "inline")
        if enc is None:
            tcodec.encode_gop(frames, "tvc-hi", device="cpu")
        else:
            tcodec.decode_gop(enc, device="cpu")
        assert (_gops(stage, "pool") - pool,
                _gops(stage, "inline") - inline) == (
            (1, 0) if mode == "pool" else (0, 1)), (frames.shape, mode)
    assert default_registry().value("vss_codec_entropy_pool_threads") \
        == ttvc._pool_width()


def _corrupt_chunk(blob, i):
    """The blob with chunk ``i``'s stream overwritten (its length and a
    zstd frame's magic kept), so the offsets still hold."""
    _, _, off, start = tcodec.parse_gop_header(blob)
    a, b = start + off[i], start + off[i + 1]
    keep = 4 if blob[a:a + 4] == b"\x28\xb5\x2f\xfd" else 0
    return blob[:a + keep] + b"\xff" * (b - a - keep) + blob[b:]


@pytest.mark.parametrize("chunk", [0, 2])
def test_corrupt_chunk_raises_as_before(chunk, coder, big_clip,
                                        monkeypatch):
    blob = _corrupt_chunk(tcodec.serialize_gop(tcodec.encode_gop(
        big_clip, "tvc-med", device="cpu")), chunk)
    errors = []
    for inline in (False, True):
        with monkeypatch.context() as m:
            if inline:
                _inline(m)
            with pytest.raises(Exception) as exc:
                tcodec.decode_gop(tcodec.deserialize_gop(blob), device="cpu")
            errors.append(exc.type)
    with pytest.raises(Exception) as exc:
        jcodec.decode_gop(jcodec.deserialize_gop(blob))
    errors.append(exc.type)
    assert len(set(errors)) == 1, errors
    coders = (zlib.error,) + ((ttvc.zstandard.ZstdError,)
                              if ttvc.zstandard is not None else ())
    assert issubclass(errors[0], coders)


def test_concurrent_encodes_equal_serial_ones(big_clip):
    """Writers on several threads share the one pool: each gets the
    blobs a serial encode gives, under a short switch interval."""
    clips = [big_clip, big_clip[:, ::-1].copy(), 255 - big_clip]
    serial = [tcodec.serialize_gop(tcodec.encode_gop(c, "tvc-med",
                                                     device="cpu"))
              for c in clips]
    got = {}

    def write(k):
        got[k] = [tcodec.serialize_gop(tcodec.encode_gop(
            c, "tvc-med", device="cpu")) for c in clips]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert [got[k] for k in range(3)] == [serial] * 3
