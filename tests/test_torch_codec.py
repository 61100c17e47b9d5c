"""The port's TVC codec against the reference's, on the CPU: blobs must
be byte-identical (magic, header JSON, per-frame offsets, entropy-chunk
flag, tier table), and a blob from either package decodes bit-exactly
in the other."""
import numpy as np
import pytest
import torch

from repro import codec as jcodec
from repro_torch import codec as tcodec

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
