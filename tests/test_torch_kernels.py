"""The port's kernels on the CPU: their plain PyTorch versions against the
JAX reference (``repro.kernels.ref``, and the Pallas kernels in interpret
mode), and the wrappers' dispatch by device.  Inputs are made with numpy
from a seed and handed to both packages.  Every comparison is exact:
the codec's values are integers or multiples of 1/16, which f32 holds
exactly, and rounding is half to even on both sides.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds each against its plain version there."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import delta_codec, transcode

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)

TIERS = [(1.0, -32768, 32767), (2.0, -128, 127), (8.0, -128, 127),
         (24.0, -128, 127)]
SHAPES = [(2, 8, 128), (6, 24, 200), (3, 17, 130), (5, 64, 256)]


def _t(a):
    """A torch copy of a (read-only) JAX result."""
    return torch.from_numpy(np.array(a))


def _frames(seed, t, c, h, w):
    return np.random.default_rng(seed).integers(
        0, 256, (t, c, h, w)).astype(np.float32)


@pytest.mark.parametrize("t,h,w", SHAPES)
@pytest.mark.parametrize("q,lo,hi", TIERS)
def test_delta_codec_plain_matches_reference(t, h, w, q, lo, hi):
    x = _frames(t * h + w, t, 3, h, w)
    ir, rr = jref.delta_encode(jnp.asarray(x), q=q, lo=lo, hi=hi,
                               vmin=0, vmax=255)
    it, rt = ref.delta_encode(torch.from_numpy(x), q=q, lo=lo, hi=hi,
                              vmin=0, vmax=255)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rr))
    dr = jref.delta_decode(ir, rr, q=q, vmin=0, vmax=255)
    dt = ref.delta_decode(it, rt, q=q, vmin=0, vmax=255)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dr))


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("q_in,q_out", [(2.0, 8.0), (8.0, 2.0), (1.0, 24.0)])
def test_transcode_plain_matches_reference(factor, q_in, q_out):
    x = _frames(factor, 4, 3, 32, 256)
    lo_in = -32768 if q_in == 1.0 else -128
    hi_in = 32767 if q_in == 1.0 else 127
    ifr, res = jref.delta_encode(jnp.asarray(x), q=q_in, lo=lo_in, hi=hi_in,
                                 vmin=0, vmax=255)
    io_r, ro_r = jref.transcode(
        ifr, res, q_in=q_in, q_out=q_out, factor=factor, lo=-128, hi=127,
        vmin=0, vmax=255)
    io_t, ro_t = ref.transcode(
        _t(ifr), _t(res), q_in=q_in, q_out=q_out, factor=factor, lo=-128, hi=127,
        vmin=0, vmax=255)
    np.testing.assert_array_equal(io_t.numpy(), np.asarray(io_r))
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_r))


@pytest.mark.parametrize("factor", [3, 12])
def test_transcode_plain_matches_reference_odd_and_large_factor(factor):
    """Factors that are not powers of two (the pooled values leave the
    1/16 grid) and past the CUDA kernel's register-resident ones."""
    x = _frames(factor, 4, 3, 36, 48)
    ifr, res = jref.delta_encode(jnp.asarray(x), q=2.0, lo=-128, hi=127,
                                 vmin=0, vmax=255)
    kw = dict(q_in=2.0, q_out=24.0, factor=factor, lo=-128, hi=127, vmin=0,
              vmax=255)
    io_r, ro_r = jref.transcode(ifr, res, **kw)
    io_t, ro_t = ops.transcode(_t(ifr), _t(res), resid_dtype=torch.int8, **kw)
    np.testing.assert_array_equal(io_t.numpy(), np.asarray(io_r))
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_r))


def test_box_downsample_matches_reference():
    x = np.random.default_rng(3).integers(0, 256, (2, 3, 12, 18)).astype(
        np.float32)
    for f in (1, 2, 3, 6):
        np.testing.assert_array_equal(
            ref.box_downsample(torch.from_numpy(x), f).numpy(),
            np.asarray(jref.box_downsample(jnp.asarray(x), f)))


# -- one case per kernel against the Pallas kernel (interpret mode) ------

def test_delta_encode_matches_pallas_interpret():
    x = _frames(11, 2, 3, 8, 128)
    ip, rp = jops.delta_encode(jnp.asarray(x), q=2.0, lo=-128, hi=127,
                               vmin=0, vmax=255, use_pallas=True)
    it, rt = ops.delta_encode(torch.from_numpy(x), q=2.0, lo=-128, hi=127,
                              vmin=0, vmax=255, resid_dtype=torch.int8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rp))


def test_delta_decode_matches_pallas_interpret():
    x = _frames(12, 2, 3, 8, 128)
    ifr, res = jref.delta_encode(jnp.asarray(x), q=8.0, lo=-128, hi=127,
                                 vmin=0, vmax=255)
    dp = jops.delta_decode(ifr, res, q=8.0, vmin=0, vmax=255,
                           use_pallas=True)
    dt = ops.delta_decode(_t(ifr), _t(res), q=8.0, vmin=0, vmax=255)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dp))


def test_transcode_matches_pallas_interpret():
    x = _frames(13, 3, 3, 16, 256)
    ifr, res = jref.delta_encode(jnp.asarray(x), q=2.0, lo=-128, hi=127,
                                 vmin=0, vmax=255)
    io_p, ro_p = jops.transcode(ifr, res, q_in=2.0, q_out=8.0, factor=2,
                                lo=-128, hi=127, vmin=0, vmax=255,
                                use_pallas=True)
    io_t, ro_t = ops.transcode(
        _t(ifr), _t(res), q_in=2.0, q_out=8.0, factor=2, lo=-128, hi=127,
        vmin=0, vmax=255, resid_dtype=torch.int8)
    np.testing.assert_array_equal(io_t.numpy(), np.asarray(io_p))
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_p))


# -- what the CUDA kernels rely on ---------------------------------------

@pytest.mark.parametrize("q", [1.0, 2.0, 8.0, 24.0])
def test_reciprocal_quotient_rounds_like_division(q):
    """The Pallas kernels quantize with r * f32(1/q), the plain versions
    with r / q.  Over every residual on the 1/16 grid in [-255, 255] —
    what the codec forms at transcode factors up to 4 — both round to the
    same integer."""
    r = (np.arange(-255 * 16, 255 * 16 + 1) / 16).astype(np.float32)
    inv = np.float32(delta_codec.inv(q))
    assert inv == np.float32(1.0) / np.float32(q)
    np.testing.assert_array_equal(np.round(r * inv),
                                  np.round(r / np.float32(q)))


def test_reciprocal_quotient_leaves_the_grid():
    """Off that grid the two quotients can part: at q = 24 the residual
    228 - 2**-16 rounds to 10 through the reciprocal and to 9 through the
    division.  The fused transcode pools into such values at factors that
    are not powers of two, so the CUDA kernels correct the product to the
    IEEE quotient (``csrc/tvc_math.cuh``; ``chip_smoke.py`` checks every
    f32 residual on the card)."""
    r = np.float32(228) - np.float32(2.0 ** -16)
    inv = np.float32(delta_codec.inv(24.0))
    assert np.round(r * inv) == 10 and np.round(r / np.float32(24)) == 9


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_wrappers_on_cpu_run_plain_version_in_tier_dtype(dtype):
    x = torch.from_numpy(_frames(21, 3, 3, 9, 14))
    lo, hi = (-128, 127) if dtype == torch.int8 else (-32768, 32767)
    if dtype not in delta_codec.RESID_DTYPES:
        # no tier stores int32 residuals, so no device takes them
        with pytest.raises(TypeError, match="residual dtype"):
            ops.delta_encode(x, q=2.0, lo=lo, hi=hi, vmin=0, vmax=255,
                             resid_dtype=dtype)
        with pytest.raises(TypeError, match="residual dtype"):
            ops.transcode(x[0], x[1:].to(torch.int16), q_in=2.0, q_out=8.0,
                          factor=1, lo=-128, hi=127, vmin=0, vmax=255,
                          resid_dtype=dtype)
        return
    before = _build.launch_counts()
    it, rt = ops.delta_encode(x, q=2.0, lo=lo, hi=hi, vmin=0, vmax=255,
                              resid_dtype=dtype)
    ip, rp = ref.delta_encode(x, q=2.0, lo=lo, hi=hi, vmin=0, vmax=255)
    assert rt.dtype == dtype
    assert torch.equal(it, ip) and torch.equal(rt.to(torch.int32), rp)
    assert torch.equal(ops.delta_decode(it, rt, q=2.0, vmin=0, vmax=255),
                       ref.delta_decode(ip, rp, q=2.0, vmin=0, vmax=255))
    io, ro = ops.transcode(it, rt, q_in=2.0, q_out=8.0, factor=1, lo=-128,
                           hi=127, vmin=0, vmax=255, resid_dtype=torch.int8)
    assert ro.dtype == torch.int8 and io.shape == (3, 9, 14)
    # the plain path launches nothing, so it counts nothing
    assert _build.launch_counts() == before


def test_wrappers_raise_off_cpu_and_cuda():
    """A device with neither a kernel nor a plain path raises; nothing
    quietly moves the work to the CPU."""
    x = torch.empty((2, 3, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        delta_codec.delta_encode(x, q=2.0, lo=-128, hi=127, vmin=0, vmax=255,
                                 resid_dtype=torch.int8)
    with pytest.raises(ValueError, match="device"):
        delta_codec.delta_decode(x[0], x[1:].to(torch.int8), q=2.0, vmin=0,
                                 vmax=255)
    with pytest.raises(ValueError, match="device"):
        transcode.transcode(x[0], x[1:].to(torch.int8), q_in=2.0, q_out=8.0,
                            factor=2, lo=-128, hi=127, vmin=0, vmax=255,
                            resid_dtype=torch.int8)


def test_transcode_rejects_factor_not_dividing_shape():
    x = torch.zeros((3, 10, 12))
    with pytest.raises(ValueError, match="divide"):
        ops.transcode(x, torch.zeros((1, 3, 10, 12), dtype=torch.int8),
                      q_in=2.0, q_out=8.0, factor=4, lo=-128, hi=127,
                      vmin=0, vmax=255, resid_dtype=torch.int8)


def test_planar_layout_round_trip():
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 7, 9, 3)).astype(np.uint8))
    p = ops.to_planar(x)
    assert p.shape == (3, 3, 7, 9) and p.dtype == torch.float32
    assert p.is_contiguous()
    assert torch.equal(ops.from_planar(p, torch.uint8), x)


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the kernels builds nothing; the build directory is
    under the checkout's ``build/`` and named by a hash of the sources."""
    assert not _build._libs
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert d.parent.parent.name == "build"
    assert len(d.name) == 16
    assert {p.stem for p in _build.CSRC_DIR.glob("*.cu")} == set(_build.SOURCES)
