"""The port's kernels on the CPU: their plain PyTorch versions against the
JAX reference (``repro.kernels.ref``, and the Pallas kernels in interpret
mode), and the wrappers' dispatch by device.  Inputs are made with numpy
from a seed and handed to both packages.  Every codec, warp and
histogram comparison is exact: the codec's values are integers or
multiples of 1/16, which f32 holds exactly, and rounding is half to even
on both sides.  Paged attention and the squared-error sums add in
another order than XLA, so they agree within the reference's own
tolerances (atol 1e-4 in f32, rtol 1e-5; ``tests/test_kernels.py``).

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds each against its plain version there."""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import (
    delta_codec,
    histogram,
    mse,
    paged_attention,
    transcode,
    warp,
)

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


def test_wrappers_on_cpu_count_plain_calls_not_launches():
    """Each wrapper's CPU path runs the plain version and counts one
    plain call, the counterpart of the launch a CUDA tensor counts."""
    x = torch.from_numpy(_frames(22, 3, 3, 9, 14))
    hinv = np.eye(3, dtype=np.float32)
    launches = _build.launch_counts()
    _build.reset_plain_counts()
    it, rt = ops.delta_encode(x, q=2.0, lo=-128, hi=127, vmin=0, vmax=255,
                              resid_dtype=torch.int8)
    ops.delta_decode(it, rt, q=2.0, vmin=0, vmax=255)
    ops.transcode(it, rt, q_in=2.0, q_out=8.0, factor=1, lo=-128, hi=127,
                  vmin=0, vmax=255, resid_dtype=torch.int8)
    assert torch.equal(ops.warp(x, hinv), ref.warp(x, torch.from_numpy(hinv)))
    assert torch.equal(ops.warp(x[0].to(torch.uint8), hinv, out_shape=(4, 5)),
                       ref.warp(x[0], torch.from_numpy(hinv), (4, 5)))
    assert torch.equal(ops.histogram(x, bins=8), ref.histogram(x, bins=8))
    assert _build.plain_counts() == {
        "delta_encode": 1, "delta_decode": 1, "transcode": 1, "warp": 2,
        "histogram": 1}
    assert _build.launch_counts() == launches
    _build.reset_plain_counts()
    assert _build.plain_counts() == {}


def test_warp_and_histogram_raise_off_cpu_and_cuda():
    x = torch.empty((2, 3, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        warp.warp(x, np.eye(3, dtype=np.float32))
    with pytest.raises(ValueError, match="device"):
        histogram.histogram(x, bins=16)


def test_warp_and_histogram_reject_bad_shapes():
    x = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="3x3"):
        ops.warp(x, np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError, match="N,C,H,W"):
        ops.warp(x[0], np.eye(3, dtype=np.float32))
    with pytest.raises(ValueError, match="N,C,H,W"):
        ops.histogram(x, bins=16)
    with pytest.raises(ValueError, match="bins"):
        ops.histogram(x[None], bins=0)


def test_warp_takes_a_float64_homography_rounded_to_f32():
    h = np.array([[1.0 + 1e-9, 0.1, 0.3], [0.0, 1.0, 0.2], [0.0, 0.0, 1.0]])
    x = torch.from_numpy(_frames(23, 1, 3, 6, 7))[0]
    assert torch.equal(ops.warp(x, h), ops.warp(x, h.astype(np.float32)))
    assert torch.equal(ops.warp(x, torch.from_numpy(h)),
                       ops.warp(x, h.astype(np.float32)))


def _reference_byte_bins(bins, vmax):
    """The bin ``ref.histogram`` gives each byte value, one plane each."""
    x = torch.arange(256, dtype=torch.uint8).reshape(256, 1, 1, 1)
    counts = ref.histogram(x, bins=bins, vmax=vmax)[:, 0]
    assert torch.equal(counts.sum(1), torch.ones(256, dtype=torch.int32))
    return counts.argmax(1).numpy()


@pytest.mark.parametrize("vmax", [255.0, 127.0])
def test_byte_bins_are_the_references_bins(vmax):
    """The host's byte -> bin table (the kernel's f32 arithmetic), which
    decides where the uint8 kernel may bin by a shift, is the plain
    version's bin for every byte, at every bin count up to 64."""
    for bins in range(1, 65):
        np.testing.assert_array_equal(histogram.byte_bins(bins, vmax),
                                      _reference_byte_bins(bins, vmax),
                                      err_msg=f"bins={bins}")


@pytest.mark.parametrize("vmax", [255.0, 127.0])
def test_byte_shift_only_where_every_byte_agrees(vmax):
    """A shift is passed to the kernel only where ``byte >> shift`` is
    every byte's bin; elsewhere it is -1 and the kernel bins by the f32
    arithmetic."""
    v = np.arange(256)
    for bins in [*range(1, 65), 128, 256]:
        want = _reference_byte_bins(bins, vmax)
        s = histogram.byte_shift(bins, vmax)
        if s >= 0:
            np.testing.assert_array_equal(v >> s, want, err_msg=f"bins={bins}")
        else:
            assert not any(np.array_equal(v >> k, want) for k in range(9))
    if vmax == 255.0:  # the fingerprint's 16 bins take the shift
        assert histogram.byte_shift(16, vmax) == 4
        assert histogram.byte_shift(17, vmax) == -1


def _zeroing_launch(out, nxt):
    """Stands in for the kernel: zeroes the buffer handed on."""
    nxt.zero_()
    return 0


def test_histogram_output_is_the_buffer_the_last_call_zeroed():
    """Each call's output is the buffer handed on by the previous call on
    the same (device, stream), which that call's kernel zeroed; a new
    zeroed buffer is made only for the first call and for one that needs
    more room, and the buffer handed on is sized to the call's request."""
    dev = torch.device("cpu")
    m = histogram.MIN_BUFFER
    try:
        out, err = histogram._launch_zeroed(dev, 7, 100, _zeroing_launch)
        assert err == 0 and out.numel() == m and not out.any()
        nxt = histogram._zeroed[(None, 7)]
        assert nxt is not out and nxt.numel() == m
        out2, _ = histogram._launch_zeroed(dev, 7, 50, _zeroing_launch)
        assert out2 is nxt
        out3, _ = histogram._launch_zeroed(dev, 7, 5 * m, _zeroing_launch)
        assert out3 is not histogram._zeroed[(None, 7)]
        assert out3.numel() == 5 * m and not out3.any()
        assert histogram._zeroed[(None, 7)].numel() == 5 * m
        out4, _ = histogram._launch_zeroed(dev, 7, 48, _zeroing_launch)
        assert out4.numel() == 5 * m  # the larger buffer, handed on once
        assert histogram._zeroed[(None, 7)].numel() == m
        out5, _ = histogram._launch_zeroed(dev, 8, 50, _zeroing_launch)
        assert out5 is not histogram._zeroed[(None, 7)]
    finally:
        histogram._zeroed.pop((None, 7), None)
        histogram._zeroed.pop((None, 8), None)


@pytest.mark.parametrize("fails", ["raises", "returns an error"])
def test_histogram_hands_on_no_buffer_from_a_failed_launch(fails):
    """A launch that raises or returns an error hands on no buffer, so
    the next call's output is zeros, not the failed call's unzeroed
    buffer."""
    dev = torch.device("cpu")

    def bad(out, nxt):
        nxt.fill_(7)  # what an unzeroed buffer may hold
        if fails == "raises":
            raise ZeroDivisionError("building the kernel's arguments")
        return 1

    try:
        histogram._launch_zeroed(dev, 9, 48, _zeroing_launch)
        if fails == "raises":
            with pytest.raises(ZeroDivisionError):
                histogram._launch_zeroed(dev, 9, 48, bad)
        else:
            assert histogram._launch_zeroed(dev, 9, 48, bad)[1] == 1
        assert (None, 9) not in histogram._zeroed
        out, err = histogram._launch_zeroed(dev, 9, 48, _zeroing_launch)
        assert err == 0 and not out.any()
    finally:
        histogram._zeroed.pop((None, 9), None)


def test_histogram_checks_its_arguments_before_taking_a_buffer():
    """The wrapper computes the kernel's scale and shift, which raise for
    a vmax of -1 or one that is not a number, before it takes a buffer."""
    src = inspect.getsource(histogram.histogram)
    assert (src.index("ref.histogram_scale(") < src.index("_launch_zeroed(")
            and src.index("byte_shift(") < src.index("_launch_zeroed("))
    assert "is_current_stream_capturing" in src
    with pytest.raises(ZeroDivisionError):
        ref.histogram_scale(16, -1.0)


WARP_HMATS = {
    "projective": np.array([[0.9, 0.05, 3.0], [-0.04, 1.1, -2.0],
                            [1e-3, -2e-3, 1.0]], np.float32),
    # Z = 1 - x / 64 is 0 at column 64 (X / Z = inf, 0 / 0 on row 0)
    "z crosses 0": np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                             [-2.0 ** -6, 0.0, 1.0]], np.float32),
    # rows past 2^31 / W: y0 * W wraps modulo 2^32 from the second row on
    "y0 * W wraps": np.array([[40.0, 0.0, -2000.0], [0.0, 3e7, 0.0],
                              [0.0, 0.0, 1.0]], np.float32),
}


@pytest.mark.parametrize("which", list(WARP_HMATS))
def test_warp_corner_offsets_wrap_to_the_exact_offset(which):
    """The kernel computes a pixel's first-corner offset y0 * W + x0 in
    32 bits modulo 2^32 (``corner_offset`` in ``csrc/warp.cu``) and adds
    1, W and W + 1 for the other corners.  Wherever a corner lies inside
    the source, that gives the corner's exact offset, for the plain
    version's own (saturated, NaN -> 0) corner indices."""
    h, w, oh, ow = 37, 61, 45, 100
    m = torch.from_numpy(WARP_HMATS[which])
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32),
                            torch.arange(ow, dtype=torch.float32),
                            indexing="ij")
    rows = [ref.fma_f32(m[r, 1], ys, m[r, 0] * xs) + m[r, 2] for r in range(3)]
    x0 = ref.to_int32_saturating(torch.floor(rows[0] / rows[2])).long()
    y0 = ref.to_int32_saturating(torch.floor(rows[1] / rows[2])).long()
    wrapped = ((y0 % 2**32) * w + (x0 % 2**32)) % 2**32
    off = torch.where(wrapped >= 2**31, wrapped - 2**32, wrapped)
    used = 0
    for dy in (0, 1):
        for dx in (0, 1):
            # the corner's int32 index, with the kernel's wrapping "+ 1"
            yc = ((y0 + dy + 2**31) % 2**32) - 2**31
            xc = ((x0 + dx + 2**31) % 2**32) - 2**31
            inside = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
            got = off + dy * w + dx
            assert torch.equal(got[inside], (yc * w + xc)[inside])
            used += int(inside.sum())
    assert used > 0


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
    assert {"warp", "histogram"} <= set(_build.SOURCES)


# -- paged decode attention -----------------------------------------------

# the reference's three shapes (tests/test_kernels.py), then -1 entries,
# lengths on page boundaries and at 1, pages shared between rows
PAGED_SHAPES = [(2, 4, 2, 64, 8, 16), (1, 8, 8, 128, 4, 8),
                (3, 8, 2, 128, 16, 32)]


def _paged_inputs(seed, b, hq, hkv, d, p, page, maxp=None, bt=None,
                  sl=None):
    rng = np.random.default_rng(seed)
    maxp = p // 2 if maxp is None else maxp
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((p, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((p, page, hkv, d)).astype(np.float32)
    if bt is None:
        bt = rng.integers(0, p, (b, maxp))
    if sl is None:
        sl = rng.integers(1, maxp * page, (b,))
    return (q, kp, vp, np.asarray(bt, np.int32), np.asarray(sl, np.int32))


RAGGED_PAGED = [
    # -1 entries inside and at the end of a row; a row on a page boundary
    dict(b=3, hq=4, hkv=2, d=32, p=6, page=8,
         bt=[[0, -1, 2, 3], [4, 5, -1, -1], [1, 1, 0, 5]], sl=[32, 16, 1]),
    # one page shared by every row, lengths at 1, a boundary and past it
    dict(b=3, hq=6, hkv=3, d=96, p=3, page=16, bt=[[2, 0], [2, 1], [2, 2]],
         sl=[1, 16, 17]),
]


def _paged_cases():
    cases = [dict(b=b, hq=hq, hkv=hkv, d=d, p=p, page=page)
             for b, hq, hkv, d, p, page in PAGED_SHAPES]
    return cases + RAGGED_PAGED


@pytest.mark.parametrize("case", _paged_cases(),
                         ids=[f"case{i}" for i in range(len(_paged_cases()))])
def test_paged_attention_plain_matches_reference(case):
    args = _paged_inputs(7, **case)
    want = np.asarray(jref.paged_decode_attention(*map(jnp.asarray, args)))
    got = ops.paged_decode_attention(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("case", _paged_cases(),
                         ids=[f"case{i}" for i in range(len(_paged_cases()))])
def test_paged_attention_plain_matches_pallas_interpret(case):
    args = _paged_inputs(8, **case)
    want = np.asarray(paged_decode_attention_pallas(
        *map(jnp.asarray, args), interpret=True))
    got = ops.paged_decode_attention(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x|, taken no lower than at 2**-7: nearer 0 a bf16
    ulp is finer than the rounding of the f32 sums themselves."""
    m = np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -7)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def test_paged_attention_plain_bf16_pages_match_reference():
    """bf16 pages, as the serving pool holds them: with an f32 query the
    outputs agree within atol 1e-4; with a bf16 query the bf16 outputs
    are within one bf16 ulp of the reference's."""
    q, kp, vp, bt, sl = _paged_inputs(9, 3, 8, 2, 128, 16, 32)
    kb = jnp.asarray(kp).astype(jnp.bfloat16)
    vb = jnp.asarray(vp).astype(jnp.bfloat16)
    kt = torch.from_numpy(kp).to(torch.bfloat16)
    vt = torch.from_numpy(vp).to(torch.bfloat16)
    assert np.array_equal(np.asarray(kb.astype(jnp.float32)),
                          kt.float().numpy())
    want = np.asarray(jref.paged_decode_attention(
        jnp.asarray(q), kb, vb, jnp.asarray(bt), jnp.asarray(sl)))
    got = ops.paged_decode_attention(torch.from_numpy(q), kt, vt,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    want16 = np.asarray(jref.paged_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16), kb, vb, jnp.asarray(bt),
        jnp.asarray(sl)).astype(jnp.float32))
    got16 = ops.paged_decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), kt, vt, torch.from_numpy(bt),
        torch.from_numpy(sl))
    assert got16.dtype == torch.bfloat16
    assert (np.abs(got16.float().numpy() - want16) <= bf16_ulp(want16)).all()


def test_paged_attention_empty_row_is_nan_as_in_reference():
    """A row with no valid position (seq_len 0, or every page absent) is
    NaN in ``ref.py``'s softmax over nothing but -inf, and in the port's
    plain version (and CUDA kernel).  The reference's Pallas kernel
    writes 0 there instead; the port follows ``ref.py``.  The engine
    never asks for such a row: its lengths are at least 1."""
    args = _paged_inputs(10, 3, 4, 2, 32, 6, 8, bt=[[0, 1], [-1, -1], [2, 3]],
                         sl=[0, 9, 12])
    want = np.asarray(jref.paged_decode_attention(*map(jnp.asarray, args)))
    got = ops.paged_decode_attention(*map(torch.from_numpy, args)).numpy()
    assert np.isnan(want[:2]).all() and np.isnan(got[:2]).all()
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    pallas = np.asarray(paged_decode_attention_pallas(
        *map(jnp.asarray, args), interpret=True))
    assert (pallas[:2] == 0).all()


def test_paged_attention_scale_is_the_references_f32_value():
    for d in (16, 64, 96, 128, 256):
        want = float(1.0 / jnp.sqrt(d).astype(jnp.float32))
        assert ref.decode_scale(d) == want


def test_paged_attention_rejects_bad_shapes_and_devices():
    q, kp, vp, bt, sl = map(torch.from_numpy, _paged_inputs(
        11, 2, 4, 2, 16, 4, 8))
    with pytest.raises(ValueError, match="GQA"):
        ops.paged_decode_attention(q[:, :3], kp, vp, bt, sl)
    with pytest.raises(ValueError, match="fit"):
        ops.paged_decode_attention(q, kp, vp[:, :, :1], bt, sl)
    with pytest.raises(ValueError, match="batch"):
        ops.paged_decode_attention(q, kp, vp, bt[:1], sl)
    meta = [x.to("meta") for x in (q, kp, vp, bt, sl)]
    with pytest.raises(ValueError, match="device"):
        paged_attention.paged_decode_attention(*meta)


# -- the split-KV kernel's arithmetic: partial softmax states per chunk of
# positions, folded in split order (csrc/paged_attention.cu) -------------

def _chunk_partials(q, kp, vp, bt, sl, chunk):
    """Each chunk's (m, l, acc) per query row, in plain torch: the running
    max of its valid scores (-inf when it has none), the sum of their
    exponentials from that max, and the weighted sum of V rows.  An
    empty chunk's acc is NaN, as a workspace the kernel never wrote may
    hold: the combine must not read it."""
    b, hq, d = q.shape
    _p, page, hkv, _ = kp.shape
    g, maxp = hq // hkv, bt.shape[1]
    safe = bt.clamp(min=0).long()
    k = kp[safe].reshape(b, maxp * page, hkv, d)
    v = vp[safe].reshape(b, maxp * page, hkv, d)
    pos = torch.arange(maxp * page)
    valid = (pos[None] < sl[:, None]) & (bt >= 0).repeat_interleave(page, 1)
    s = torch.einsum("bhgd,blhd->bhgl", q.reshape(b, hkv, g, d), k)
    s = s * ref.decode_scale(d)
    out = []
    for start in range(0, maxp * page, chunk):
        mine = valid & (pos[None] >= start) & (pos[None] < start + chunk)
        sc = torch.where(mine[:, None, None], s, -torch.inf)
        m = sc.amax(-1)
        base = torch.where(m == -torch.inf, 0.0, m)
        p = torch.exp(sc - base[..., None])
        acc = torch.einsum("bhgl,blhd->bhgd", p, v)
        acc = torch.where((m == -torch.inf)[..., None], torch.nan, acc)
        out.append((m.reshape(b, hq), p.sum(-1).reshape(b, hq),
                    acc.reshape(b, hq, d)))
    return out


def _combine(partials):
    """The combine's formula: M = max m_s; each split with m_s > -inf
    weighs in with expf(m_s - M), an empty one is skipped; out = sum w_s
    acc_s / sum w_s l_s (0 / 0 = NaN for a row with nothing valid)."""
    mx = torch.stack([m for m, _l, _a in partials]).amax(0)
    num = torch.zeros_like(partials[0][2])
    den = torch.zeros_like(partials[0][1])
    for m, l, acc in partials:
        live = m > -torch.inf
        w = torch.exp(torch.where(live, m - mx, 0.0))
        num = num + torch.where(live[..., None], w[..., None] * acc, 0.0)
        den = den + torch.where(live, w * l, 0.0)
    return num / den[..., None]


SPLIT_CASES = {
    # lengths at chunk - 1, chunk and chunk + 1 (chunk 32, pages of 8)
    "seams": dict(b=3, hq=8, hkv=2, d=32, p=12, page=8, maxp=8, chunk=32,
                  sl=[31, 32, 33]),
    # chunk 1 (positions 16..31) lies wholly on absent pages
    "absent_chunk": dict(b=2, hq=4, hkv=2, d=16, p=8, page=8, maxp=6,
                         chunk=16, bt=[[0, 1, -1, -1, 2, 3], [4, 5, 6, 7,
                                                              -1, 1]],
                         sl=[48, 41]),
    # row 1 has no valid position, row 2 length 0: NaN as in ref.py
    "empty_rows": dict(b=3, hq=4, hkv=2, d=16, p=6, page=4, maxp=4, chunk=8,
                       bt=[[0, 1, 2, 3], [-1, -1, -1, -1], [4, 5, 0, 1]],
                       sl=[13, 16, 0]),
    "one_split": dict(b=2, hq=8, hkv=2, d=32, p=8, page=8, maxp=4, chunk=32,
                      sl=[32, 9]),
    "g1_phi3": dict(b=2, hq=4, hkv=4, d=96, p=10, page=16, maxp=5, chunk=32,
                    sl=[80, 47]),
    "g12_command_r": dict(b=2, hq=24, hkv=2, d=32, p=10, page=8, maxp=5,
                          chunk=16, sl=[40, 17]),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_partials_combine_to_the_reference(name):
    case = dict(SPLIT_CASES[name])
    chunk = case.pop("chunk")
    args = _paged_inputs(14, **case)
    want = np.asarray(jref.paged_decode_attention(*map(jnp.asarray, args)))
    partials = _chunk_partials(*map(torch.from_numpy, args), chunk)
    assert (len(partials) == 1) == (name == "one_split")
    got = _combine(partials).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if name == "empty_rows":
        assert np.isnan(want[1:]).all() and not np.isnan(want[0]).any()
    else:
        assert not np.isnan(want).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=1e-5)


@pytest.mark.parametrize("b,hkv,max_len,n_sm", [
    (8, 8, 4096, 132), (1, 8, 32768, 132), (7, 8, 640, 132), (1, 32, 16, 132),
    (3, 2, 100_000_000, 132), (65535, 8, 48, 132), (4, 8, 4097, 78)])
def test_split_plan_covers_each_position_once(b, hkv, max_len, n_sm):
    n_split, chunk = paged_attention.plan_splits(b, hkv, max_len, n_sm)
    assert chunk % paged_attention.TILE == 0 and chunk > 0
    assert 1 <= n_split <= paged_attention.MAX_SPLITS
    # the ranges [i * chunk, (i + 1) * chunk) cover 0..max_len - 1 once,
    # and no split starts past the end
    assert (n_split - 1) * chunk < max_len <= n_split * chunk


def test_split_plan_fills_the_card_at_the_decode_shape():
    """Qwen3-32B's timed decode shape: 8 sequences of 8 KV heads over
    4096 positions on 132 SMs gives 16 splits of 256, 1024 blocks."""
    assert paged_attention.plan_splits(8, 8, 4096, 132) == (16, 256)


def test_split_tile_of_the_wrapper_is_the_kernels():
    """The planner's chunk is a multiple of ``TILE``; the kernel's tiles
    (4 warps of 4 or 8 positions) all divide its ``kMaxTile``, which the
    wrapper's ``TILE`` must equal."""
    import re

    src = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    assert int(re.search(r"kMaxTile = (\d+);", src).group(1)) == \
        paged_attention.TILE


def test_paged_wrapper_never_syncs_with_the_device():
    """The wrapper never reads a device tensor on the host (``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``): the engine calls it once per
    layer in every decode step."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(paged_attention))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "cpu", "tolist", "numpy"}


# -- per-frame squared error, MSE and PSNR ---------------------------------

MSE_SHAPES = [(1, 8, 128), (4, 20, 150), (2, 64, 512)]


def _mse_inputs(seed, n, h, w, dtype):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (n, h, w))
    if dtype == np.uint8:
        b = np.clip(a + rng.integers(-12, 13, a.shape), 0, 255)
    else:
        b = a + rng.normal(0, 5, a.shape)
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("n,h,w", MSE_SHAPES)
def test_mse_plain_matches_reference(n, h, w, dtype):
    a, b = _mse_inputs(n * h + w, n, h, w, dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(ops.mse_sum(ta, tb).numpy(),
                               np.asarray(jref.mse_sum(ja, jb)), rtol=1e-5)
    # the Pallas kernel in interpret mode, through the reference's padding
    np.testing.assert_allclose(
        ops.mse_sum(ta, tb).numpy(),
        np.asarray(jops.mse_sum(ja, jb, use_pallas=True, interpret=True)),
        rtol=1e-5)
    np.testing.assert_allclose(
        ops.mse(ta, tb).numpy(),
        np.asarray(jops.mse(ja, jb, use_pallas=False)), rtol=1e-5)
    np.testing.assert_allclose(
        ops.psnr(ta, tb).numpy(),
        np.asarray(jops.psnr(ja, jb, use_pallas=False)), rtol=1e-5)


def test_psnr_of_equal_frames_is_capped_as_in_reference():
    a = np.full((2, 8, 16), 7, np.uint8)
    got = ops.psnr(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    want = np.asarray(jops.psnr(jnp.asarray(a), jnp.asarray(a),
                                use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        ops.psnr_from_mse(torch.tensor([0.0, 1.0]), peak=1.0).numpy(),
        np.asarray(jops.psnr_from_mse(jnp.asarray([0.0, 1.0]), peak=1.0)),
        rtol=1e-5)


def test_mse_rejects_bad_shapes_and_devices():
    a = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="N,H,W"):
        ops.mse_sum(a, a[:1])
    with pytest.raises(ValueError, match="N,H,W"):
        ops.mse_sum(a[0], a[0])
    with pytest.raises(ValueError, match="device"):
        mse.mse_sum(a.to("meta"), a.to("meta"))


def test_new_wrappers_on_cpu_count_plain_calls_not_launches():
    args = map(torch.from_numpy, _paged_inputs(12, 2, 4, 2, 16, 4, 8))
    a, b = map(torch.from_numpy, _mse_inputs(13, 2, 8, 16, np.uint8))
    launches = _build.launch_counts()
    _build.reset_plain_counts()
    ops.paged_decode_attention(*args)
    ops.mse_sum(a, b)
    ops.psnr(a, b)
    assert _build.plain_counts() == {"paged_attention": 1, "mse": 2}
    assert _build.launch_counts() == launches
    _build.reset_plain_counts()


# -- the squared-error kernel's launch plan and exact uint8 sums -----------

# MSE_SHAPES, the main path's ninety (1080, 5760) planes, planes of
# 16k + 1 and 16k + 15 bytes, and two whose vectors a cluster of 8 does
# not divide evenly
MSE_PLAN_SHAPES = MSE_SHAPES + [(90, 1080, 5760), (4, 17, 129), (3, 31, 97),
                                (3, 97, 1001), (2, 1081, 1919)]
N_SM = 132  # an H100 SXM


def _block_spans(p, plane_bytes, frame_addr):
    """The byte ranges of one frame that each block of its cluster reads,
    as ``mse_kernel`` in ``csrc/mse.cu`` computes them from the plan and
    the frame's address in a: its share of the whole vectors after the
    head, and for the last block the head and the tail values."""
    head = min(-frame_addr % p.vec, plane_bytes)
    nvec = (plane_bytes - head) // p.vec
    tail = plane_bytes - head - nvec * p.vec
    spans = []
    for rank in range(p.cluster):
        begin = rank * p.chunk
        end = min(begin + p.chunk, nvec)
        mine = [(head + begin * p.vec, head + end * p.vec)] if end > begin \
            else []
        if rank == p.cluster - 1:
            mine += [(0, head), (plane_bytes - tail, plane_bytes)]
        spans.append([s for s in mine if s[1] > s[0]])
    return head, spans


@pytest.mark.parametrize("esize", [1, 4])
@pytest.mark.parametrize("n,h,w", MSE_PLAN_SHAPES)
def test_mse_plan_covers_every_value_once(n, h, w, esize):
    """For a and b at every offset 0-15 from a 512-byte boundary (f32:
    every whole value), each frame's bytes are read exactly once, by
    vector loads at addresses of a and b aligned to the load, and a
    thread's uint32 never sums more than ``CAP_VALUES`` uint8 values."""
    plane_bytes = h * w * esize
    base_a, base_b = 1 << 20, 3 << 20
    for off_a in range(0, 16, esize):
        for off_b in range(0, 16, esize):
            pa, pb = base_a + off_a, base_b + off_b
            p = mse.plan(n, h * w, esize, pa, pb, N_SM)
            want = 16 if off_a == off_b else 4 if (off_a - off_b) % 4 == 0 \
                else 1
            assert p.vec == want and p.unroll == mse.UNROLL[p.vec]
            assert p.cluster in (1, 2, 4, 8)
            assert p.chunk * p.cluster >= plane_bytes // p.vec
            if esize == 1:  # a step's uint8 values, or a head and a tail
                assert max(p.unroll * p.vec, 2) <= mse.CAP_VALUES
            for frame in range(n):
                fa, fb = pa + frame * plane_bytes, pb + frame * plane_bytes
                head, spans = _block_spans(p, plane_bytes, fa)
                assert (fa + head) % p.vec == 0 and (fb + head) % p.vec == 0
                flat = sorted(s for blk in spans for s in blk)
                at = 0
                for lo, hi in flat:
                    assert lo == at, (off_a, off_b, frame, flat)
                    at = hi
                assert at == plane_bytes


def test_mse_plan_at_the_timed_and_path_shapes():
    """Aligned planes on 132 SMs: thirty 1080p planes take clusters of 8
    (240 blocks), the main path's ninety (1080, 5760) planes clusters of
    4 (360 blocks), each block whole 16-byte vectors."""
    assert tuple(mse.plan(30, 1080 * 1920, 1, 0, 1 << 30, N_SM)) == \
        (16, 4, 8, 16200)
    assert tuple(mse.plan(90, 1080 * 5760, 1, 0, 1 << 30, N_SM)) == \
        (16, 4, 4, 97200)
    assert tuple(mse.plan(30, 1080 * 1920, 4, 0, 1 << 30, N_SM)) == \
        (16, 4, 8, 64800)
    # one tiny plane: one block; a and b one byte apart: byte loads
    assert mse.plan(1, 7, 1, 0, 512, N_SM).cluster == 1
    assert mse.plan(2, 4096, 1, 1, 512, N_SM).vec == 1


def test_mse_plan_refuses_misaligned_f32():
    with pytest.raises(ValueError, match="aligned"):
        mse.plan(2, 64, 4, 2, 0, N_SM)


def test_mse_plan_constants_are_the_kernels():
    """The plan's threads, cluster limit, cap and unroll table are the
    ones ``csrc/mse.cu`` is built with (the kernel refuses another
    unroll)."""
    import re

    src = (_build.CSRC_DIR / "mse.cu").read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const("kThreads") == mse.THREADS
    assert const("kMaxCluster") == mse.MAX_CLUSTER
    assert const("kCapValues") == mse.CAP_VALUES
    assert mse.CAP_VALUES * 255 ** 2 < 2 ** 32
    unroll = re.search(r"return vec == 16 \? (\d+) : (\d+);", src)
    assert mse.UNROLL == {16: int(unroll.group(1)), 4: int(unroll.group(2)),
                          1: int(unroll.group(2))}


def test_word_squared_difference_is_exact_in_uint32():
    """The kernel's word sum dp4a(d, d) of d = vabsdiff4(x, y), the four
    bytes' |x_i - y_i|, is the sum of their squared differences, extremes
    included; and a thread's uint32 of ``CAP_VALUES`` values at 255^2
    each does not wrap."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (4096, 4)).astype(np.uint32)
    y = rng.integers(0, 256, (4096, 4)).astype(np.uint32)
    x[:3], y[:3] = [[0] * 4, [255] * 4, [0, 255, 0, 255]], \
        [[255] * 4, [0] * 4, [255, 0, 255, 0]]
    d = np.maximum(x, y) - np.minimum(x, y)  # vabsdiff4: bytes stay bytes
    assert d.max() <= 255
    got = (d * d).sum(axis=1, dtype=np.uint32)  # dp4a(d, d, 0)
    want = ((x.astype(np.int64) - y.astype(np.int64)) ** 2).sum(axis=1)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    assert mse.CAP_VALUES * 255 ** 2 <= np.iinfo(np.uint32).max


def _mse_extreme(case):
    shape = (1, 1080, 5760)
    rng = np.random.default_rng(23)
    if case == "0 vs 255":
        return np.zeros(shape, np.uint8), np.full(shape, 255, np.uint8)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    if case == "equal":
        return a, a.copy()
    return a, rng.integers(0, 256, shape).astype(np.uint8)


# rtol of the exact sum against the JAX reference's f32 sum; None where
# XLA's CPU sum of the frame is itself farther than 1e-5 from the true
# sum (1.385e-5 for a full frame of 0 against 255), so that the exact
# sum, being the nearer, cannot be within 1e-5 of it
MSE_EXTREMES = {"0 vs 255": None, "equal": 1e-5, "random": 1e-5}


@pytest.mark.parametrize("case", list(MSE_EXTREMES))
def test_mse_exact_sum_rounded_once_within_plain_tolerance(case):
    """What the kernel gives for uint8, the true integer sum rounded to f32
    once, is within half an f32 ulp of the true sum, never farther from it
    than the JAX reference's f32 sum, and within rtol 1e-5 of the port's
    plain version, which is what ``chip_smoke.py`` holds the kernel to."""
    a, b = _mse_extreme(case)
    true = ((a.astype(np.int64) - b.astype(np.int64)) ** 2).sum(axis=(1, 2))
    exact = true.astype(np.float32)  # round to nearest, as __ull2float_rn
    err = np.abs(exact.astype(np.float64) - true.astype(np.float64))
    assert np.all(err <= np.spacing(exact).astype(np.float64) / 2)
    plain = ops.mse_sum(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(exact, plain, rtol=1e-5)
    j = np.asarray(jref.mse_sum(jnp.asarray(a), jnp.asarray(b)))
    assert np.all(err <= np.abs(j.astype(np.float64) - true))
    if MSE_EXTREMES[case] is not None:
        np.testing.assert_allclose(exact, j, rtol=MSE_EXTREMES[case])


def test_mse_on_cpu_counts_one_plain_call_and_no_launch(monkeypatch):
    """A CPU tensor takes the plain version: one plain call, no launch,
    and no launch plan."""
    def no_plan(*args):
        raise AssertionError("planned a launch for a CPU tensor")

    monkeypatch.setattr(mse, "plan", no_plan)
    a, b = map(torch.from_numpy, _mse_inputs(29, 3, 17, 129, np.uint8))
    launches = _build.launch_counts()
    _build.reset_plain_counts()
    got = mse.mse_sum(a, b)
    assert _build.plain_counts() == {"mse": 1}
    assert _build.launch_counts() == launches
    torch.testing.assert_close(got, ref.mse_sum(a, b), rtol=0, atol=0)
    _build.reset_plain_counts()


def test_mse_wrapper_never_syncs_with_the_device():
    """The wrapper plans from shapes and pointers: it never reads a device
    tensor on the host (``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``)."""
    import ast

    tree = ast.parse(inspect.getsource(mse))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"item", "cpu", "tolist", "numpy"}


def test_every_kernel_has_a_source_in_the_build():
    assert {"paged_attention", "mse"} <= set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
