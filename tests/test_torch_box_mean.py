"""The integer box mean of a view read at a fraction of the stored size:
``kernels/box_mean.py`` (the wrapper and its plain version),
``csrc/box_mean.cu`` and ``core/resize.py``'s choice between them.

The plain version is held bit for bit against the reference's numpy pool
(``repro.core.store.resample``) and, over every block sum a factor can
give, against the exact quotient rounded half to even.  The cases marked
``cuda`` hold the kernel against the plain version; they skip without a
card.  The reference is imported inside the cases that use it, so
``python -m pytest -m cuda tests/test_torch_box_mean.py`` imports no JAX
on a machine with a card."""
import numpy as np
import pytest
import torch

from repro_torch.core import resize
from repro_torch.kernels import _build, box_mean as bm, ops

# one intra-op thread a worker process, as the other port suites
torch.set_num_threads(1)

FACTORS = (2, 3, 4, 5)
SHAPES = ("ragged", "one frame", "stepped crop")
EXHAUSTIVE = (2, 3, 4)


def _jresample(frames, resolution):
    from repro.core.store import resample

    return resample(frames, resolution)


def _frames(shape: str, f: int, seed: int = 0) -> np.ndarray:
    """(T, H, W, 3) uint8 for one of ``SHAPES`` at factor ``f``: 13
    output pixels a row (less than one run, odd row bytes); one frame of
    37 (whole runs and a tail); every third frame of a clip cropped off
    its origin (a non-contiguous view)."""
    rng = np.random.default_rng(seed + f)

    def draw(t, h, w):
        return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)

    if shape == "ragged":
        return draw(3, 7 * f, 13 * f)
    if shape == "one frame":
        return draw(1, 9 * f, 37 * f)
    big = draw(7, 12 * f + 5, 40 * f + 3)
    return big[::3, 2:2 + 12 * f, 1:1 + 40 * f]


def block_sums(f: int):
    """(1, f, px * f, 3) uint8 frames whose f x f blocks sum to 0, 1, ...,
    255 f^2 in turn (block b is output pixel b // 3, channel b % 3; the
    blocks past the last sum are 0), and those sums."""
    s = np.arange(255 * f * f + 1)
    px = -(-len(s) // 3)
    blocks = np.zeros((px * 3, f * f), np.uint8)
    blocks[:len(s)] = np.clip(s[:, None] - 255 * np.arange(f * f), 0, 255)
    x = blocks.reshape(px, 3, f, f).transpose(2, 0, 3, 1)
    return np.ascontiguousarray(x.reshape(1, f, px * f, 3)), s


def rounded_quotients(s: np.ndarray, f: int) -> np.ndarray:
    """s / f^2 rounded half to even, in exact integer arithmetic."""
    d = f * f
    q, r = np.divmod(s, d)
    return q + ((2 * r > d) | ((2 * r == d) & (q % 2 == 1)))


def _size(frames: np.ndarray, f: int):
    return frames.shape[2] // f, frames.shape[1] // f


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("f", FACTORS)
def test_plain_equals_reference_pool(f, shape):
    frames = _frames(shape, f)
    got = ops.box_mean(torch.from_numpy(frames), f).numpy()
    want = _jresample(frames, _size(frames, f))
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(resize.resample(frames, _size(frames, f),
                                          device="cpu"), want)


@pytest.mark.parametrize("f", EXHAUSTIVE)
def test_plain_every_block_sum(f):
    """Every sum 0..255 f^2: each .5 tie (f = 2: s = 2, 6, 10, ...) rounds
    to even and the top sum gives 255, as numpy's pool does."""
    frames, s = block_sums(f)
    got = ops.box_mean(torch.from_numpy(frames), f).numpy()
    assert np.array_equal(got.reshape(-1)[:len(s)], rounded_quotients(s, f))
    assert np.array_equal(got, _jresample(frames, _size(frames, f)))


@pytest.mark.parametrize("frames,factor,error", [
    (torch.zeros((1, 4, 4, 3), dtype=torch.float32), 2, TypeError),
    (torch.zeros((4, 4, 3), dtype=torch.uint8), 2, ValueError),
    (torch.zeros((1, 6, 4, 3), dtype=torch.uint8), 4, ValueError),
    (torch.zeros((1, 4, 4, 3), dtype=torch.uint8), 0, ValueError),
], ids=["float32", "3-d", "not divisible", "factor 0"])
def test_wrapper_refuses(frames, factor, error):
    before = (_build.launch_counts(), _build.plain_counts())
    with pytest.raises(error):
        ops.box_mean(frames, factor)
    assert (_build.launch_counts(), _build.plain_counts()) == before


def test_cpu_resample_pools_with_numpy():
    """A CPU store keeps the reference's numpy lines: no launch, and no
    call of the plain version either."""
    frames = _frames("one frame", 2)
    before = (_build.launch_counts(), _build.plain_counts())
    out = resize.resample(frames, _size(frames, 2), device="cpu")
    assert (_build.launch_counts(), _build.plain_counts()) == before
    assert np.array_equal(out, _jresample(frames, _size(frames, 2)))


def test_cuda_resample_takes_the_kernel_entry(monkeypatch):
    """A CUDA device uploads the frames, contiguous, and pools them
    through ``ops.box_mean`` once (a spy here, with the upload kept on
    the host), inside the ``vss.store.resample_box`` span."""
    frames = _frames("stepped crop", 2)
    uploads, calls = [], []
    real_to = torch.Tensor.to

    def upload(self, *args, **kwargs):
        if args == ("cuda",) and not kwargs:
            uploads.append(args)
            return self
        return real_to(self, *args, **kwargs)

    def spy(x, f):
        calls.append((tuple(x.shape), x.is_contiguous(), f))
        return bm.box_mean_plain(x, f)

    monkeypatch.setattr(torch.Tensor, "to", upload)
    monkeypatch.setattr(ops, "box_mean", spy)
    opened = []
    real_span = resize._obs.span

    def span(name, *a, **kw):
        opened.append(name)
        return real_span(name, *a, **kw)

    monkeypatch.setattr(resize._obs, "span", span)
    out = resize.resample(frames, _size(frames, 2), device="cuda")
    monkeypatch.undo()
    assert uploads == [("cuda",)]
    assert calls == [(frames.shape, True, 2)]
    assert opened == ["vss.store.resample_box"]
    assert np.array_equal(out, _jresample(frames, _size(frames, 2)))


# -- on the card ----------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU path")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("f", FACTORS)
def test_kernel_equals_plain(card, f, shape):
    x = torch.from_numpy(np.ascontiguousarray(_frames(shape, f)))
    got = ops.box_mean(x.to(card), f).cpu()
    assert torch.equal(got, bm.box_mean_plain(x, f))
    assert torch.equal(got, bm.box_mean_plain(x.to(card), f).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("f", EXHAUSTIVE)
def test_kernel_every_block_sum(card, f):
    frames, s = block_sums(f)
    got = ops.box_mean(torch.from_numpy(frames).to(card), f).cpu().numpy()
    assert np.array_equal(got.reshape(-1)[:len(s)], rounded_quotients(s, f))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_kernel_off_its_load_width(card, offset):
    """Frames that start off a 16-byte boundary take the scalar path."""
    x = torch.from_numpy(np.ascontiguousarray(_frames("one frame", 2)))
    buf = torch.empty(x.numel() + offset, dtype=torch.uint8, device=card)
    xs = buf[offset:].view(x.shape)
    xs.copy_(x.to(card))
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(ops.box_mean(xs, 2).cpu(), bm.box_mean_plain(x, 2))


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous(card):
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        ops.box_mean(x[:, :, 2:6], 2)


@pytest.mark.cuda
def test_cuda_resample_equals_numpy(card):
    frames = _frames("stepped crop", 2)
    before = _build.launch_counts().get("box_mean", 0)
    got = resize.resample(frames, _size(frames, 2), device="cuda")
    assert _build.launch_counts().get("box_mean", 0) == before + 1
    assert np.array_equal(got, resize.resample(frames, _size(frames, 2),
                                               device="cpu"))
