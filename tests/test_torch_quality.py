"""Quality model (§3.2): the transitive MSE bound and admission logic —
the reference's `tests/test_quality.py` on the port — and the same
estimates, bounds and exact errors as the reference's."""
import numpy as np
import pytest

from repro.core import quality as jquality
from repro.core import types as jtypes
from repro_torch.core.quality import QualityEstimator, exact_mse, exact_psnr
from repro_torch.core.types import chain_mse_bound, mse_to_psnr, psnr_to_mse

try:  # property-based when the wheel is present, fixed sweep otherwise
    import hypothesis.strategies as st
    from hypothesis import given, settings

    def _seed_cases(fn):
        return settings(max_examples=60, deadline=None)(
            given(st.integers(0, 2**32 - 1))(fn)
        )

    def _db_cases(fn):
        return settings(deadline=None)(given(st.floats(1.0, 300.0))(fn))

except ImportError:
    def _seed_cases(fn):
        return pytest.mark.parametrize(
            "seed", [0, 1, 7, 123, 99991, 2**31, 2**32 - 1]
        )(fn)

    def _db_cases(fn):
        return pytest.mark.parametrize(
            "db", [1.0, 2.5, 17.3, 40.0, 97.2, 191.0, 300.0]
        )(fn)


@_seed_cases
def test_transitive_mse_bound_property(seed):
    """Paper §3.2: MSE(f0,f2) ≤ 2·(MSE(f0,f1) + MSE(f1,f2)) — checked on
    random transformation chains f0 → f1 → f2."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.float32)
    f1 = np.clip(f0 + rng.normal(0, rng.uniform(1, 30), f0.shape), 0, 255)
    f2 = np.clip(f1 + rng.normal(0, rng.uniform(1, 30), f0.shape), 0, 255)
    lhs = exact_mse(f0, f2)
    rhs = 2.0 * (exact_mse(f0, f1) + exact_mse(f1, f2))
    assert lhs <= rhs + 1e-3


def test_chain_bound_exact_for_direct_child():
    assert chain_mse_bound(0.0, 7.5, parent_is_original=True) == 7.5
    assert chain_mse_bound(3.0, 7.5, parent_is_original=False) == 21.0


@_db_cases
def test_psnr_mse_roundtrip(db):
    assert abs(mse_to_psnr(psnr_to_mse(db)) - db) < 1e-6


def test_requested_downsample_not_charged():
    """u is loss *relative to serving from m0*: a requested downsample is
    the ideal answer and must not fail admission (§3.2 semantics)."""
    q = QualityEstimator()
    assert q.resample_mse(1.0, 0.5) == 0.0  # downsample: requested
    assert q.resample_mse(0.5, 1.0) > 0.0  # upsample: detail is gone
    assert q.admissible(
        0.0, True, scale_from=1.0, scale_to=0.25, out_codec="tvc-hi",
        eps_db=40.0,
    )
    assert not q.admissible(
        0.0, True, scale_from=0.125, scale_to=1.0, out_codec="rgb",
        eps_db=40.0,
    )


def test_compression_estimate_refined_by_observation():
    q = QualityEstimator()
    seed = q.compression_mse("tvc-med")
    q.observe_compression("tvc-med", seed * 3)
    assert q.compression_mse("tvc-med") > seed


def test_exact_psnr_identity():
    a = np.zeros((1, 4, 4, 3), np.uint8)
    assert exact_psnr(a, a) == float("inf")


CODECS = ("rgb", "tvc-ll", "tvc-hi", "tvc-med", "tvc-lo", "h264", "hevc")


def test_estimator_sequence_matches_reference():
    """One seeded sequence of observations and questions through both
    estimators gives the same answers, float for float."""
    rng = np.random.default_rng(5)
    j, t = jquality.QualityEstimator(), QualityEstimator()
    for step in range(200):
        codec = CODECS[rng.integers(len(CODECS))]
        a, b = (float(x) for x in rng.choice(
            [0.125, 0.25, 0.5, 0.75, 1.0, 1.5, 3.0], 2))
        kind = step % 4
        if kind == 0:
            v = float(rng.uniform(0, 200))
            j.observe_compression(codec, v)
            t.observe_compression(codec, v)
        elif kind == 1:
            f, v = float(rng.choice([2.0, 3.0, 4.0, 6.0])), \
                float(rng.uniform(0, 300))
            j.observe_resample(f, v)
            t.observe_resample(f, v)
        kw = dict(scale_from=a, scale_to=b, out_codec=codec,
                  fragment_codec=CODECS[step % len(CODECS)])
        bound, orig = float(rng.uniform(0, 50)), bool(step % 3)
        assert t.compression_mse(codec) == j.compression_mse(codec)
        assert t.resample_mse(a, b) == j.resample_mse(a, b)
        assert t.predicted_fragment_mse(bound, orig, **kw) == \
            j.predicted_fragment_mse(bound, orig, **kw)
        eps = float(rng.uniform(10, 60))
        assert t.admissible(bound, orig, eps_db=eps, **kw) == \
            j.admissible(bound, orig, eps_db=eps, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_errors_match_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-9, 10, a.shape),
                0, 255).astype(np.uint8)
    assert exact_mse(a, b) == jquality.exact_mse(a, b)
    assert exact_psnr(a, b) == jquality.exact_psnr(a, b)
    assert exact_psnr(a, a) == jquality.exact_psnr(a, a) == float("inf")


def test_bound_helpers_match_reference():
    for mse in (0.0, 1e-9, 0.5, 7.25, 650.25, 65025.0):
        assert mse_to_psnr(mse) == jtypes.mse_to_psnr(mse)
        for step in (0.0, 3.5):
            for orig in (True, False):
                assert chain_mse_bound(mse, step, orig) == \
                    jtypes.chain_mse_bound(mse, step, orig)
    for db in (1.0, 24.0, 40.0, 99.5, 300.0):
        assert psnr_to_mse(db) == jtypes.psnr_to_mse(db)
