"""Quality model u(f0, f) — §3.2.

Error accumulates through two mechanisms and VSS sums both:

* **Resampling error** — tracked exactly per transformation step and
  chained through the transitive bound
  ``MSE(f0,f2) ≤ 2·(MSE(f0,f1) + MSE(f1,f2))`` so the original never has
  to be re-decoded (implemented in types.chain_mse_bound).
* **Compression error** — predicted without decoding, from mean bits per
  pixel (MBPP). The paper maps MBPP→PSNR via vbench measurements; TVC's
  equivalent is a per-tier rate-distortion table seeded analytically
  (uniform-quantizer MSE ≈ q²/12) and refined online: every time VSS
  actually decodes a fragment it can observe exact MSE and update the
  tier estimate (an EMA — the paper's "periodically samples regions,
  computes exact PSNR, and updates its estimate").

Resample-step error is likewise predicted from a per-factor estimator
(content-dependent; seeded with a synthetic-video calibration constant,
refined by observation at cache-admission time).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.codec import TIERS, canonical_codec
from repro_torch.core.types import chain_mse_bound, mse_to_psnr

# Analytic seed for resample error per downscale factor (MSE on uint8
# video with moderate texture; refined online).
_RESAMPLE_SEED_MSE = {1.0: 0.0, 2.0: 45.0, 4.0: 110.0, 8.0: 220.0}
_EMA_ALPHA = 0.2


def _tier_seed_mse(codec: str) -> float:
    codec = canonical_codec(codec)
    if codec == "rgb":
        return 0.0
    q = TIERS[codec].q
    if codec == "tvc-ll":
        return 0.0
    return q * q / 12.0


class QualityEstimator:
    """Predicts and tracks MSE contributions (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._codec_mse: Dict[str, float] = {}
        self._resample_mse: Dict[float, float] = dict(_RESAMPLE_SEED_MSE)

    # -- compression -----------------------------------------------------
    def compression_mse(self, codec: str) -> float:
        codec = canonical_codec(codec)
        with self._lock:
            return self._codec_mse.get(codec, _tier_seed_mse(codec))

    def observe_compression(self, codec: str, exact_mse: float) -> None:
        codec = canonical_codec(codec)
        with self._lock:
            prev = self._codec_mse.get(codec, _tier_seed_mse(codec))
            self._codec_mse[codec] = (
                (1 - _EMA_ALPHA) * prev + _EMA_ALPHA * exact_mse
            )

    # -- resampling ------------------------------------------------------
    def resample_mse(self, scale_from: float, scale_to: float) -> float:
        """Predicted *excess* MSE of serving a read at sampling density
        ``scale_to`` from a fragment stored at density ``scale_from``.

        u(f0, f) is loss **relative to serving the same read from m0**
        (§3.2): a requested downsample is the ideal answer, not a loss,
        so only *upsampling* — detail the fragment no longer has — is
        charged. The penalty is the inverse downsample's loss
        (information already gone), looked up per-factor.
        """
        if scale_to <= scale_from:
            return 0.0  # downsample (or same): the requested transform
        factor = scale_to / scale_from
        with self._lock:
            keys = sorted(self._resample_mse)
            if factor in self._resample_mse:
                return self._resample_mse[factor]
            # piecewise-linear interpolation (paper: interpolates α the
            # same way for unbenchmarked resolutions)
            xs = np.array(keys)
            ys = np.array([self._resample_mse[k] for k in keys])
            return float(np.interp(factor, xs, ys))

    def observe_resample(self, factor: float, exact_mse: float) -> None:
        with self._lock:
            prev = self._resample_mse.get(factor)
            if prev is None:
                self._resample_mse[factor] = exact_mse
            else:
                self._resample_mse[factor] = (
                    (1 - _EMA_ALPHA) * prev + _EMA_ALPHA * exact_mse
                )

    # -- fragment admission (§3.2) ----------------------------------------
    def predicted_fragment_mse(
        self,
        fragment_bound: float,
        fragment_is_from_original: bool,
        *,
        scale_from: float,
        scale_to: float,
        out_codec: str,
        fragment_codec: Optional[str] = None,
    ) -> float:
        """Excess MSE bound of (fragment → rescale → re-encode) vs
        serving the same read from m0.

        The requested output codec's quantization error is paid by
        *every* candidate (m0 included) and therefore cancels in the
        relative quality u.  For a first-generation fragment (parent is
        m0) whose codec *matches* the output codec, the accumulated
        bound IS that quantization error, so it cancels and only an
        upsample penalty remains; under a codec mismatch nothing
        cancels — the fragment's own error is carried into an output
        the requester expected at full quality — so the bound is
        charged in full.  (Without ``fragment_codec`` the historical
        matched-codec behaviour is kept.)  Chains of length ≥2 pay the
        §3.2 transitive factor-2 bound as before.
        """
        step = self.resample_mse(scale_from, scale_to)
        if fragment_is_from_original:
            if fragment_codec is not None and (
                canonical_codec(fragment_codec) != canonical_codec(out_codec)
            ):
                return fragment_bound + step
            return step  # bound ≈ out-codec quantization: cancels
        return chain_mse_bound(fragment_bound, step, fragment_is_from_original)

    def admissible(
        self,
        fragment_bound: float,
        fragment_is_from_original: bool,
        *,
        scale_from: float,
        scale_to: float,
        out_codec: str,
        eps_db: float,
        fragment_codec: Optional[str] = None,
    ) -> bool:
        mse = self.predicted_fragment_mse(
            fragment_bound, fragment_is_from_original,
            scale_from=scale_from, scale_to=scale_to, out_codec=out_codec,
            fragment_codec=fragment_codec,
        )
        return mse_to_psnr(mse) >= eps_db


def exact_mse(a: np.ndarray, b: np.ndarray) -> float:
    """Exact MSE between two (T, H, W, C) uint8 clips."""
    d = a.astype(np.float32) - b.astype(np.float32)
    return float((d * d).mean())


def exact_psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    return mse_to_psnr(exact_mse(a, b), peak)
