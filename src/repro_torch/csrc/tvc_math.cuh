// Arithmetic shared by the TVC kernels (delta_codec.cu, transcode.cu).
#pragma once

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x / q, rounded to nearest even, without a division.  y = x * inv_q with
// inv_q = f32(1/q) is within an ulp of the quotient; one Markstein step
// (the remainder x - y*q is exact in an FMA) corrects it to the IEEE
// quotient the plain versions compute wherever it is a normal number.
// IEEE division itself costs the transcode kernel about 30 % (its slow
// path is a call the compiler will not schedule loads across), and the
// bare product x * inv_q rounds differently at rare residuals such as
// 228 - 2^-16 with q = 24.  The codec needs rintf(quotient) to equal
// rintf(x / q); vss_quotient_mismatches checks that for every finite f32.
__device__ __forceinline__ float quotient(float x, float q, float inv_q) {
  const float y = x * inv_q;
  const float r = fmaf(-y, q, x);
  return fmaf(r, inv_q, y);
}

// Residual of one closed-loop DPCM step: clip(rint((x - recon) / q)).
__device__ __forceinline__ float quantize(float x, float recon, float q,
                                          float inv_q, float lo, float hi) {
  return clampf(rintf(quotient(x - recon, q, inv_q)), lo, hi);
}
