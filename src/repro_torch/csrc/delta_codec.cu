// Hand-written Hopper kernels for the TVC closed-loop DPCM (delta) codec.
//
// Replaces the TPU kernels in src/repro/kernels/delta_codec.py:
//   vss_delta_encode  <- delta_encode_pallas (_encode_kernel)
//   vss_delta_decode  <- delta_decode_pallas (_decode_kernel)
//
// Semantics (src/repro/kernels/ref.py, delta_encode / delta_decode):
//   rq_t    = clip(rint((x_t - recon) / q), lo, hi)
//   recon_t = clip(recon_{t-1} + rq_t * q, vmin, vmax)
//
// Bound: memory.  Every pixel does a handful of flops per frame against
// 5 to 8 bytes moved per frame, far below the H100's flop/byte ridge for
// f32 outside the tensor cores (67 TFLOP/s / 3.35 TB/s = 20 flop/B), so
// the least time is the bytes moved over 3.35 TB/s.  At a 1080p, 30-frame
// GOP (C*H*W = 6.22 M) with int8 residuals that is about 0.93 GB, 0.28 ms,
// for either direction.
//
// Design: one thread per (c, h, w) pixel walks T serially with `recon` in
// a register; frames never round-trip through memory between steps.  The
// (C, H, W) plane is flat and contiguous, so consecutive threads touch
// consecutive addresses in every frame and each frame's loads and stores
// coalesce.  The ragged edge is one bounds check on the flat index: no
// (8, 128) padding as on the TPU.  Residuals are read and written in the
// tier's own integer type (int8 / int16), selected by template.
//
// Exactness: rintf rounds half to even like jnp.round (roundf would round
// half away from zero and break q = 2 at once); the quotient is r * (1/q)
// as in the Pallas kernel, corrected to the IEEE r / q of the plain
// version (tvc_math.cuh), with 1/q rounded to f32 on the host.  Build
// without fast math, flush-to-zero or FMA contraction so every other step
// is the IEEE operation the plain PyTorch version performs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tvc_math.cuh"

namespace {

constexpr int kThreads = 256;

template <typename R>
__global__ void delta_encode_kernel(const float* __restrict__ frames,
                                    float* __restrict__ iframe,
                                    R* __restrict__ resid, int64_t n,
                                    int t_total, float q, float inv_q,
                                    float lo, float hi, float vmin,
                                    float vmax) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float recon = frames[p];
  iframe[p] = recon;
  for (int t = 1; t < t_total; ++t) {
    const float x = frames[(int64_t)t * n + p];
    const float rq = quantize(x, recon, q, inv_q, lo, hi);
    recon = clampf(recon + rq * q, vmin, vmax);
    resid[(int64_t)(t - 1) * n + p] = (R)rq;
  }
}

template <typename R>
__global__ void delta_decode_kernel(const float* __restrict__ iframe,
                                    const R* __restrict__ resid,
                                    float* __restrict__ out, int64_t n,
                                    int t_resid, float q, float vmin,
                                    float vmax) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float recon = iframe[p];
  out[p] = recon;
  for (int t = 0; t < t_resid; ++t) {
    const float rq = (float)resid[(int64_t)t * n + p];
    recon = clampf(recon + rq * q, vmin, vmax);
    out[(int64_t)(t + 1) * n + p] = recon;
  }
}

// Counts the finite f32 x whose rintf(quotient(x, q, inv_q)) differs
// from rintf(x / q): every one of the 2^32 bit patterns is tried.
__global__ void quotient_check_kernel(float q, float inv_q,
                                      unsigned long long* mismatches) {
  unsigned long long bad = 0;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    if (!isfinite(x)) continue;
    if (!(rintf(quotient(x, q, inv_q)) == rintf(x / q))) ++bad;
  }
  if (bad) atomicAdd(mismatches, bad);
}

inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  `resid_bytes`
// selects the residual type of the codec's tiers: 1 = int8, 2 = int16.
int vss_delta_encode(const float* frames, float* iframe, void* resid,
                     int resid_bytes, long long n, int t_total, float q,
                     float inv_q, float lo, float hi, float vmin, float vmax,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_for(n)), block(kThreads);
  switch (resid_bytes) {
    case 1:
      delta_encode_kernel<int8_t><<<grid, block, 0, s>>>(
          frames, iframe, (int8_t*)resid, n, t_total, q, inv_q, lo, hi, vmin,
          vmax);
      break;
    case 2:
      delta_encode_kernel<int16_t><<<grid, block, 0, s>>>(
          frames, iframe, (int16_t*)resid, n, t_total, q, inv_q, lo, hi, vmin,
          vmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vss_delta_decode(const float* iframe, const void* resid, int resid_bytes,
                     float* out, long long n, int t_resid, float q, float vmin,
                     float vmax, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_for(n)), block(kThreads);
  switch (resid_bytes) {
    case 1:
      delta_decode_kernel<int8_t><<<grid, block, 0, s>>>(
          iframe, (const int8_t*)resid, out, n, t_resid, q, vmin, vmax);
      break;
    case 2:
      delta_decode_kernel<int16_t><<<grid, block, 0, s>>>(
          iframe, (const int16_t*)resid, out, n, t_resid, q, vmin, vmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Writes to *mismatches_dev (device memory, zeroed by the caller) the
// number of finite f32 residuals that the kernels' quotient rounds
// differently from an IEEE division by q.  A check, not a codec kernel.
int vss_quotient_mismatches(float q, float inv_q,
                            unsigned long long* mismatches_dev, void* stream) {
  quotient_check_kernel<<<132 * 16, kThreads, 0, (cudaStream_t)stream>>>(
      q, inv_q, mismatches_dev);
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
