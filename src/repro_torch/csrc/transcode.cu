// Hand-written Hopper kernel for the fused TVC transcode:
// decode(q_in) -> f x f box mean -> encode(q_out).
//
// Replaces the TPU kernel transcode_pallas (_transcode_kernel) in
// src/repro/kernels/transcode.py.  Semantics: src/repro/kernels/ref.py,
// transcode = delta_encode(box_downsample(delta_decode(...), f), ...).
//
// Bound: memory.  Per output pixel and frame the kernel reads f*f input
// residuals and writes one output residual, with a few flops each; the
// least time is those bytes over 3.35 TB/s (at a 1080p, 30-frame GOP,
// f = 2, int8 in and out: about 0.26 GB, 0.08 ms).
//
// Design: one thread per OUTPUT pixel (c, oy, ox).  For f up to
// kMaxUnrolled it carries the f*f input recon states and the one output
// recon state in registers (17 floats at f = 4, templated on f so the
// arrays stay in registers) and walks T; the full-rate decoded frames
// never reach device memory, which is the point of the fusion.  Larger
// factors would spill those states, so they keep them in a (C, H, W) f32
// plane in device memory instead, one f x f patch per thread.
// Consecutive threads take consecutive output columns, so each input row
// segment a warp reads is contiguous.  The ragged edge is one bounds check
// on the flat output index; f must divide H and W (the codec checks that),
// and no (8f, 128f) padding is needed.
//
// Exactness: the pooled value is the sum of the f*f recon values times
// f32(1/(f*f)), which is how XLA lowers the reference's mean.  The values
// are integers of at most 255 when the I-frame is, so the sum is exact in
// f32 whatever its order.  The output residual's quotient by q_out is the
// IEEE one of the reference's delta_encode (tvc_math.cuh): away from
// power-of-two f the pooled residuals leave the 1/16 grid on which the
// Pallas kernel's bare r * f32(1/q) happens to round like r / q (at
// q = 24, r = 228 - 2^-16 does not).  rintf rounds half to even.
// Build without fast math, flush-to-zero or FMA contraction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tvc_math.cuh"

namespace {

constexpr int kThreads = 256;
// Largest factor whose f*f input states stay in registers (64 floats).
constexpr int kMaxUnrolled = 8;

struct Params {
  int C, OH, OW, t_resid, factor;
  float inv_area, q_in, q_out, inv_q_out, lo, hi, vmin, vmax;
};

// One step of the output chain: quantize the pooled target against the
// output recon state, advance the state, return the residual.
__device__ __forceinline__ float encode_step(float target, float& rout,
                                             const Params& p) {
  const float rq = quantize(target, rout, p.q_out, p.inv_q_out, p.lo, p.hi);
  rout = clampf(rout + rq * p.q_out, p.vmin, p.vmax);
  return rq;
}

template <int F, typename RI, typename RO>
__global__ void transcode_kernel(const float* __restrict__ iframe,
                                 const RI* __restrict__ resid,
                                 float* __restrict__ iframe_out,
                                 RO* __restrict__ resid_out, Params p) {
  const int64_t n_out = (int64_t)p.C * p.OH * p.OW;
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int ox = (int)(o % p.OW);
  const int64_t rest = o / p.OW;
  const int oy = (int)(rest % p.OH);
  const int c = (int)(rest / p.OH);
  const int64_t W = (int64_t)p.OW * F;
  const int64_t H = (int64_t)p.OH * F;
  const int64_t n_in = (int64_t)p.C * H * W;
  const int64_t base = (int64_t)c * H * W + (int64_t)oy * F * W + (int64_t)ox * F;

  float rin[F * F];
  float sum = 0.0f;
#pragma unroll
  for (int dy = 0; dy < F; ++dy) {
#pragma unroll
    for (int dx = 0; dx < F; ++dx) {
      rin[dy * F + dx] = iframe[base + dy * W + dx];
      sum += rin[dy * F + dx];
    }
  }
  float rout = sum * p.inv_area;
  iframe_out[o] = rout;

  for (int t = 0; t < p.t_resid; ++t) {
    const RI* rt = resid + (int64_t)t * n_in + base;
    sum = 0.0f;
#pragma unroll
    for (int dy = 0; dy < F; ++dy) {
#pragma unroll
      for (int dx = 0; dx < F; ++dx) {
        const float rq = (float)rt[dy * W + dx];
        rin[dy * F + dx] = clampf(rin[dy * F + dx] + rq * p.q_in, p.vmin, p.vmax);
        sum += rin[dy * F + dx];
      }
    }
    resid_out[(int64_t)t * n_out + o] = (RO)encode_step(sum * p.inv_area, rout, p);
  }
}

// Any factor: the input recon states live in `state`, a (C, H, W) f32
// plane; each thread reads and writes only its own f x f patch of it.
template <typename RI, typename RO>
__global__ void transcode_any_kernel(const float* __restrict__ iframe,
                                     const RI* __restrict__ resid,
                                     float* __restrict__ state,
                                     float* __restrict__ iframe_out,
                                     RO* __restrict__ resid_out, Params p) {
  const int64_t n_out = (int64_t)p.C * p.OH * p.OW;
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int F = p.factor;
  const int ox = (int)(o % p.OW);
  const int64_t rest = o / p.OW;
  const int oy = (int)(rest % p.OH);
  const int c = (int)(rest / p.OH);
  const int64_t W = (int64_t)p.OW * F;
  const int64_t H = (int64_t)p.OH * F;
  const int64_t n_in = (int64_t)p.C * H * W;
  const int64_t base = (int64_t)c * H * W + (int64_t)oy * F * W + (int64_t)ox * F;

  float sum = 0.0f;
  for (int dy = 0; dy < F; ++dy) {
    for (int dx = 0; dx < F; ++dx) {
      const int64_t i = base + dy * W + dx;
      state[i] = iframe[i];
      sum += iframe[i];
    }
  }
  float rout = sum * p.inv_area;
  iframe_out[o] = rout;

  for (int t = 0; t < p.t_resid; ++t) {
    const RI* rt = resid + (int64_t)t * n_in;
    sum = 0.0f;
    for (int dy = 0; dy < F; ++dy) {
      for (int dx = 0; dx < F; ++dx) {
        const int64_t i = base + dy * W + dx;
        const float v = clampf(state[i] + (float)rt[i] * p.q_in, p.vmin, p.vmax);
        state[i] = v;
        sum += v;
      }
    }
    resid_out[(int64_t)t * n_out + o] = (RO)encode_step(sum * p.inv_area, rout, p);
  }
}

template <typename RI, typename RO>
void launch(const float* iframe, const void* resid, float* state,
            float* iframe_out, void* resid_out, const Params& p,
            cudaStream_t s) {
  const int64_t n_out = (int64_t)p.C * p.OH * p.OW;
  const dim3 grid((unsigned int)((n_out + kThreads - 1) / kThreads));
  const RI* ri = (const RI*)resid;
  RO* ro = (RO*)resid_out;
  switch (p.factor) {
#define VSS_TRANSCODE_CASE(F)                                               \
  case F:                                                                   \
    transcode_kernel<F, RI, RO><<<grid, kThreads, 0, s>>>(iframe, ri,       \
                                                          iframe_out, ro, p); \
    return;
    VSS_TRANSCODE_CASE(1)
    VSS_TRANSCODE_CASE(2)
    VSS_TRANSCODE_CASE(3)
    VSS_TRANSCODE_CASE(4)
    VSS_TRANSCODE_CASE(5)
    VSS_TRANSCODE_CASE(6)
    VSS_TRANSCODE_CASE(7)
    VSS_TRANSCODE_CASE(8)
#undef VSS_TRANSCODE_CASE
  }
  transcode_any_kernel<RI, RO><<<grid, kThreads, 0, s>>>(
      iframe, ri, state, iframe_out, ro, p);
}

}  // namespace

extern "C" {

// Largest factor served from registers; above it the caller passes a
// (C, H, W) f32 scratch plane as `state` (unused, and may be null, below).
int vss_transcode_max_unrolled() { return kMaxUnrolled; }

// Returns the cudaError_t of the launch (0 on success).  `in_bytes` and
// `out_bytes` select the residual types of the codec's tiers: 1 = int8,
// 2 = int16.
int vss_transcode(const float* iframe, const void* resid, int in_bytes,
                  float* state, float* iframe_out, void* resid_out,
                  int out_bytes, int C, int OH, int OW, int t_resid,
                  int factor, float inv_area, float q_in, float q_out,
                  float inv_q_out, float lo, float hi, float vmin, float vmax,
                  void* stream) {
  if (factor < 1 || (factor > kMaxUnrolled && state == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{C, OH, OW, t_resid, factor, inv_area, q_in, q_out,
                 inv_q_out, lo, hi, vmin, vmax};
  cudaStream_t s = (cudaStream_t)stream;
  const int key = in_bytes * 10 + out_bytes;
  switch (key) {
    case 11: launch<int8_t, int8_t>(iframe, resid, state, iframe_out, resid_out, p, s); break;
    case 12: launch<int8_t, int16_t>(iframe, resid, state, iframe_out, resid_out, p, s); break;
    case 21: launch<int16_t, int8_t>(iframe, resid, state, iframe_out, resid_out, p, s); break;
    case 22: launch<int16_t, int16_t>(iframe, resid, state, iframe_out, resid_out, p, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
