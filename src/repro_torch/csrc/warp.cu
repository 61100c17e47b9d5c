// Hand-written Hopper kernel for the bilinear homography warp of joint
// compression (§5.1): out[n, c, y, x] = bilinear(img[n, c], H^-1 @ (x, y, 1)),
// zero for every corner outside the source.
//
// Replaces the TPU kernel warp_pallas (_warp_kernel) in
// src/repro/kernels/warp.py.  Semantics: src/repro/kernels/ref.py, warp,
// as XLA runs it on the CPU (the reference's path off the TPU), which the
// plain version in src/repro_torch/kernels/ref.py copies bit for bit.
//
// Bound: memory.  Per output pixel and channel the kernel does about 20
// f32 operations against 4 bytes written and 1 (uint8) or 4 (f32) bytes
// read, far below the H100's ridge of 20 f32 operations per byte, so the
// least time is the bytes over 3.35 TB/s: one 1080p RGB frame from uint8
// to f32 moves 6.2 + 24.9 MB, 9.3 us.
//
// Design: one thread per output pixel of one frame (grid.y = frame)
// computes the source coordinate and the four bilinear weights once and
// writes all C channels; consecutive threads take consecutive output
// columns, so the stores coalesce.  The four corner reads are gathers
// through L2: a 1080p f32 source plane is 8.3 MB and a whole uint8 frame
// 6.2 MB, well inside the 50 MB L2, and neighbouring output pixels read
// neighbouring source pixels.  The TPU kernel kept the source plane in
// VMEM and fell back to the oracle above 12 MiB; the card needs neither
// the residency nor the cut-off.  The source may be uint8 (the frames as
// stored; uint8 -> f32 is exact) or f32, selected by template.
//
// Exactness: each coordinate row is fma(m1, y, m0 * x) + m2, the order
// XLA's CPU dot evaluates; the division is IEEE (-prec-div=true); the
// float -> int32 conversion is cvt.rzi.s32.f32 (__float2int_rz), which
// like XLA's saturates out-of-range values and maps NaN to 0, and the
// next corner's "+ 1" is done in unsigned arithmetic so INT32_MAX wraps
// as the reference's int32 add does, without undefined behaviour.  The
// weights and the left-to-right sum follow ref.py term for term; the
// build has no FMA contraction (--fmad=false), so the only fused
// operation is the one written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hinv {
  float m[9];  // row-major 3x3, maps destination (x, y, 1) to source
};

__device__ __forceinline__ int plus_one(int i) {
  return (int)((unsigned int)i + 1u);
}

template <typename T>
__global__ void warp_kernel(const T* __restrict__ img, float* __restrict__ out,
                            int C, int H, int W, int OH, int OW, Hinv hm) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_out = (int64_t)OH * OW;
  if (p >= n_out) return;
  const int frame = blockIdx.y;
  const float x = (float)(int)(p % OW);
  const float y = (float)(int)(p / OW);
  const float* m = hm.m;
  const float sxh = __fmaf_rn(m[1], y, m[0] * x) + m[2];
  const float syh = __fmaf_rn(m[4], y, m[3] * x) + m[5];
  const float szh = __fmaf_rn(m[7], y, m[6] * x) + m[8];
  const float sx = sxh / szh;
  const float sy = syh / szh;

  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = sx - x0;
  const float fy = sy - y0;
  const int x0i = __float2int_rz(x0);
  const int y0i = __float2int_rz(y0);
  const int x1i = plus_one(x0i);
  const int y1i = plus_one(y0i);
  const bool vx0 = x0i >= 0 && x0i < W, vx1 = x1i >= 0 && x1i < W;
  const bool vy0 = y0i >= 0 && y0i < H, vy1 = y1i >= 0 && y1i < H;

  const float w00 = (1.0f - fy) * (1.0f - fx);
  const float w01 = (1.0f - fy) * fx;
  const float w10 = fy * (1.0f - fx);
  const float w11 = fy * fx;

  const int64_t plane = (int64_t)H * W;
  const T* src = img + (int64_t)frame * C * plane;
  float* dst = out + (int64_t)frame * C * n_out + p;
  const int64_t r0 = (int64_t)y0i * W, r1 = (int64_t)y1i * W;
  for (int c = 0; c < C; ++c, src += plane, dst += n_out) {
    const float v00 = (vy0 && vx0) ? (float)__ldg(src + r0 + x0i) : 0.0f;
    const float v01 = (vy0 && vx1) ? (float)__ldg(src + r0 + x1i) : 0.0f;
    const float v10 = (vy1 && vx0) ? (float)__ldg(src + r1 + x0i) : 0.0f;
    const float v11 = (vy1 && vx1) ? (float)__ldg(src + r1 + x1i) : 0.0f;
    *dst = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  `src_bytes`
// selects the source type: 1 = uint8, 4 = f32.  `hinv` points to nine
// host floats.
int vss_warp(const void* img, int src_bytes, float* out, int n, int c, int h,
             int w, int oh, int ow, const float* hinv, void* stream) {
  Hinv hm;
  for (int i = 0; i < 9; ++i) hm.m[i] = hinv[i];
  const int64_t n_out = (int64_t)oh * ow;
  const dim3 grid((unsigned int)((n_out + kThreads - 1) / kThreads),
                  (unsigned int)n);
  const dim3 block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (src_bytes) {
    case 1:
      warp_kernel<uint8_t><<<grid, block, 0, s>>>(
          (const uint8_t*)img, out, c, h, w, oh, ow, hm);
      break;
    case 4:
      warp_kernel<float><<<grid, block, 0, s>>>(
          (const float*)img, out, c, h, w, oh, ow, hm);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
