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
// What paces it on the card is instruction issue and latency, not bytes.
// The first version (one thread per pixel of a 1-D grid) spent its
// instructions on a 64-bit div and mod per pixel to find x and y and on
// twelve uint8 -> f32 conversions per pixel (the gathered corners) in
// the SM's quarter-rate conversion unit.  So:
//
// - The grid is 2-D, output column tiles x rows (frame on z): x and y
//   come from the block and thread indices.  A thread takes kCols
//   consecutive columns of one row, computes each pixel's source
//   coordinate, weights and corner indices once, then writes all C
//   channels, each as one 16-byte store where the output row allows it
//   (OW a multiple of kCols) and as scalar stores otherwise.
// - A gathered uint8 becomes f32 by two exact operations (2^23 + b as
//   bits, minus 2^23) instead of a conversion.
// - Offsets inside a plane are 32-bit where the plane allows
//   (corner_offset).
// - The per-pixel state is the four weights and the two corner indices,
//   so the kernel fits 80 registers and six blocks of 128 threads share
//   an SM: occupancy, not fewer instructions, paid most.  Variants that
//   cut instructions but held more registers ran slower: two 4-byte
//   window loads a row in place of a thread's eight byte gathers, and a
//   branch-free IEEE division with exact float -> int shortcuts.
//   Variants timed without the coordinate math, without the gathers and
//   without the stores each saved 1-4 us of about 18, so no one part
//   sets the pace.
//
// The corner reads are gathers through L1/L2: a 1080p uint8 frame is
// 6.2 MB and a f32 plane 8.3 MB, well inside the 50 MB L2, and
// neighbouring output pixels read neighbouring source pixels.  The
// source may be uint8 (the frames as stored) or f32, selected by
// template.
//
// Exactness: each coordinate row is fma(m1, y, m0 * x) + m2 per pixel,
// the order XLA's CPU dot evaluates; both divisions are IEEE and per
// pixel (-prec-div=true); the float -> int32 conversion is
// cvt.rzi.s32.f32 (__float2int_rz), which like XLA's saturates
// out-of-range values and maps NaN to 0, and the corners' "+ 1" and row
// offsets are unsigned arithmetic, so INT32_MAX wraps as the reference's
// int32 add does.  The weights and the left-to-right sum follow ref.py
// term for term; the build has no FMA contraction (--fmad=false), so the
// only fused operation is the one written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;  // consecutive output columns per thread
constexpr int kTx = 32;   // threads across a row: 128 columns per block
constexpr int kTy = 4;    // rows per block
constexpr int kThreads = kTx * kTy;
constexpr unsigned int kMaxGridY = 65535;

// Blocks an SM holds, as the kernel is built for them: 80 registers a
// thread with 32-bit offsets, 128 with 64-bit ones, which spill at 80.
// The 64-bit build serves planes of 2^31 values or more: chip_smoke.py
// reads its ptxas spill line but runs no such plane.
template <typename Idx>
constexpr int kMinBlocks = sizeof(Idx) == 4 ? 6 : 4;

struct Hinv {
  float m[9];  // row-major 3x3, maps destination (x, y, 1) to source
};

__device__ __forceinline__ float to_f32(uint8_t b) {
  // 2^23 + b is exact in f32, and so is its difference with 2^23
  return __int_as_float(0x4B000000 | (int)b) - 8388608.0f;
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// The offset y0 * W + x0 of a pixel's first corner, signed.  It is only
// used where one of the four corners lies inside the source, so
// -1 <= y0 < H and -1 <= x0 < W, and it lies in [-W - 1, H * W): the
// 32-bit version, taken where H * W < 2^31, computes it modulo 2^32 (no
// overflow to undefined behaviour) and gets it exactly.
template <typename Idx>
__device__ __forceinline__ Idx corner_offset(int y0, int x0, int w) {
  if constexpr (sizeof(Idx) == 4) {
    return (Idx)((unsigned int)y0 * (unsigned int)w + (unsigned int)x0);
  } else {
    return (Idx)y0 * w + x0;
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads, kMinBlocks<Idx>)
warp_kernel(const T* __restrict__ img, float* __restrict__ out, int C, int H,
            int W, int OH, int OW, Hinv hm, bool vec_store) {
  const int x_first = (blockIdx.x * kTx + threadIdx.x) * kCols;
  if (x_first >= OW) return;
  const int frame = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const size_t n_out = (size_t)OH * OW;
  const T* frame_src = img + (size_t)frame * C * plane;
  float* frame_dst = out + (size_t)frame * C * n_out + x_first;
  const float* m = hm.m;
  for (int y = blockIdx.y * kTy + threadIdx.y; y < OH;
       y += gridDim.y * kTy) {
    const float yf = (float)y;
    float w00[kCols], w01[kCols], w10[kCols], w11[kCols];
    int x0s[kCols], y0s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float x = (float)(x_first + j);
      const float sxh = __fmaf_rn(m[1], yf, m[0] * x) + m[2];
      const float syh = __fmaf_rn(m[4], yf, m[3] * x) + m[5];
      const float szh = __fmaf_rn(m[7], yf, m[6] * x) + m[8];
      const float sx = sxh / szh;
      const float sy = syh / szh;
      const float x0 = floorf(sx);
      const float y0 = floorf(sy);
      const float fx = sx - x0;
      const float fy = sy - y0;
      w00[j] = (1.0f - fy) * (1.0f - fx);
      w01[j] = (1.0f - fy) * fx;
      w10[j] = fy * (1.0f - fx);
      w11[j] = fy * fx;
      x0s[j] = __float2int_rz(x0);
      y0s[j] = __float2int_rz(y0);
    }

    const T* src = frame_src;
    float* dst = frame_dst + (size_t)y * OW;
    for (int c = 0; c < C; ++c, src += plane, dst += n_out) {
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // (unsigned)i < n is 0 <= i < n for the int i; the corners'
        // "+ 1" wraps INT32_MAX as the reference's int32 add does
        const int x1 = (int)((unsigned int)x0s[j] + 1u);
        const int y1 = (int)((unsigned int)y0s[j] + 1u);
        const bool vx0 = (unsigned int)x0s[j] < (unsigned int)W;
        const bool vx1 = (unsigned int)x1 < (unsigned int)W;
        const bool vy0 = (unsigned int)y0s[j] < (unsigned int)H;
        const bool vy1 = (unsigned int)y1 < (unsigned int)H;
        const T* p0 = src + corner_offset<Idx>(y0s[j], x0s[j], W);
        const T* p1 = p0 + W;
        const float v00 = vy0 && vx0 ? to_f32(__ldg(p0)) : 0.0f;
        const float v01 = vy0 && vx1 ? to_f32(__ldg(p0 + 1)) : 0.0f;
        const float v10 = vy1 && vx0 ? to_f32(__ldg(p1)) : 0.0f;
        const float v11 = vy1 && vx1 ? to_f32(__ldg(p1 + 1)) : 0.0f;
        v[j] = v00 * w00[j] + v01 * w01[j] + v10 * w10[j] + v11 * w11[j];
      }
      if (vec_store && x_first + kCols <= OW) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (x_first + j < OW) dst[j] = v[j];
        }
      }
    }
  }
}
static_assert(kCols == 4, "one float4 store per channel");

template <typename T, typename Idx>
void launch(const void* img, float* out, int n, int c, int h, int w, int oh,
            int ow, const Hinv& hm, cudaStream_t s) {
  const unsigned int tiles = (unsigned int)((ow + kTx * kCols - 1) /
                                            (kTx * kCols));
  unsigned int rows = (unsigned int)((oh + kTy - 1) / kTy);
  if (rows > kMaxGridY) rows = kMaxGridY;  // the kernel strides over rows
  const bool vec_store =
      ow % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  warp_kernel<T, Idx><<<dim3(tiles, rows, (unsigned int)n),
                        dim3(kTx, kTy), 0, s>>>(
      (const T*)img, out, c, h, w, oh, ow, hm, vec_store);
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
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = (int64_t)h * w < ((int64_t)1 << 31);
  switch (src_bytes) {
    case 1:
      if (small) launch<uint8_t, int32_t>(img, out, n, c, h, w, oh, ow, hm, s);
      else launch<uint8_t, int64_t>(img, out, n, c, h, w, oh, ow, hm, s);
      break;
    case 4:
      if (small) launch<float, int32_t>(img, out, n, c, h, w, oh, ow, hm, s);
      else launch<float, int64_t>(img, out, n, c, h, w, oh, ow, hm, s);
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
