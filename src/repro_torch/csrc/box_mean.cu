// Hand-written Hopper kernel for the integer box mean of a view read at a
// fraction of the stored size (VSS.read's `resolution`, core/resize.py).
//
// Replaces no TPU kernel: the reference pools on the host with numpy
// (src/repro/core/store.py, resample), and a CPU store of the port still
// does.  Added because that host pass was the second largest stage of the
// 2K long reads, where 40 % of the reads ask for half size: numpy's mean
// over two strided axes of a 4x float32 temporary, about 10 s for sixty
// 1080p frames on eight host cores, for work the card streams in under a
// millisecond.
//
// Semantics (kernels/box_mean.py, box_mean_plain): (T, H, W, C) uint8,
// H and W divisible by f, to (T, H/f, W/f, C) uint8 with
//   out[t, y, x, c] = clip(rint(f32(S) / f32(f * f)), 0, 255),
// S the sum of the f x f inputs in[t, y*f + i, x*f + j, c].  S is summed
// exactly in integers and is below 2^24 for f <= 256, so f32(S) is exact;
// the quotient is the IEEE one (-prec-div=true) and rintf rounds half to
// even.  numpy's float32 mean sums exactly too and divides once (in f32,
// or in f64 and then rounded to f32: a quotient of two f32 values taken
// to 53 bits and then to 24 is rounded once), then rounds half to even:
// the same bits for every f <= 256.
//
// Bound: memory.  A handful of integer ops per input byte: each input
// byte read once and each output byte written once, (in + out bytes) /
// 3.35 TB/s (ninety 1920x1080x3 frames at f = 2: 559.9 + 140.0 MB,
// 0.2089 ms).
//
// Design:
// - One thread a run of P output pixels of one output row (P*C bytes):
//   it reads its f input rows' P*f*C bytes each as 16-byte loads, adds
//   each byte into its output byte's integer sum (the byte's place in
//   the run fixes which, at compile time), then divides, rounds and
//   stores the run with the widest stores its P*C bytes allow.  P is the
//   fewest pixels whose input row is whole 16-byte loads (f = 2, C = 3:
//   8 pixels, 48 bytes a row, 24 out).  Threads next to each other take
//   runs next to each other, so a warp's loads cover one stretch of each
//   input row.  No shared memory: each byte is read once.
// - Compiled for C = 3 (the store's frames) and f = 2, 3, 4; any other
//   (f, C) takes the scalar path below for every pixel.
// - A row's pixels past its last whole run (a ragged width), and every
//   run of a row whose input or output row does not start on the load
//   and store width, take the scalar path: one pixel a thread, byte
//   loads.
// - One launch a call on the caller's stream, no synchronize, no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFactor = 256;  // 255 * f^2 < 2^24: f32(S) is exact

__device__ __forceinline__ unsigned int mean_byte(unsigned int s,
                                                  float area) {
  const float q = rintf(__uint2float_rn(s) / area);
  return (unsigned int)fminf(fmaxf(q, 0.0f), 255.0f);
}

// the smallest run whose input row is whole 16-byte loads and whose
// output is whole 4-byte stores
__host__ __device__ constexpr int run_pixels(int f, int c) {
  int p = 1;
  while ((p * f * c) % 16 != 0 || (p * c) % 4 != 0) ++p;
  return p;
}

template <int F, int C>
struct RunShape {
  static constexpr int kPixels = run_pixels(F, C);
  static constexpr int kIn = kPixels * F * C;  // bytes of one input row
  static constexpr int kOut = kPixels * C;     // bytes written
  static constexpr int kStore = kOut % 16 == 0 ? 16 : kOut % 8 == 0 ? 8 : 4;
  static_assert(kIn % 16 == 0 && kOut % 4 == 0, "run not whole vectors");
};

__device__ __forceinline__ unsigned int word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// output pixel x of one output row: src is the first of its f input rows
// (in_row bytes apart), dst the output row.  F, C of 0: the runtime f, c.
template <int F, int C>
__device__ __forceinline__ void pixel(const uint8_t* __restrict__ src,
                                      uint8_t* __restrict__ dst,
                                      long long in_row, int f, int c,
                                      long long x) {
  const int ff = F ? F : f;
  const int cc = C ? C : c;
  const float area = (float)(ff * ff);
  const uint8_t* p0 = src + x * ff * cc;
  for (int ch = 0; ch < cc; ++ch) {
    unsigned int s = 0;
    for (int i = 0; i < ff; ++i) {
      const uint8_t* p = p0 + i * in_row + ch;
      for (int j = 0; j < ff; ++j) s += __ldg(p + j * cc);
    }
    dst[x * cc + ch] = (uint8_t)mean_byte(s, area);
  }
}

// one run: src and dst at the run's first input and output byte, on the
// load and store widths
template <int F, int C>
__device__ __forceinline__ void run(const uint8_t* __restrict__ src,
                                    uint8_t* __restrict__ dst,
                                    long long in_row) {
  using S = RunShape<F, C>;
  constexpr float kArea = (float)(F * F);
  unsigned int acc[S::kOut];
#pragma unroll
  for (int o = 0; o < S::kOut; ++o) acc[o] = 0;
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const uint4* p = reinterpret_cast<const uint4*>(src + i * in_row);
    uint4 v[S::kIn / 16];
#pragma unroll
    for (int k = 0; k < S::kIn / 16; ++k) v[k] = __ldg(p + k);
#pragma unroll
    for (int b = 0; b < S::kIn; ++b)
      acc[(b / (F * C)) * C + b % C] +=
          (word_of(v[b / 16], (b % 16) / 4) >> (8 * (b % 4))) & 0xffu;
  }
  unsigned int w[S::kOut / 4];
#pragma unroll
  for (int k = 0; k < S::kOut / 4; ++k)
    w[k] = mean_byte(acc[4 * k], kArea) |
           mean_byte(acc[4 * k + 1], kArea) << 8 |
           mean_byte(acc[4 * k + 2], kArea) << 16 |
           mean_byte(acc[4 * k + 3], kArea) << 24;
  if constexpr (S::kStore == 16) {
#pragma unroll
    for (int k = 0; k < S::kOut / 16; ++k)
      reinterpret_cast<uint4*>(dst)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else if constexpr (S::kStore == 8) {
#pragma unroll
    for (int k = 0; k < S::kOut / 8; ++k)
      reinterpret_cast<uint2*>(dst)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < S::kOut / 4; ++k)
      reinterpret_cast<unsigned int*>(dst)[k] = w[k];
  }
}

// items of one output row: `runs` runs, then `per_row - runs` single
// pixels (all pixels single where F is 0)
template <int F, int C>
__global__ void __launch_bounds__(kThreads)
box_mean_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                long long items, int ow, int f, int c, int runs,
                int per_row) {
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= items) return;
  long long row;
  int j;
  if (items <= 0xffffffffLL) {  // 32-bit division where it suffices
    const unsigned int r = (unsigned int)item / (unsigned int)per_row;
    row = r;
    j = (int)((unsigned int)item - r * (unsigned int)per_row);
  } else {
    row = item / per_row;
    j = (int)(item - row * per_row);
  }
  const long long out_row = (long long)ow * c;
  const long long in_row = out_row * f;
  const uint8_t* src = in + row * f * in_row;
  uint8_t* dst = out + row * out_row;
  if constexpr (F > 0) {
    using S = RunShape<F, C>;
    if (j < runs) {
      if ((uintptr_t)src % 16 == 0 && in_row % 16 == 0 &&
          (uintptr_t)dst % S::kStore == 0) {
        run<F, C>(src + (long long)j * S::kIn, dst + (long long)j * S::kOut,
                  in_row);
      } else {
        for (int x = j * S::kPixels; x < (j + 1) * S::kPixels; ++x)
          pixel<F, C>(src, dst, in_row, F, C, x);
      }
      return;
    }
    pixel<F, C>(src, dst, in_row, F, C,
                (long long)runs * S::kPixels + (j - runs));
  } else {
    pixel<0, 0>(src, dst, in_row, f, c, j);
  }
}

template <int F, int C>
cudaError_t launch(const void* in, void* out, long long rows, int ow, int f,
                   int c, cudaStream_t stream) {
  int runs = 0, per_row = ow;
  if constexpr (F > 0) {
    runs = ow / RunShape<F, C>::kPixels;
    per_row = runs + ow % RunShape<F, C>::kPixels;
  }
  const long long items = rows * per_row;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  box_mean_kernel<F, C><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      (const uint8_t*)in, (uint8_t*)out, items, ow, f, c, runs, per_row);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out (t, h/f, w/f, c) = the f x f box mean of in (t, h, w, c), both
// contiguous uint8.  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a shape or factor it does not take.
int vss_box_mean(const void* in, void* out, int t, int h, int w, int c,
                 int f, void* stream) {
  if (t < 1 || h < 1 || w < 1 || c < 1 || f < 1 || f > kMaxFactor ||
      h % f || w % f)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)t * (h / f);
  const int ow = w / f;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (c == 3 && f == 2)
    err = launch<2, 3>(in, out, rows, ow, f, c, s);
  else if (c == 3 && f == 3)
    err = launch<3, 3>(in, out, rows, ow, f, c, s);
  else if (c == 3 && f == 4)
    err = launch<4, 3>(in, out, rows, ow, f, c, s);
  else
    err = launch<0, 0>(in, out, rows, ow, f, c, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
