// Hand-written Hopper kernel for the per-(frame, channel) histograms of
// joint compression's GOP fingerprints (§5.1.3).
//
// Replaces the TPU kernel histogram_pallas (_hist_kernel) in
// src/repro/kernels/histogram.py.  Semantics: src/repro/kernels/ref.py,
// histogram: a value x falls in bin clip(int32(x * s), 0, bins - 1) with
// s = f32(bins / (vmax + 1)), counted per (frame, channel) into int32.
//
// Bound: memory.  A handful of integer operations per value against 1
// (uint8) or 4 (f32) bytes read: the least time is the input bytes over
// 3.35 TB/s (one 1080p RGB frame in uint8, 6.2 MB: 1.9 us; in f32
// 7.4 us).  At the fingerprint's one frame that is about one launch.
//
// Design: the TPU has no atomic scatter, so its kernel counts with one
// masked compare-and-sum per bin over (8, 128) tiles.  Here grid.y is
// the (frame, channel) plane and each block of a plane counts one
// contiguous chunk of it, read as 16-byte vectors, kVecs of them per
// thread all in flight together (a scalar head and tail cover a plane
// whose start or end is not 16-byte aligned); the loads go out before
// the block sets up its counters.  The first version (16 % of the bound)
// spent a conversion unit pass per value (uint8 -> f32, then f32 -> int)
// and one shared-memory atomic per value into a copy of the bins per
// warp, which serialised when the 32 lanes of a warp, neighbouring
// pixels of a natural image, hit the same bin, and zeroed its output
// with a second launch.  So:
//
// - A uint8 value's bin is a function of the byte alone.  Where every
//   byte's bin is byte >> shift (the fingerprint's 16 bins of 0..255:
//   shift 4), the host passes the shift (kernels/histogram.py checks it
//   against the f32 arithmetic for all 256 bytes); other uint8 inputs,
//   and f32 ones, are binned by that arithmetic.  (A 256-entry byte ->
//   bin table in shared memory was slower than the shift at the
//   fingerprint's shape and served no caller.)
// - Up to kLaneBins bins each lane counts into its own column of a
//   [warp][bin][lane] array in shared memory: lane l of every row is in
//   bank l, so a warp's increments never conflict (an atomic add there
//   issues faster than a load, an add and a store).  Each warp then sums
//   a bin's 32 lanes with one redux.
// - More bins keep one copy of the bins per warp, counted with
//   shared-memory atomics (the first version's scheme).
// - Each block adds its totals to the output with one atomic add per bin.
//   The output is zero before the kernel runs, with no zeroing launch:
//   the wrapper hands each call, as its output, the buffer that the
//   previous call's kernel on the same stream zeroed, and each kernel
//   also zeroes the buffer the next call will get (kernels/histogram.py;
//   the first call on a stream, and one that needs more room than the
//   previous call left, zero their output with a launch of their own).
//   A design where each block took a ticket and the last block of a
//   plane folded a workspace into the output spent about 2.5 us of an
//   8.2 us call on that chain of dependent round trips to L2 (fence,
//   ticket, fold).  The call is one kernel on the device.  Integer counts
//   are exact in any order.
//
// At the fingerprint's one 1080p frame the call is about 2.5x the bound
// and 3 us above an empty kernel.  Timed variants split that: the loads
// alone (the frame sits in L2 across timed calls) take about 1 us over an
// empty kernel, the shared-memory counting about 2 us more, near one
// warp-wide shared atomic every two cycles an SM.  Cheaper-looking counts
// were slower there: plain load-add-store, uniform-run shortcuts (a warp
// diverges), packed counters in registers, and a pair-of-values table.
// On noise, where every block has all 16 bins, the blocks' one-lane
// atomic adds into the same output line cost about 2 us more.
//
// Exactness: x * s is one IEEE f32 multiply (no fast math); the truncating
// conversion is cvt.rzi.s32.f32 (__float2int_rz), which saturates and maps
// NaN to 0 as XLA's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;       // 16-byte loads per thread, all in flight
constexpr int kLaneBins = 32;  // lane-private counters up to this many bins
constexpr int kMaxBins = 1536;
constexpr int kDefaultSmem = 48 * 1024;

enum BinMode { kShift, kArith };

__device__ __forceinline__ int bin_of(float v, float scale, int bins) {
  return min(max(__float2int_rz(v * scale), 0), bins - 1);
}

template <typename T, int kMode, bool kLane>
struct Counter {
  int* mine;  // this lane's column, or this warp's copy of the bins
  float scale;
  int bins;
  int shift;

  __device__ __forceinline__ void add(int b) {
    atomicAdd(mine + (kLane ? b * 32 : b), 1);
  }

  __device__ __forceinline__ void value(T v) {
    if constexpr (kMode == kShift) {
      add((int)v >> shift);
    } else {
      add(bin_of((float)v, scale, bins));
    }
  }

  __device__ __forceinline__ void word(unsigned int w) {
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) value((uint8_t)(w >> (8 * k)));
    } else {
      value(__uint_as_float(w));
    }
  }

  __device__ __forceinline__ void vec(uint4 r) {
    word(r.x);
    word(r.y);
    word(r.z);
    word(r.w);
  }
};

template <typename T, int kMode, bool kLane>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const T* __restrict__ frames, int* __restrict__ out,
                 int* __restrict__ next, long long n_next,
                 long long plane_size, int bins, float scale, int shift) {
  // this block's vectors of its plane, in flight while the counters
  // are set up
  const long long plane = blockIdx.y;
  const T* src = frames + plane * plane_size;
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte vector
  long long head =
      (long long)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
      sizeof(T);
  if (head > plane_size) head = plane_size;
  const long long n_vec = (plane_size - head) / kPer;
  const uint4* body = reinterpret_cast<const uint4*>(src + head);
  const long long first =
      (long long)blockIdx.x * kThreads * kVecs + threadIdx.x;
  uint4 r[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (first + k * kThreads < n_vec) r[k] = __ldg(body + first + k * kThreads);
  }

  // the next call's output, zeroed for it
  const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
  for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                         kThreads + threadIdx.x;
       i < n_next; i += stride) {
    next[i] = 0;
  }

  extern __shared__ __align__(16) int counts[];
  const int n_counts = kLane ? kWarps * bins * 32 : kWarps * bins;
  for (int i = threadIdx.x; i < n_counts; i += kThreads) counts[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Counter<T, kMode, kLane> counter{
      counts + (kLane ? warp * bins * 32 + lane : warp * bins), scale, bins,
      shift};
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (first + k * kThreads < n_vec) counter.vec(r[k]);
  }
  if (blockIdx.x == 0) {  // the scalar head, then the tail, of the plane
    const long long tail_begin = head + n_vec * kPer;
    if (threadIdx.x < head) {
      counter.value(__ldg(src + threadIdx.x));
    } else if (threadIdx.x >= kPer &&
               threadIdx.x - kPer < plane_size - tail_begin) {
      counter.value(__ldg(src + tail_begin + threadIdx.x - kPer));
    }
  }
  __syncthreads();

  int* plane_out = out + plane * bins;
  if constexpr (kLane) {
    // i = bin * 32 + lane: each warp of the block sums one bin's columns
    for (int i = threadIdx.x; i < bins * 32; i += kThreads) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += counts[w * bins * 32 + i];
      s = __reduce_add_sync(0xffffffffu, s);
      if (lane == 0 && s) atomicAdd(plane_out + (i >> 5), s);
    }
  } else {
    for (int b = threadIdx.x; b < bins; b += kThreads) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += counts[w * bins + b];
      if (s) atomicAdd(plane_out + b, s);
    }
  }
}

template <typename T, int kMode, bool kLane>
int launch(const void* frames, int* out, int* next, long long n_next,
           int planes, long long plane_size, int bins, float scale,
           int shift, cudaStream_t s) {
  constexpr long long per_block = (long long)kThreads * kVecs * (16 / sizeof(T));
  long long blocks = (plane_size + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  const size_t smem =
      (size_t)(kLane ? kWarps * bins * 32 : kWarps * bins) * sizeof(int);
  auto kernel = histogram_kernel<T, kMode, kLane>;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned int)blocks, (unsigned int)planes), kThreads, smem,
           s>>>((const T*)frames, out, next, n_next, plane_size, bins, scale,
                shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest bin count the kernel takes (its per-warp copies of the bins
// take 48 KB of shared memory).
int vss_histogram_max_bins() { return kMaxBins; }

// Most bins counted in lane-private columns; more take per-warp copies.
int vss_histogram_lane_bins() { return kLaneBins; }

// Adds the histograms of `planes` planes of `plane_size` values into
// `out` (planes * bins int32, zero: the previous call zeroed it) and
// zeroes the `n_next` int32 of `next` for the next call.  `src_bytes`
// selects the input type: 1 = uint8, 4 = f32; for uint8 a `shift` of 0
// to 8 says that every byte's bin is byte >> shift, -1 that it is not
// (the bin is then the f32 arithmetic's).
// Returns the cudaError_t of the launch (0 on success).
int vss_histogram(const void* frames, int src_bytes, int* out, int* next,
                  long long n_next, int planes, long long plane_size, int bins,
                  float scale, int shift, void* stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool lane = bins <= kLaneBins;
  const auto args = [&](auto launcher) {
    return launcher(frames, out, next, n_next, planes, plane_size, bins,
                    scale, shift, s);
  };
  switch (src_bytes) {
    case 1:
      if (shift >= 0 && shift <= 8) {
        return lane ? args(launch<uint8_t, kShift, true>)
                    : args(launch<uint8_t, kShift, false>);
      }
      return lane ? args(launch<uint8_t, kArith, true>)
                  : args(launch<uint8_t, kArith, false>);
    case 4:
      return lane ? args(launch<float, kArith, true>)
                  : args(launch<float, kArith, false>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
