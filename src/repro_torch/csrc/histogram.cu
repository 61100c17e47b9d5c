// Hand-written Hopper kernel for the per-(frame, channel) histograms of
// joint compression's GOP fingerprints (§5.1.3).
//
// Replaces the TPU kernel histogram_pallas (_hist_kernel) in
// src/repro/kernels/histogram.py.  Semantics: src/repro/kernels/ref.py,
// histogram: a value x falls in bin clip(int32(x * s), 0, bins - 1) with
// s = f32(bins / (vmax + 1)), counted per (frame, channel) into int32.
//
// Bound: memory.  One multiply, one conversion and one shared-memory add
// per value against 1 (uint8) or 4 (f32) bytes read: the least time is
// the input bytes over 3.35 TB/s (one 1080p RGB frame in uint8, 6.2 MB:
// 1.9 us; in f32 7.4 us).  At the fingerprint's one frame a launch costs
// more than that.
//
// Design: the TPU has no atomic scatter, so its kernel counts with one
// masked compare-and-sum per bin over (8, 128) tiles.  Hopper has fast
// shared-memory atomics: grid.y is the (frame, channel) plane, and each
// block of a plane counts a contiguous chunk of it into per-warp copies
// of the bins in shared memory (so the warps of a block do not contend
// on one copy), then adds its totals to the global (N, C, bins) output
// with one atomicAdd per bin.  The wrapper zeroes the output first.
// Integer counts are exact in any order.
//
// Exactness: x * s is one IEEE f32 multiply (no fast math); the truncating
// conversion is cvt.rzi.s32.f32 (__float2int_rz), which saturates and maps
// NaN to 0 as XLA's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// values each block counts: enough per block to amortise its flush of
// the bins, few enough to spread one 1080p plane over ~500 blocks
constexpr int kChunk = kThreads * 16;

template <typename T>
__global__ void histogram_kernel(const T* __restrict__ frames,
                                 int* __restrict__ out, int64_t plane_size,
                                 int bins, float scale) {
  extern __shared__ int counts[];  // kWarps * bins
  for (int i = threadIdx.x; i < kWarps * bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const int64_t plane = blockIdx.y;
  const T* src = frames + plane * plane_size;
  int* mine = counts + (threadIdx.x / 32) * bins;
  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  const int64_t end =
      begin + kChunk < plane_size ? begin + kChunk : plane_size;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const float v = (float)__ldg(src + i) * scale;
    const int b = min(max(__float2int_rz(v), 0), bins - 1);
    atomicAdd(mine + b, 1);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += counts[k * bins + b];
    if (total) atomicAdd(out + plane * bins + b, total);
  }
}

}  // namespace

extern "C" {

// Largest bin count the kernel takes: its per-warp bins must fit the
// 48 KB of shared memory a block gets without opting in.
int vss_histogram_max_bins() { return (48 * 1024) / (kWarps * 4); }

// Adds the histograms of `planes` planes of `plane_size` values into
// `out` (planes * bins int32, zeroed by the caller).  `src_bytes`
// selects the input type: 1 = uint8, 4 = f32.  Returns the cudaError_t
// of the launch (0 on success).
int vss_histogram(const void* frames, int src_bytes, int* out, int planes,
                  long long plane_size, int bins, float scale, void* stream) {
  if (bins < 1 || bins > vss_histogram_max_bins())
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((plane_size + kChunk - 1) / kChunk),
                  (unsigned int)planes);
  const dim3 block(kThreads);
  const size_t smem = (size_t)kWarps * bins * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  switch (src_bytes) {
    case 1:
      histogram_kernel<uint8_t><<<grid, block, smem, s>>>(
          (const uint8_t*)frames, out, plane_size, bins, scale);
      break;
    case 4:
      histogram_kernel<float><<<grid, block, smem, s>>>(
          (const float*)frames, out, plane_size, bins, scale);
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
