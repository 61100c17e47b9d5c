// Hand-written Hopper kernel for the per-frame sum of squared
// differences behind the quality model's MSE and PSNR (§3.2).
//
// Replaces the TPU kernel mse_sum_pallas (_mse_kernel) in
// src/repro/kernels/mse.py.  Semantics: src/repro/kernels/ref.py,
// mse_sum: out[n] = sum over (h, w) of (f32(a) - f32(b))^2, in f32.
//
// Bound: memory.  A subtraction, a multiply and an add per value
// against 2 (uint8) or 8 (f32) bytes read: the least time is the bytes
// of both inputs over 3.35 TB/s (thirty f32 1080p planes: 498 MB,
// 0.149 ms).
//
// Design: the TPU kernel carried one frame's sum in SMEM across its
// sequential grid of (8, 128) tiles.  Hopper's blocks run in no order,
// so a frame is cut into chunks of kChunk values: grid (chunks, N), each
// block sums its chunk (every thread a strided run of values, then a
// warp-shuffle tree and one partial per warp in shared memory) and
// writes one partial; a second pass, one block per frame, sums the
// partials in a fixed tree.  No float atomics, so the result is the same
// on every run.  Inputs are read in their own type and converted to f32
// in registers: uint8 frames are not widened on the host, and nothing
// is padded.  The sums run in another order than the plain version's,
// so agreement is within rounding (rtol 1e-5), not exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // values per block of the first pass

__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < 32) {
    total = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return total;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mse_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ partial, int64_t plane, int chunks) {
  __shared__ float warp_sums[kWarps];
  const int64_t n = blockIdx.y;
  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  const int64_t end = begin + kChunk < plane ? begin + kChunk : plane;
  const T* pa = a + n * plane;
  const T* pb = b + n * plane;
  float s = 0.0f;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const float d = (float)__ldg(pa + i) - (float)__ldg(pb + i);
    s += d * d;
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) partial[n * chunks + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
mse_final_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int chunks) {
  __shared__ float warp_sums[kWarps];
  const float* p = partial + (int64_t)blockIdx.x * chunks;
  float s = 0.0f;
  for (int i = threadIdx.x; i < chunks; i += kThreads) s += p[i];
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

int64_t chunks_of(int64_t plane) { return (plane + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// f32 partial sums the caller allocates for `frames` planes of `plane`
// values (the scratch of the first pass).
long long vss_mse_partials(int frames, long long plane) {
  return (long long)frames * chunks_of(plane);
}

// out[n] = sum of (a - b)^2 over plane n, for `frames` planes of `plane`
// values of type src_bytes (1 = uint8, 4 = f32), a and b of one type.
// `partial` holds vss_mse_partials(frames, plane) floats.  Returns the
// cudaError_t of the launches (0 on success).
int vss_mse_sum(const void* a, const void* b, int src_bytes, float* partial,
                float* out, int frames, long long plane, void* stream) {
  if (frames < 1 || frames > 65535 || plane < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = chunks_of(plane);
  if (chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned int)chunks, (unsigned int)frames);
  switch (src_bytes) {
    case 1:
      mse_partial_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)a, (const uint8_t*)b, partial, plane, (int)chunks);
      break;
    case 4:
      mse_partial_kernel<float><<<grid, kThreads, 0, s>>>(
          (const float*)a, (const float*)b, partial, plane, (int)chunks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mse_final_kernel<<<frames, kThreads, 0, s>>>(partial, out, (int)chunks);
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
