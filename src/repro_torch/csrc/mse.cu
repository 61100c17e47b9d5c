// Hand-written Hopper kernel for the per-frame sum of squared
// differences behind the quality model's MSE and PSNR (§3.2).
//
// Replaces the TPU kernel mse_sum_pallas (_mse_kernel) in
// src/repro/kernels/mse.py.  Semantics: src/repro/kernels/ref.py,
// mse_sum: out[n] = sum over (h, w) of (f32(a) - f32(b))^2, in f32.
//
// Bound: memory.  A subtraction, a multiply and an add per value
// against 1 (uint8) or 4 (f32) bytes of each input: the least time is
// the bytes of both inputs over 3.35 TB/s (thirty uint8 1080p planes:
// 124 MB, 0.0371 ms; the main path's ninety (1080, 5760) uint8 planes:
// 1.12 GB, 0.334 ms; thirty f32 1080p planes: 498 MB, 0.149 ms).  The
// reads set the pace: without the squares it takes the same time.
//
// Design:
// - One cluster of C blocks a frame, grid (C, N): each block sums its
//   share of the frame, then block 0 of the cluster adds the C block
//   sums, in rank order, from the other blocks' shared memory
//   (distributed shared memory) and writes out[n].  One kernel a call:
//   no scratch, no atomics, nothing zeroed before it.
// - Loads of V bytes, U of them per input in flight per thread: V = 16
//   where a and b lie at one offset mod 16, 4 where mod 4, else 1
//   (uint8).  A frame's bytes before the first V-aligned address of a
//   (its head; b is then aligned too) and after its last whole vector
//   (its tail) are read one value at a time by the cluster's last block.
//   The wrapper plans V, U, C and the vectors a block takes (chunk) from
//   shapes and pointers alone (kernels/mse.py, plan); this file checks
//   the plan and refuses one it was not built for.
// - uint8 is summed exactly in integers: for a word of four bytes,
//   d = vabsdiff4(x, y) holds |x_i - y_i| per byte and dp4a(d, d) the
//   sum of their squares.  A thread's uint32 takes at most kCapValues
//   values before it is added into the thread's uint64: each loop step
//   moves it, and a step covers U * V <= 64.  Block and cluster sums are
//   uint64 (a frame of 2^31 values is under 1.4e14), and the frame's sum
//   is rounded to f32 once (__ull2float_rn): the correctly rounded true
//   sum, the same bits for any grid and on every run.  The plain version
//   rounds at every add of its f32 sum, so the two agree within its
//   rounding (rtol 1e-5), not exactly.
// - f32 is summed in f32 as before: sixteen accumulators a thread, then
//   warp, block and cluster sums in a fixed order, so a call repeats its
//   bits.  NaN and infinities propagate as in the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
// uint8 values a thread's uint32 may sum: 65536 * 255^2 < 2^32
constexpr long long kCapValues = 65536;
static_assert(kCapValues * 255 * 255 <= 0xffffffffLL, "uint32 overflows");

// vectors of V bytes a thread loads from each input in one loop step
__host__ __device__ constexpr int unroll_of(int vec) {
  return vec == 16 ? 4 : 16;
}

template <int V>
struct VecOf;
template <>
struct VecOf<16> { using type = uint4; };
template <>
struct VecOf<4> { using type = unsigned int; };
template <>
struct VecOf<1> { using type = unsigned char; };

// sum over the four bytes of (x_i - y_i)^2, exactly: |x_i - y_i| per
// byte, then their dot product with themselves (at most 4 * 255^2)
__device__ __forceinline__ unsigned int sq_diff4(unsigned int x,
                                                 unsigned int y) {
  const unsigned int d = __vabsdiffu4(x, y);
  return __dp4a(d, d, 0u);
}

// 16 bytes through the read-only path, not kept in L1 (every byte is
// read once) and with the L2 fetching its whole 256-byte line; narrower
// vectors take a plain read-only load
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
template <typename Vec>
__device__ __forceinline__ Vec ld_stream(const Vec* p) {
  return __ldg(p);
}

template <typename T, int V>
struct Acc;

template <int V>
struct Acc<uint8_t, V> {
  static_assert(unroll_of(V) * V <= kCapValues, "a step passes the cap");
  using Total = unsigned long long;
  Total total = 0;
  unsigned int step = 0;  // this loop step's sum, at most U * V values

  __device__ __forceinline__ void add(int, uint4 x, uint4 y) {
    step += sq_diff4(x.x, y.x) + sq_diff4(x.y, y.y) + sq_diff4(x.z, y.z) +
            sq_diff4(x.w, y.w);
  }
  __device__ __forceinline__ void add(int, unsigned int x, unsigned int y) {
    step += sq_diff4(x, y);
  }
  __device__ __forceinline__ void add(int, unsigned char x,
                                      unsigned char y) {
    const int d = (int)x - (int)y;
    step += (unsigned int)(d * d);
  }
  __device__ __forceinline__ void end_step() {
    total += step;
    step = 0;
  }
  __device__ __forceinline__ Total result() const { return total; }
  __device__ static float to_f32(Total s) { return __ull2float_rn(s); }
};

template <int V>
struct Acc<float, V> {
  static constexpr int kSlots = unroll_of(V) * (V / 4);  // one a float
  using Total = float;
  float s[kSlots] = {};

  __device__ __forceinline__ static float sq(unsigned int x, unsigned int y) {
    const float d = __uint_as_float(x) - __uint_as_float(y);
    return d * d;
  }
  __device__ __forceinline__ void add(int u, uint4 x, uint4 y) {
    s[4 * u] += sq(x.x, y.x);
    s[4 * u + 1] += sq(x.y, y.y);
    s[4 * u + 2] += sq(x.z, y.z);
    s[4 * u + 3] += sq(x.w, y.w);
  }
  __device__ __forceinline__ void add(int u, unsigned int x, unsigned int y) {
    s[u] += sq(x, y);
  }
  __device__ __forceinline__ void end_step() {}
  __device__ __forceinline__ Total result() const {
    float r[kSlots / 2];
#pragma unroll
    for (int i = 0; i < kSlots / 2; ++i) r[i] = s[i] + s[i + kSlots / 2];
#pragma unroll
    for (int w = kSlots / 4; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) r[i] += r[i + w];
    return r[0];
  }
  __device__ static float to_f32(Total s) { return s; }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
mse_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           float* __restrict__ out, long long plane_bytes, long long chunk) {
  using Vec = typename VecOf<V>::type;
  // a value of the head and the tail: one byte, or one float's bits
  using Scalar = typename std::conditional<sizeof(T) == 1, unsigned char,
                                           unsigned int>::type;
  using Total = typename Acc<T, V>::Total;
  constexpr int U = unroll_of(V);
  constexpr long long S = sizeof(T);
  __shared__ Total warp_sums[kWarps];
  __shared__ Total block_sum;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const unsigned int ranks = cluster.num_blocks();
  const long long n = blockIdx.y;
  const uint8_t* fa = a + n * plane_bytes;
  const uint8_t* fb = b + n * plane_bytes;
  long long head = (long long)((0u - (unsigned int)(uintptr_t)fa) & (V - 1));
  head = head < plane_bytes ? head : plane_bytes;
  const long long nvec = (plane_bytes - head) / V;
  const long long tail = plane_bytes - head - nvec * V;
  const Vec* va = reinterpret_cast<const Vec*>(fa + head);
  const Vec* vb = reinterpret_cast<const Vec*>(fb + head);

  Acc<T, V> acc;
  const long long begin = rank * chunk;
  const long long end = begin + chunk < nvec ? begin + chunk : nvec;
  long long i = begin + threadIdx.x;
  for (; i + (U - 1) * kThreads < end; i += U * kThreads) {
    Vec x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x[u] = ld_stream(va + i + u * kThreads);
      y[u] = ld_stream(vb + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc.add(u, x[u], y[u]);
    acc.end_step();
  }
  for (; i < end; i += kThreads) {
    acc.add(0, __ldg(va + i), __ldg(vb + i));
    acc.end_step();
  }
  if (rank == ranks - 1) {
    const long long t = threadIdx.x;
    if (t < head / S)
      acc.add(0, __ldg(reinterpret_cast<const Scalar*>(fa) + t),
              __ldg(reinterpret_cast<const Scalar*>(fb) + t));
    const long long at = plane_bytes - tail;
    if (t < tail / S)
      acc.add(0, __ldg(reinterpret_cast<const Scalar*>(fa + at) + t),
              __ldg(reinterpret_cast<const Scalar*>(fb + at) + t));
    acc.end_step();
  }

  Total v = acc.result();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    Total s = warp_sums[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w];
    block_sum = s;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    Total s = *cluster.map_shared_rank(&block_sum, 0);
    for (unsigned int r = 1; r < ranks; ++r)
      s += *cluster.map_shared_rank(&block_sum, r);
    out[n] = Acc<T, V>::to_f32(s);
  }
  // no block leaves while block 0 may still read its shared memory
  cluster.sync();
}

template <typename T, int V>
cudaError_t launch(const void* a, const void* b, float* out, int frames,
                   long long plane_bytes, int cluster, long long chunk,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)cluster, (unsigned int)frames, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mse_kernel<T, V>,
                            (const uint8_t*)a, (const uint8_t*)b, out,
                            plane_bytes, chunk);
}

}  // namespace

extern "C" {

// out[n] = sum of (a - b)^2 over plane n, for `frames` planes of `plane`
// values of src_bytes each (1 = uint8, 4 = f32), a and b of one type,
// with the wrapper's plan: `vec`-byte loads, `unroll` of them a step,
// clusters of `cluster` blocks, `chunk` vectors a block.  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for
// a plan this file was not built for or one that leaves values out.
int vss_mse_sum(const void* a, const void* b, int src_bytes, float* out,
                int frames, long long plane, int vec, int unroll,
                int cluster, long long chunk, void* stream) {
  if (frames < 1 || frames > 65535 || plane < 1)
    return (int)cudaErrorInvalidValue;
  if ((src_bytes != 1 && src_bytes != 4) ||
      (vec != 1 && vec != 4 && vec != 16) || vec < src_bytes ||
      unroll != unroll_of(vec))
    return (int)cudaErrorInvalidValue;
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
  if (pa % src_bytes || (pa - pb) % vec) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const long long plane_bytes = plane * src_bytes;
  if (chunk < 1 || chunk * cluster < plane_bytes / vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (src_bytes == 1)
    err = vec == 16 ? launch<uint8_t, 16>(a, b, out, frames, plane_bytes,
                                          cluster, chunk, s)
        : vec == 4  ? launch<uint8_t, 4>(a, b, out, frames, plane_bytes,
                                         cluster, chunk, s)
                    : launch<uint8_t, 1>(a, b, out, frames, plane_bytes,
                                         cluster, chunk, s);
  else
    err = vec == 16 ? launch<float, 16>(a, b, out, frames, plane_bytes,
                                        cluster, chunk, s)
                    : launch<float, 4>(a, b, out, frames, plane_bytes,
                                       cluster, chunk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
