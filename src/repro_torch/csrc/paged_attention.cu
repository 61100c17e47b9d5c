// Hand-written Hopper kernel for one-token decode attention over a paged
// KV pool: the serving engine's decode step, once per layer.
//
// Replaces the TPU kernel paged_decode_attention_pallas
// (_paged_attn_kernel) in src/repro/kernels/paged_attention.py.
// Semantics: src/repro/kernels/ref.py, paged_decode_attention: for each
// sequence b and query head hq (KV head hq / G, G = Hq / Hkv), the scores
// dot(q, k_pos) * scale over the positions pos < seq_lens[b] whose page
// block_table[b, pos / page] is not -1, a softmax over them and the
// weighted sum of the V rows, all in f32, stored once in q's type.  A row
// with no valid position is 0 / 0 = NaN, as the reference's softmax over
// nothing but -inf gives (its Pallas kernel writes 0 there instead).
//
// Bound: memory.  Every valid K and V row is read once (2 * D values per
// position and KV head) against 4 * G * D f32 operations per position
// and KV head: at Qwen3-32B's G = 8 that is 16 operations per bf16 value,
// far below the card's ~300 per byte.  The least time is the bytes of q,
// the valid K/V rows and the output over 3.35 TB/s.
//
// Design (simple first; split-KV, wgmma and TMA are later work): one
// block per (KV head, sequence) holds the G query rows of its group in
// shared memory and walks the sequence in tiles of 32 positions, which
// may span pages.  Per tile it looks up each position's page, stages the
// tile's K and V rows in shared memory as f32 (16-byte loads, so D is a
// whole number of 16-byte vectors, as every configured head width is;
// four in flight per thread, so one tile costs about one memory latency;
// rows past seq_len or on an absent page are not read and are zero), forms
// the G x 32 scores (a row stride of D + 1 keeps the dot products free
// of bank conflicts), and folds them into a running max, sum and
// accumulator per query row (online softmax, one warp per query row, one
// lane per position).  The accumulator stays in shared memory, so D is a
// run-time parameter (Phi-3's 96, Qwen3's 128).  A single store at the
// end divides by the sum and rounds to nearest-even (__float2bfloat16_rn
// for bf16).
//
// Exactness: expf, not __expf; the build forbids fast math and the
// contraction of a * b + c (--fmad=false), so each product and sum is
// the IEEE f32 one.  The order of the sums differs from the plain
// version's matrix products, so agreement is within tolerance, not exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // positions per tile: one warp lane each
constexpr int kLoads = 4;  // 16-byte vectors each thread has in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory, in floats unless said otherwise:
//   qs   G x (D + 1)      the group's query rows
//   ks   kTile x (D + 1)  the tile's K rows
//   vs   kTile x D        the tile's V rows
//   ps   G x kTile        scores, then their exponentials
//   acc  G x D            running numerators
//   m, l, alpha  G each   running max, running sum, this tile's rescale
//   rows kTile int64      element offset of each position's K/V row, or -1
size_t smem_bytes(int g, int d) {
  const size_t floats = (size_t)g * (d + 1) + (size_t)kTile * (d + 1) +
                        (size_t)kTile * d + (size_t)g * kTile +
                        (size_t)g * d + 3 * (size_t)g;
  return ((floats * sizeof(float) + 7) / 8) * 8 + kTile * sizeof(int64_t);
}

// A minimum of one block per SM lets ptxas use the registers the tile
// loop needs: with no minimum it held the kernel to 64 and spilled.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const T* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens,
                       T* __restrict__ out, int hkv, int g, int d, int page,
                       int maxp, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + (size_t)g * (d + 1);
  float* vs = ks + (size_t)kTile * (d + 1);
  float* ps = vs + (size_t)kTile * d;
  float* acc = ps + (size_t)g * kTile;
  float* m = acc + (size_t)g * d;
  float* l = m + g;
  float* alpha = l + g;
  const size_t float_bytes =
      ((((size_t)(alpha + g - smem)) * sizeof(float) + 7) / 8) * 8;
  int64_t* rows = (int64_t*)((char*)smem + float_bytes);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * g;
  const T* qb = q + ((int64_t)b * hq + (int64_t)h * g) * d;

  for (int e = tid; e < g * d; e += kThreads) {
    const int gi = e / d, di = e - gi * d;
    qs[gi * (d + 1) + di] = to_f32(qb[e]);
    acc[e] = 0.0f;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m[gi] = -INFINITY;
    l[gi] = 0.0f;
  }
  const int64_t cap = (int64_t)maxp * page;
  const int n_pos = (int)min((int64_t)seq_lens[b], cap);
  const int* bt = block_table + (int64_t)b * maxp;

  for (int t0 = 0; t0 < n_pos; t0 += kTile) {
    // 1. each position's K/V row (or -1: past seq_len or an absent page)
    int valid = 0;
    if (tid < kTile) {
      const int pos = t0 + tid;
      int64_t row = -1;
      if (pos < n_pos) {
        const int pid = bt[pos / page];
        if (pid >= 0)
          row = (((int64_t)pid * page + pos % page) * hkv + h) * d;
      }
      rows[tid] = row;
      valid = row >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // a tile of absent pages

    // 2. stage the tile's K and V rows as f32; rows not read are zero.
    // Each thread loads up to kLoads 16-byte vectors before it stores any,
    // so their latencies overlap (the caller checks that rows are whole
    // vectors on 16-byte boundaries).
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = d / kVec;
    for (int e0 = tid; e0 < kTile * per_row; e0 += kThreads * kLoads) {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int e = e0 + j * kThreads;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (e < kTile * per_row) {
          const int i = e / per_row;
          const int64_t row = rows[i];
          if (row >= 0) {
            const int64_t at = row + (int64_t)(e - i * per_row) * kVec;
            kr[j] = __ldg((const uint4*)(k_pages + at));
            vr[j] = __ldg((const uint4*)(v_pages + at));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int e = e0 + j * kThreads;
        if (e >= kTile * per_row) break;
        const int i = e / per_row, di = (e - i * per_row) * kVec;
        const T* kv = (const T*)&kr[j];
        const T* vv = (const T*)&vr[j];
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          ks[i * (d + 1) + di + c] = to_f32(kv[c]);
          vs[i * d + di + c] = to_f32(vv[c]);
        }
      }
    }
    __syncthreads();

    // 3. scores: one (query row, position) pair per thread at a time
    for (int e = tid; e < g * kTile; e += kThreads) {
      const int gi = e / kTile, i = e - gi * kTile;
      float s = -INFINITY;
      if (rows[i] >= 0) {
        const float* qr = qs + gi * (d + 1);
        const float* kr = ks + i * (d + 1);
        float dot = 0.0f;
        for (int di = 0; di < d; ++di) dot += qr[di] * kr[di];
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    // 4. online softmax: one warp per query row, one lane per position
    for (int gi = warp; gi < g; gi += kWarps) {
      const float s = ps[gi * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[gi];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a row
      const float p = expf(s - m_new);       // 0 for a masked position
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[gi * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        alpha[gi] = a;
        l[gi] = l[gi] * a + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();

    // 5. rescale the numerators and add this tile's weighted V rows
    for (int e = tid; e < g * d; e += kThreads) {
      const int gi = e / d, di = e - gi * d;
      const float* pr = ps + gi * kTile;
      float a = acc[e] * alpha[gi];
      for (int i = 0; i < kTile; ++i) a += pr[i] * vs[i * d + di];
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((int64_t)b * hq + (int64_t)h * g) * d;
  for (int e = tid; e < g * d; e += kThreads)
    store(ob + e, acc[e] / l[e / d]);  // 0 / 0 = NaN for an empty row
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* seq_lens, void* out, int b,
           int hkv, int g, int d, int page, int maxp, float scale,
           cudaStream_t stream) {
  // 16-byte loads need rows of whole vectors on 16-byte boundaries
  if (d % (16 / (int)sizeof(T)) != 0 || (uintptr_t)k_pages % 16 != 0 ||
      (uintptr_t)v_pages % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g, d);
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned int)hkv, (unsigned int)b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, block_table,
      seq_lens, (T*)out, hkv, g, d, page, maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Hkv * G, D) = attention of q (B, Hkv * G, D) over the pages
// (P, page, Hkv, D) listed in block_table (B, maxp; -1 = absent) up to
// seq_lens (B,).  elem_bytes selects the type of q, the pages and out:
// 2 = bf16, 4 = f32.  D must be a whole number of 16-byte vectors and the
// pages 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success); a G and D whose shared memory exceeds a block's 227 KB give
// the error of cudaFuncSetAttribute.
int vss_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, int elem_bytes,
                        const int* block_table, const int* seq_lens,
                        void* out, int b, int hkv, int g, int d, int page,
                        int maxp, float scale, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || d < 1 || page < 1 || maxp < 1 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, seq_lens,
                                 out, b, hkv, g, d, page, maxp, scale, s);
  if (elem_bytes == 4)
    return launch<float>(q, k_pages, v_pages, block_table, seq_lens, out, b,
                         hkv, g, d, page, maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
