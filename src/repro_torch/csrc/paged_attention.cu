// Hand-written Hopper kernels for one-token decode attention over a paged
// KV pool: the serving engine's decode step, once per layer.
//
// Replaces the TPU kernel paged_decode_attention_pallas
// (_paged_attn_kernel) in src/repro/kernels/paged_attention.py, and the
// port's first version of this file, which ran one block per (KV head,
// sequence) and walked each sequence's tiles in series (64 blocks on 132
// SMs at Qwen3-32B's decode shape, each tile's loads waited on before
// its math).
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
// nearly 20 times below the card's ~295 per byte.  The least time is the
// bytes of q, the valid K/V rows and the output over 3.35 TB/s.  Tensor
// cores do not serve it at G <= 16: wgmma takes 64 rows (7/8 empty at
// G = 8, and mma.sync's 16 rows half empty) for work that is not
// arithmetic-bound, and the P.V product would round the f32 softmax
// weights to bf16, which one bf16 ulp of the f32 result does not allow.
// What the kernel needs is the bytes in flight on every SM.  What bounds
// it now is issue: with the copies pipelined, the math and its overhead
// (the lane reductions, the softmax, unfused multiply-adds under
// --fmad=false) take about as long as the whole kernel, some three times
// the bytes' bound at Qwen3-32B's decode shape.
//
// Design: split-KV (FlashDecoding) in two launches.
// 1. paged_split_kernel, grid (KV head x row chunk, sequence, split).
//    Each block owns up to R query rows of one group (R a power of two up
//    to 8) and a fixed range of `chunk` positions, a whole number of
//    tiles; the host fixes the split count from shapes alone (B, Hkv,
//    maxp * page, SM count) and never reads seq_lens.  A block whose
//    range lies past seq_lens[b] or only over absent pages writes an
//    empty partial (m = -inf) and returns.  It first lists each
//    position's pool row in shared memory (-1 where absent or past the
//    length).  The tiles' K and V rows are copied into a ring of 2 to 4
//    stages in shared memory with 16-byte cp.async.cg, a warp a few rows
//    at a time (the rows of a tile are scattered over pages, which suits
//    a per-row cp.async more than a TMA box), in their stored type,
//    converted to f32 at use; absent rows are zero-filled with the
//    src-size 0 form and masked, never read.  Tile t + stages - 1 is
//    issued before tile t is computed, behind one barrier per tile.
//    Each warp holds two rows (one where D > 256) of q and of the
//    accumulators in registers, a lane a pair of elements per 64, and
//    takes up to 32 positions of each tile; a multiply-add costs at most
//    one shared-memory load (the K or V pair, used for both rows).  The
//    rows x positions partial dots are reduced across lanes by a
//    transposing butterfly (31 shuffles for 32 scores), after which each
//    lane holds one score: the online softmax runs on lanes, and the
//    weights are broadcast by shuffles to the P.V loop.  Where warps
//    share a tile's positions, the block folds their (m, l, acc) in
//    order at the end; it writes one partial per row to the workspace.
// 2. paged_combine_kernel, one block per (sequence, query head), folds the
//    splits in split order: M = max m_s, w_s = expf(m_s - M) for each
//    split with m_s > -inf (an empty split is skipped, never weighted),
//    out = sum w_s acc_s / sum w_s l_s, rounded once to q's type
//    (__float2bfloat16_rn for bf16).  It runs even with one split.
// No float atomics: the same inputs give the same bits on every run.
// The workspace is the wrapper's (torch.empty); the kernels allocate
// nothing.
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;  // positions: every tile divides it
constexpr int kCombineThreads = 128;
constexpr size_t kRingBytes = 24 * 1024;  // what the ring aims at

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes from global to shared memory, or 16 zero bytes when src_bytes
// is 0 (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_for(int pending) {
  if (pending >= 2)
    cp_async_wait<2>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}
// two neighbouring values (an even index) as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *(const float2*)p;
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*(const __nv_bfloat162*)p);
}
// c ? a : b as a register select (a ?: of two array elements may become
// a select of their addresses, which puts the array in local memory)
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}
// Transposing butterfly over COUNT of a lane's N values: at offset O a
// lane keeps the half its lane bit O selects and adds its partner's copy
// of that half.  After log2(N) steps x[0] is value lane >> (5 - log2 N)
// summed over 2^log2(N) lanes, and the xor steps left sum it over all 32
// (identical on the lanes that hold it): 31 shuffles for 32 values.
template <int N, int COUNT, int O>
__device__ __forceinline__ void fold(float (&x)[N], int lane) {
  if constexpr (COUNT > 1) {
    constexpr int kHalf = COUNT / 2;
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float lo = x[i], hi = x[i + kHalf];
      const float send = pick(up, lo, hi);
      const float keep = pick(up, hi, lo);
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    fold<N, kHalf, O / 2>(x, lane);
  } else {
#pragma unroll
    for (int o = O; o > 0; o >>= 1)
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
  }
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}
__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }

// How a block's four warps share its R query rows (R a power of two) and
// a tile of positions, for NJ values of D per lane: each warp holds RW
// rows (two, or one where NJ > 8, of q and of the accumulators in
// registers) of one of WG row groups, and takes PW positions of a tile
// as one of PS position subsets, so that RW * PW <= 32 scores fold into
// one per lane (or one per 32 / (RW * PW) lanes).  A tile is PS * PW
// positions, at most kMaxTile, and fewer for rows so wide that a stage
// of K and V would pass kStageBytes (so that two stages fit D = 1024 in
// f32).
template <typename T, int R, int NJ>
struct Split {
  static constexpr int kStageBytes = 64 * 1024;
  static constexpr int RW = NJ <= 8 && R >= 2 ? 2 : 1;
  static constexpr int WG = R / RW;
  static constexpr int PS = kWarps / WG;
  static constexpr int TP_MAX = min_c(
      kMaxTile, kStageBytes / (2 * 32 * NJ * (int)sizeof(T)));
  static constexpr int PW = min_c(32 / RW, TP_MAX / PS);
  static constexpr int TP = PS * PW;
  static constexpr int N = RW * PW;
  static_assert(WG >= 1 && WG <= kWarps && N >= 1 && N <= 32, "shape");
};

// Shared memory, in bytes:
//   ring    stages x (K tile, V tile), each tile x DS values of T, DS =
//           32 NJ >= D (the tail of a row past D stays zero)
//   macc    PS x R x D f32   each position subset's accumulators at the end
//   mm, ml  PS x R f32       each position subset's running max and sum
//   rows    chunk int        each position's pool row (page * page size +
//                            slot), -1 if absent or past the length
struct Layout {
  int stages;
  size_t ring, macc, mml, rows, total;
};

__host__ __device__ Layout layout(int tile, int ps, int r, int ds, int d,
                                  int elem, int chunk) {
  Layout s;
  const size_t stage = 2 * (size_t)tile * ds * elem;
  s.stages = (int)(kRingBytes / stage);
  s.stages = s.stages < 2 ? 2 : s.stages > 4 ? 4 : s.stages;
  s.ring = s.stages * stage;
  s.macc = (size_t)ps * r * d * sizeof(float);
  s.mml = 2 * (size_t)ps * r * sizeof(float);
  s.rows = (size_t)chunk * sizeof(int);
  s.total = s.ring + s.macc + s.mml + s.rows;
  return s;
}

// A minimum of blocks per SM holds ptxas to the registers that many
// blocks leave a thread (128 at 4, 168 at 3): with no minimum it may take
// 64 and spill.
template <typename T, int R, int NJ>
__global__ void __launch_bounds__(kThreads,
                                  Split<T, R, NJ>::RW * NJ <= 16 ? 4 : 3)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ block_table,
                   const int* __restrict__ seq_lens, float* __restrict__ m_ws,
                   float* __restrict__ l_ws, float* __restrict__ acc_ws,
                   int hkv, int g, int d, int page, int maxp, int n_split,
                   int chunk, float scale) {
  using S = Split<T, R, NJ>;
  constexpr int RW = S::RW, PS = S::PS, PW = S::PW, TP = S::TP, N = S::N;
  constexpr int LOG_N = log2i(N);
  constexpr int DUP = 32 / N;         // lanes that end up with one score
  constexpr int ROW_LANES = 32 / RW;  // lanes that hold one row's scores
  constexpr int VEC = 16 / sizeof(T);

  constexpr int DS = 32 * NJ;  // a row's stride in the ring
  const Layout lay = layout(TP, PS, R, DS, d, sizeof(T), chunk);
  const int stages = lay.stages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = (T*)smem;
  float* macc = (float*)(smem + lay.ring);
  float* mm = (float*)(smem + lay.ring + lay.macc);
  float* ml = mm + PS * R;
  int* rows = (int*)(smem + lay.ring + lay.macc + lay.mml);

  const int n_rc = (g + R - 1) / R;
  const int h = blockIdx.x / n_rc;
  const int g0 = (blockIdx.x - h * n_rc) * R;
  const int r = min(R, g - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gw = (warp % S::WG) * RW;  // this warp's first row of the R
  const int ps = warp / S::WG;         // and its share of each tile
  const int hq = hkv * g;
  const int64_t row0 = (int64_t)b * hq + (int64_t)h * g + g0;  // (b, hq)

  const int64_t cap = (int64_t)maxp * page;
  const int n_pos = (int)min((int64_t)seq_lens[b], cap);
  const int start = split * chunk;
  const int end = min(start + chunk, n_pos);

  // an empty partial: nothing of this range is read
  auto empty = [&]() {
    for (int gi = tid; gi < r; gi += kThreads) {
      m_ws[(row0 + gi) * n_split + split] = -INFINITY;
      l_ws[(row0 + gi) * n_split + split] = 0.0f;
    }
  };
  if (start >= end) {
    empty();
    return;
  }
  int any = 0;
  for (int i = tid; i < chunk; i += kThreads) {
    const int pos = start + i;
    int row = -1;
    if (pos < end) {
      const int pid = block_table[(int64_t)b * maxp + pos / page];
      if (pid >= 0) row = pid * page + pos % page;
    }
    rows[i] = row;
    any |= row >= 0;
  }
  if (!__syncthreads_or(any)) {
    empty();
    return;
  }

  // this lane's share of the warp's query rows: the pairs of elements
  // elem(j) = 64 (j / 2) + 2 lane + j % 2, read as one 4- or 8-byte word
  float qr[RW][NJ];
#pragma unroll
  for (int gi = 0; gi < RW; ++gi)
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int e = 32 * j + 2 * lane;
      float2 v = make_float2(0.0f, 0.0f);
      if (gw + gi < r && e < d) v = load2(q + (row0 + gw + gi) * d + e);
      qr[gi][j] = v.x;
      qr[gi][j + 1] = v.y;
    }

  const int n_tiles = (end - start + TP - 1) / TP;
  const int per_row = d / VEC;
  constexpr int stage_elems = 2 * TP * DS;
  // rows narrower than DS: zero the ring once, so that the tail of each
  // row (never copied) holds 0 and the inner loops need no bound
  if (d != DS) {
    for (size_t i = tid; i < lay.ring / 16; i += kThreads)
      ((uint4*)smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  // a warp copies rpp rows at a time, a lane one 16-byte vector of one
  // (or, for rows of more than 32 vectors, every 32nd vector of a row)
  const int rpp = per_row >= 32 ? 1 : 32 / per_row;
  const int sub = lane / per_row;
  const int v0 = lane - sub * per_row;
  auto issue = [&](int t) {
    T* ks = ring + (t % stages) * stage_elems;
    T* vs = ks + TP * DS;
    if (sub >= rpp) return;
    for (int i = warp * rpp + sub; i < TP; i += kWarps * rpp) {
      const int row = rows[t * TP + i];
      const int64_t at = row >= 0 ? ((int64_t)row * hkv + h) * d : 0;
      const int bytes = row >= 0 ? 16 : 0;
      for (int v = v0; v < per_row; v += 32) {
        cp_async16(ks + i * DS + v * VEC, k_pages + at + v * VEC, bytes);
        cp_async16(vs + i * DS + v * VEC, v_pages + at + v * VEC, bytes);
      }
    }
  };

  // the lane's score after the butterfly: value v = gi * PW + pi
  const int v_lane = lane >> (5 - LOG_N);
  const int pi_lane = v_lane % PW;
  float m_run = -INFINITY, l_run = 0.0f;
  float acc[RW][NJ];
#pragma unroll
  for (int gi = 0; gi < RW; ++gi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[gi][j] = 0.0f;

  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_for(stages - 2);  // this thread's copies of tile t
    __syncthreads();  // everyone's copies of t; everyone done with t - 1
    if (t + stages - 1 < n_tiles) issue(t + stages - 1);  // t - 1's slot
    cp_async_commit();

    const T* ks = ring + (t % stages) * stage_elems + ps * PW * DS;
    const T* vs = ks + TP * DS;

    // partial dots of this lane's elements, value gi * PW + pi
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = 0.0f;
#pragma unroll
    for (int pi = 0; pi < PW; ++pi)
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const float2 kv = load2(ks + pi * DS + 32 * j + 2 * lane);
#pragma unroll
        for (int gi = 0; gi < RW; ++gi) {
          x[gi * PW + pi] += qr[gi][j] * kv.x;
          x[gi * PW + pi] += qr[gi][j + 1] * kv.y;
        }
      }
    fold<N, N, 16>(x, lane);

    const bool valid = rows[t * TP + ps * PW + pi_lane] >= 0;
    const float s = valid ? x[0] * scale : -INFINITY;

    // online softmax over the row's lanes (ROW_LANES of them, DUP per
    // position)
    float mx = s;
#pragma unroll
    for (int o = 1; o < ROW_LANES; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    // a row with nothing valid yet keeps 0 weights, never -inf - -inf
    const float base = m_new == -INFINITY ? 0.0f : m_new;
    const float p = expf(s - base);  // 0 for a masked position
    float sum = p;
#pragma unroll
    for (int o = DUP; o < ROW_LANES; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float alpha = expf(m_run - base);  // 0 while m_run is -inf
    l_run = l_run * alpha + sum;
    m_run = m_new;

    // rescale the accumulators, then add the weighted V rows
#pragma unroll
    for (int gi = 0; gi < RW; ++gi) {
      const float a = __shfl_sync(0xffffffffu, alpha, gi * ROW_LANES);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[gi][j] = acc[gi][j] * a;
    }
#pragma unroll
    for (int pi = 0; pi < PW; ++pi) {
      float pw[RW];
#pragma unroll
      for (int gi = 0; gi < RW; ++gi)
        pw[gi] = __shfl_sync(0xffffffffu, p, (gi * PW + pi) * DUP);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const float2 vv = load2(vs + pi * DS + 32 * j + 2 * lane);
#pragma unroll
        for (int gi = 0; gi < RW; ++gi) {
          acc[gi][j] += pw[gi] * vv.x;
          acc[gi][j + 1] += pw[gi] * vv.y;
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain

  // fold the position subsets' states in order into the block's partial
  if (lane % ROW_LANES == 0) {
    mm[ps * R + gw + lane / ROW_LANES] = m_run;
    ml[ps * R + gw + lane / ROW_LANES] = l_run;
  }
#pragma unroll
  for (int gi = 0; gi < RW; ++gi)
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int e = 32 * j + 2 * lane;
      if (e < d)
        *(float2*)(macc + (ps * R + gw + gi) * d + e) =
            make_float2(acc[gi][j], acc[gi][j + 1]);
    }
  __syncthreads();
  for (int i = tid; i < r * d; i += kThreads) {
    const int gi = i / d, e = i - gi * d;
    float mx = -INFINITY;
    for (int w = 0; w < PS; ++w) mx = fmaxf(mx, mm[w * R + gi]);
    float num = 0.0f, den = 0.0f;
    for (int w = 0; w < PS; ++w) {
      const float mw = mm[w * R + gi];
      if (mw == -INFINITY) continue;  // a subset that saw nothing valid
      const float wt = expf(mw - mx);
      num += wt * macc[(w * R + gi) * d + e];
      den += wt * ml[w * R + gi];
    }
    const int64_t at = (row0 + gi) * n_split + split;
    acc_ws[at * d + e] = num;
    if (e == 0) {
      m_ws[at] = mx;
      l_ws[at] = den;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ m_ws,
                     const float* __restrict__ l_ws,
                     const float* __restrict__ acc_ws, T* __restrict__ out,
                     int n_split, int d) {
  const int64_t row = blockIdx.x;  // b * Hq + hq
  const float* m = m_ws + row * n_split;
  const float* l = l_ws + row * n_split;
  const float* acc = acc_ws + row * n_split * d;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m[s]);
  // an empty split (m = -inf) is skipped by a select, not a branch, so
  // that the loads of eight splits are in flight together; its acc was
  // never written and is never used
  auto add_split = [&](float ms, float ls, float as, float& num, float& den) {
    const bool live = ms != -INFINITY;
    const float w = expf(live ? ms - mx : 0.0f);
    num += live ? w * as : 0.0f;
    den += live ? w * ls : 0.0f;
  };
  for (int e = threadIdx.x; e < d; e += kCombineThreads) {
    float num = 0.0f, den = 0.0f;
    int s = 0;
    for (; s + 8 <= n_split; s += 8) {
      float ms[8], ls[8], as[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ms[k] = m[s + k];
        ls[k] = l[s + k];
        as[k] = acc[(int64_t)(s + k) * d + e];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) add_split(ms[k], ls[k], as[k], num, den);
    }
    for (; s < n_split; ++s)
      add_split(m[s], l[s], acc[(int64_t)s * d + e], num, den);
    store(out + row * d + e, num / den);  // 0 / 0 = NaN for an empty row
  }
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const int *block_table, *seq_lens;
  void* out;
  float *m_ws, *l_ws, *acc_ws;
  int b, hkv, g, d, page, maxp, n_split, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, int R, int NJ>
int launch_split(const Args& a) {
  using S = Split<T, R, NJ>;
  const Layout lay =
      layout(S::TP, S::PS, R, 32 * NJ, a.d, sizeof(T), a.chunk);
  if (a.chunk % S::TP != 0) return (int)cudaErrorInvalidValue;
  auto kernel = paged_split_kernel<T, R, NJ>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_rc = (a.g + R - 1) / R;
  const dim3 grid((unsigned int)(a.hkv * n_rc), (unsigned int)a.b,
                  (unsigned int)a.n_split);
  kernel<<<grid, kThreads, lay.total, a.stream>>>(
      (const T*)a.q, (const T*)a.k_pages, (const T*)a.v_pages, a.block_table,
      a.seq_lens, a.m_ws, a.l_ws, a.acc_ws, a.hkv, a.g, a.d, a.page, a.maxp,
      a.n_split, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

// rows per block: a power of two up to min(G, 8), or 4 where a warp
// holds one row (D > 256)
template <typename T, int NJ>
int launch_rows(const Args& a) {
  constexpr int kMaxRows = NJ <= 8 ? 8 : 4;
  int r = 1;
  while (r < a.g && r < kMaxRows) r <<= 1;
  if (r == 1) return launch_split<T, 1, NJ>(a);
  if constexpr (kMaxRows >= 2)
    if (r == 2) return launch_split<T, 2, NJ>(a);
  if constexpr (kMaxRows >= 4)
    if (r == 4) return launch_split<T, 4, NJ>(a);
  if constexpr (kMaxRows >= 8)
    if (r == 8) return launch_split<T, 8, NJ>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const Args& a) {
  // 16-byte copies need rows of whole vectors on 16-byte boundaries
  if (a.d % (16 / (int)sizeof(T)) != 0 || (uintptr_t)a.k_pages % 16 != 0 ||
      (uintptr_t)a.v_pages % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err;
  if (a.d <= 128)
    err = launch_rows<T, 4>(a);
  else if (a.d <= 256)
    err = launch_rows<T, 8>(a);
  else if (a.d <= 512)
    err = launch_rows<T, 16>(a);
  else if (a.d <= 1024)
    err = launch_rows<T, 32>(a);
  else
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const unsigned int rows = (unsigned int)(a.b * a.hkv * a.g);
  paged_combine_kernel<T><<<rows, kCombineThreads, 0, a.stream>>>(
      a.m_ws, a.l_ws, a.acc_ws, (T*)a.out, a.n_split, a.d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, Hkv * G, D) = attention of q (B, Hkv * G, D) over the pages
// (P, page, Hkv, D) listed in block_table (B, maxp; -1 = absent) up to
// seq_lens (B,), in n_split splits of `chunk` positions (a multiple of
// 32, n_split * chunk >= maxp * page), through the f32 workspace
// m_ws, l_ws (B, Hq, n_split) and acc_ws (B, Hq, n_split, D).
// elem_bytes selects the type of q, the pages and out: 2 = bf16, 4 =
// f32.  D must be a whole number of 16-byte vectors, at most 1024, and
// the pages 16-byte aligned.  Two launches (split, combine); returns the
// first non-zero cudaError_t of them (0 on success); a D and page whose
// shared memory exceeds a block's 227 KB give the error of
// cudaFuncSetAttribute.
int vss_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, int elem_bytes,
                        const int* block_table, const int* seq_lens,
                        void* out, float* m_ws, float* l_ws, float* acc_ws,
                        int b, int hkv, int g, int d, int page, int maxp,
                        int n_split, int chunk, float scale, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || d < 1 || page < 1 || maxp < 1 ||
      b > 65535 || n_split < 1 || n_split > 65535 || chunk < 1 ||
      chunk % kMaxTile != 0 ||
      (int64_t)n_split * chunk < (int64_t)maxp * page)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, block_table, seq_lens, out,
               m_ws, l_ws, acc_ws, b, hkv, g, d, page, maxp, n_split, chunk,
               scale, (cudaStream_t)stream};
  if (elem_bytes == 2) return launch<__nv_bfloat16>(a);
  if (elem_bytes == 4) return launch<float>(a);
  return (int)cudaErrorInvalidValue;
}

const char* vss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
