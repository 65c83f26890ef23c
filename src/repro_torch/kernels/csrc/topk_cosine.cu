// Cosine top-k for Hopper (sm_90a): one slab step of the serving top-k.
//
// Replaces the TPU kernel src/repro/kernels/topk_similarity.py::
// topk_cosine_pallas (kernel body _topk_kernel) together with the merge
// step of src/repro/kernels/ops.py::_topk_stream.  The Pallas grid walks
// the table one slab at a time on one core; here the slab is split into
// 64-row blocks x 4-64-query tiles, so every SM gets blocks, and the
// per-block results are merged by a later launch.
//
// Contract of one step (plain version: kernels/ref.py::stream_step_ref):
//   score = q . (e / max(norm, 1e-12)), fp32 accumulation, no TF32;
//   columns >= limit and each query's excluded column score -1e30;
//   result = the k best of (running list + slab), ordered by score
//   descending, then by global index ascending.  The running list is
//   sorted (every step's result is).
//
// Ordering trick: every candidate is one 64-bit key,
//   (order-preserving bits of the score) << 32 | (0xFFFFFFFF - index),
// so "larger key" is exactly "better candidate", ties go to the lower
// index for free, and the keys of one slab never repeat (a running list
// may repeat its sentinel (-1e30, 0); equal keys decode alike).  Key 0
// means "nothing" (a row past the slab) and decodes to the sentinel.
//
// What bounds it on an H100: on the serving path the slab has just come
// over PCIe, so the step reads it once from HBM (rows*d*4 bytes) and does
// 2*Q*rows*d fp32 operations on the CUDA cores: Q/2 operations per byte,
// 32 at Q = 64.  The fp32 ridge of the card is 67 TFLOP/s over 3.35 TB/s
// = 20, so a full batch is bound by the fp32 rate, a small one by HBM.
// Both paths score with one scorer (score_block): 64-row blocks whose
// threads keep a stage's slab loads in flight together, each slab column
// read into shared memory once per 4-64 queries, 1-16 partial sums per
// thread in registers.
//
// k <= 64 (the paper's k = 10) takes two launches, and the (Q, rows)
// scores never reach device memory:
//   1. score and select: the block's scores go through shared memory to
//      one warp per query, which sorts the 64 keys in registers (a
//      bitonic network, two keys a lane) and writes the best min(k, 64),
//      sorted: ceil(rows / 64) runs of candidates per query;
//   2. merge lists: one block per query streams its runs, each warp
//      keeping its best 64 in registers and dropping, after one load, a
//      run whose head cannot enter its first k; then the warps' lists
//      meet pairwise (bitonic merges).  Each candidate is read once.
//
// k > 64 (up to N) takes three stages, and the running list is never
// sorted again:
//   1. score: one key per slab row and query into scratch (Q x rows);
//   2. select and sort: one block per (sub-slab of <= SORT_CAP rows,
//      query) holds the sub-slab's keys in registers, finds the m-th
//      largest key (m = min(k, sub-slab rows)) by a radix select over its
//      8 bytes, compacts the m survivors into shared memory and sorts only
//      them (64-key runs in registers, then merge rounds);
//   3. merge path: the sorted running list and one sub-slab's sorted keys
//      are merged into the first k; each block finds its two split points
//      by binary search along its output diagonal and places its tile's
//      entries by rank.  One launch per sub-slab (one per streamed slab).
// A streamed slab step is 3 launches; a device-resident call over N rows
// is 2 + ceil(N / SORT_CAP).
//
// Every entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int SR = 64;            // slab rows per scoring block
constexpr int SCORE_THREADS = 256;
constexpr int SORT_CAP = 8192;    // keys of one sub-slab (large k)
constexpr int SORT_THREADS = 1024;
constexpr int SORT_KPT = SORT_CAP / SORT_THREADS;  // keys per thread
constexpr int MERGE_TILE = 256;   // outputs per merge-path block (threads)
constexpr int LIST_MERGE_THREADS = 1024;  // most threads of a list merge
constexpr float NEG_INF = -1e30f;

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(float s, int idx) {
  s = (s == 0.0f) ? 0.0f : s;     // -0 and +0 are one score
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (unsigned)idx);
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// Sorts the 64 keys a warp holds, two a lane (v0, v1 at positions
// 2 lane and 2 lane + 1), descending: a bitonic network over shuffles, no
// barriers.
__device__ __forceinline__ void warp_sort64(u64& v0, u64& v1) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
    const bool desc = ((2 * lane) & size) == 0;
#pragma unroll
    for (int o = size / 4; o > 0; o >>= 1) {     // stride 2 * o: lane ^ o
      const u64 w0 = __shfl_xor_sync(0xffffffffu, v0, o);
      const u64 w1 = __shfl_xor_sync(0xffffffffu, v1, o);
      const bool keep_max = ((lane & o) == 0) == desc;
      v0 = keep_max ? (w0 > v0 ? w0 : v0) : (w0 < v0 ? w0 : v0);
      v1 = keep_max ? (w1 > v1 ? w1 : v1) : (w1 < v1 ? w1 : v1);
    }
    if ((v0 < v1) == desc) {                     // stride 1, in the lane
      const u64 x = v0;
      v0 = v1;
      v1 = x;
    }
  }
}

// (v0, v1) becomes the best 64 of two descending 64-key runs held as
// warp_sort64 leaves them, (v0, v1) and (b0, b1), descending: the larger
// of a[p] and b[63 - p] is the top half of the union as a bitonic
// sequence, and a bitonic merge sorts it.
__device__ __forceinline__ void warp_merge64(u64& v0, u64& v1, u64 b0,
                                             u64 b1) {
  const int lane = threadIdx.x % 32;
  const u64 r0 = __shfl_sync(0xffffffffu, b1, 31 - lane);  // b[63 - 2 lane]
  const u64 r1 = __shfl_sync(0xffffffffu, b0, 31 - lane);  // b[62 - 2 lane]
  v0 = r0 > v0 ? r0 : v0;
  v1 = r1 > v1 ? r1 : v1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w0 = __shfl_xor_sync(0xffffffffu, v0, o);
    const u64 w1 = __shfl_xor_sync(0xffffffffu, v1, o);
    const bool keep_max = (lane & o) == 0;
    v0 = keep_max ? (w0 > v0 ? w0 : v0) : (w0 < v0 ? w0 : v0);
    v1 = keep_max ? (w1 > v1 ? w1 : v1) : (w1 < v1 ? w1 : v1);
  }
  if (v0 < v1) {
    const u64 x = v0;
    v0 = v1;
    v1 = x;
  }
}

// Shared memory of one scoring block: the transposed slab tile, the
// queries' tile and the rows' norms while it scores; its scores, query
// by query, after.
template <int QPT, int SD>
struct ScoreSmem {
  static constexpr int KQ = 4 * QPT;                  // queries per block
  static constexpr int QP = KQ + (QPT >= 4 ? 4 : 1);  // float4 rows if QPT >= 4
  static_assert(KQ * SR <= SD * (SR + 1), "scores must fit the slab tile");
  float es[SD * (SR + 1)];
  alignas(16) float qs[SD * QP];
  float nrm[SR];
};

// The scorer of both paths.  Block (x, y) scores slab rows x * SR ..
// + SR against queries y * KQ .. + KQ, KQ = 4 * QPT; thread (group g,
// row r) ends with the scores of row r for queries g * QPT .. + QPT in
// acc[], masked: -1e30 for columns >= limit, each query's excluded
// column and queries past Q.  Each stage issues all of its SD columns'
// loads (SR * SD / 256 floats of the slab per thread) before it stores
// any, so a block has 16-32 KB in flight, and SR = 64 rows per block
// puts a block on every SM for an 8192-row slab.  SD is 128 columns (two
// stages at d = 200) at QPT = 4, else 64: at QPT = 16 the queries' tile
// must fit 48 KB of shared memory, and at QPT = 1 a 128-column stage
// holds a thread at 226 registers, one block an SM, which measured 2.7x
// slower on an H100 over a 100k-row table than 64 columns.  QPT
// follows Q (1, 4 or 16), so a single query wastes no threads' work and
// a batch of 64 shares each shared slab column among 16 sums.  All
// threads call it (it synchronises); on return the block's shared memory
// is free.
template <int QPT, int SD>
__device__ __forceinline__ void score_block(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, ScoreSmem<QPT, SD>& sm, float (&acc)[QPT]) {
  constexpr int KQ = ScoreSmem<QPT, SD>::KQ, QP = ScoreSmem<QPT, SD>::QP;
  constexpr int EPT = SR * SD / SCORE_THREADS;  // slab floats per thread
  constexpr int QPTL = KQ * SD / SCORE_THREADS; // query floats per thread
  float* es = sm.es;
  float* qs = sm.qs;
  const int tid = threadIdx.x, row = tid % SR, grp = tid / SR;
  const int r0 = blockIdx.x * SR, q0 = blockIdx.y * KQ;
  const int nr = min(SR, rows - r0), nq = min(KQ, Q - q0);
  const bool busy = grp * QPT < nq;             // uniform per warp
  if (tid < SR)
    sm.nrm[tid] = (norms != nullptr && tid < nr) ? fmaxf(norms[r0 + tid], 1e-12f)
                                                 : 1.0f;
#pragma unroll
  for (int i = 0; i < QPT; ++i) acc[i] = 0.0f;
  __syncthreads();
  for (int c0 = 0; c0 < d; c0 += SD) {
    const int dc = min(SD, d - c0);
    float ev[EPT], qv[QPTL];
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = u * SCORE_THREADS + tid, r = e / SD, c = e % SD;
      ev[u] = (r < nr && c < dc) ? tbl[(long long)(r0 + r) * stride + c0 + c]
                                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < QPTL; ++u) {
      const int e = u * SCORE_THREADS + tid, i = e / SD, c = e % SD;
      qv[u] = (i < nq && c < dc) ? q[(long long)(q0 + i) * d + c0 + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = u * SCORE_THREADS + tid, r = e / SD, c = e % SD;
      es[c * (SR + 1) + r] = norms != nullptr ? ev[u] / sm.nrm[r] : ev[u];
    }
#pragma unroll
    for (int u = 0; u < QPTL; ++u) {
      const int e = u * SCORE_THREADS + tid, i = e / SD, c = e % SD;
      qs[c * QP + i] = qv[u];
    }
    __syncthreads();
    if (busy) {
#pragma unroll 8                    // shared loads ahead of the FMA chain
      for (int c = 0; c < dc; ++c) {
        const float ec = es[c * (SR + 1) + row];
        if constexpr (QPT >= 4) {
#pragma unroll
          for (int i = 0; i < QPT; i += 4) {
            const float4 qq =
                *reinterpret_cast<const float4*>(&qs[c * QP + grp * QPT + i]);
            acc[i] = fmaf(qq.x, ec, acc[i]);
            acc[i + 1] = fmaf(qq.y, ec, acc[i + 1]);
            acc[i + 2] = fmaf(qq.z, ec, acc[i + 2]);
            acc[i + 3] = fmaf(qq.w, ec, acc[i + 3]);
          }
        } else {
          acc[0] = fmaf(qs[c * QP + grp], ec, acc[0]);
        }
      }
    }
    __syncthreads();
  }
  const int col = offset + r0 + row;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + grp * QPT + i;
    const bool live = qi < Q && col < limit && col != excl[qi];
    acc[i] = live ? acc[i] : NEG_INF;
  }
}

// Small k, stage 1: score (score_block), then each query's best kc
// (<= 64) keys of the block's 64 rows, sorted, at
// cand[(query * n_blocks + block) * kc + j]; rows past the slab give key
// 0.  The (Q, rows) scores never leave the chip: they go through shared
// memory to one warp per query, which sorts the 64 keys in registers.
template <int QPT, int SD>
__global__ void __launch_bounds__(SCORE_THREADS) score_select_kernel(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, int kc, u64* __restrict__ cand) {
  constexpr int KQ = ScoreSmem<QPT, SD>::KQ;
  __shared__ ScoreSmem<QPT, SD> sm;
  float acc[QPT];
  score_block<QPT, SD>(q, Q, d, tbl, stride, rows, norms, excl, offset,
                       limit, sm, acc);
  const int tid = threadIdx.x, row = tid % SR, grp = tid / SR;
  float* sc = sm.es;                            // sc[query * SR + row]
#pragma unroll
  for (int i = 0; i < QPT; ++i) sc[(grp * QPT + i) * SR + row] = acc[i];
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * SR, q0 = blockIdx.y * KQ;
  const int nr = min(SR, rows - r0), nq = min(KQ, Q - q0);
  const int c0 = offset + r0 + 2 * lane;
  for (int i = warp; i < nq; i += SCORE_THREADS / 32) {
    const float2 s = *reinterpret_cast<const float2*>(&sc[i * SR + 2 * lane]);
    u64 v0 = 2 * lane < nr ? make_key(s.x, c0) : 0;
    u64 v1 = 2 * lane + 1 < nr ? make_key(s.y, c0 + 1) : 0;
    warp_sort64(v0, v1);
    u64* out = cand + ((long long)(q0 + i) * gridDim.x + blockIdx.x) * kc;
    if (2 * lane < kc) out[2 * lane] = v0;
    if (2 * lane + 1 < kc) out[2 * lane + 1] = v1;
  }
}

// Small k, stage 2: block qi merges query qi's running list and its
// n_lists sorted candidate runs of kc keys into the first k (<= 64) of
// their union, decoded.  The running list is sorted, so only its first
// min(k_run, 64) entries can stay.  Each warp walks every n_warps-th run,
// AHEAD runs' loads in flight, and keeps its best 64 keys in registers,
// sorted: a run whose head is not above the warp's k-th key cannot
// change the first k and is dropped after its load; any other is merged
// in (warp_merge64).  Then the warps' lists are merged pairwise through
// shared memory, one barrier a round.  Each candidate is read once, and
// costs a load and a compare unless its run displaces one of the k best.
__global__ void __launch_bounds__(LIST_MERGE_THREADS) merge_lists_kernel(
    const float* __restrict__ run_s, const int* __restrict__ run_i,
    int k_run, const u64* __restrict__ cand, int n_lists, int kc, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int AHEAD = 4;
  __shared__ u64 part[LIST_MERGE_THREADS / 32][64];
  const int qi = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;          // a power of two
  u64 v0 = 0, v1 = 0;
  if (warp == 0 && k_run > 0) {
    const float* rs = run_s + (long long)qi * k_run;
    const int* ri = run_i + (long long)qi * k_run;
    if (2 * lane < k_run) v0 = make_key(rs[2 * lane], ri[2 * lane]);
    if (2 * lane + 1 < k_run) v1 = make_key(rs[2 * lane + 1], ri[2 * lane + 1]);
  }
  const int kl = k - 1;                         // position of the k-th key
  u64 thr = __shfl_sync(0xffffffffu, (kl & 1) ? v1 : v0, kl >> 1);
  const u64* cq = cand + (long long)qi * n_lists * kc;
  const bool has0 = 2 * lane < kc, has1 = 2 * lane + 1 < kc;
  for (int b0 = warp; b0 < n_lists; b0 += AHEAD * n_warps) {
    u64 a0[AHEAD], a1[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int b = b0 + u * n_warps;
      const u64* run = cq + (long long)b * kc;
      a0[u] = (b < n_lists && has0) ? run[2 * lane] : 0;
      a1[u] = (b < n_lists && has1) ? run[2 * lane + 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (__shfl_sync(0xffffffffu, a0[u], 0) > thr) {   // uniform per warp
        warp_merge64(v0, v1, a0[u], a1[u]);
        thr = __shfl_sync(0xffffffffu, (kl & 1) ? v1 : v0, kl >> 1);
      }
    }
  }
  // warps [s, 2s) hand their lists to warps [0, s); the next round writes
  // [s/2, s), which this round does not read, so one barrier a round
  for (int s = n_warps / 2; s > 0; s >>= 1) {
    if (warp >= s && warp < 2 * s) {
      part[warp][2 * lane] = v0;
      part[warp][2 * lane + 1] = v1;
    }
    __syncthreads();
    if (warp < s)
      warp_merge64(v0, v1, part[warp + s][2 * lane],
                   part[warp + s][2 * lane + 1]);
  }
  if (warp == 0) {
    float* os = out_s + (long long)qi * k;
    int* oi = out_i + (long long)qi * k;
    if (2 * lane < k) {
      os[2 * lane] = v0 ? key_score(v0) : NEG_INF;
      oi[2 * lane] = v0 ? key_index(v0) : 0;
    }
    if (2 * lane + 1 < k) {
      os[2 * lane + 1] = v1 ? key_score(v1) : NEG_INF;
      oi[2 * lane + 1] = v1 ? key_index(v1) : 0;
    }
  }
}

// Large k, stage 1: score (score_block), then the key of every slab row
// for every query, keys[query * rows + r].
template <int QPT, int SD>
__global__ void __launch_bounds__(SCORE_THREADS) score_keys_kernel(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, u64* __restrict__ keys) {
  __shared__ ScoreSmem<QPT, SD> sm;
  float acc[QPT];
  score_block<QPT, SD>(q, Q, d, tbl, stride, rows, norms, excl, offset,
                       limit, sm, acc);
  const int row = threadIdx.x % SR, grp = threadIdx.x / SR;
  const int r = blockIdx.x * SR + row;
  if (r >= rows) return;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = blockIdx.y * ScoreSmem<QPT, SD>::KQ + grp * QPT + i;
    if (qi < Q) keys[(long long)qi * rows + r] = make_key(acc[i], offset + r);
  }
}

// Descending sort of buf[0, P) (P a power of two, >= 64) by the block;
// returns the buffer that holds the result (buf or tmp, P keys each).
// First every warp sorts runs of 64 keys in registers (warp_sort64);
// then rounds of
// pairwise merges double the run length, one barrier a round: each thread
// finds where its few consecutive outputs start on the merge path (a
// binary search, ties: the first run's key first) and merges them one
// shared-memory load each.
__device__ __forceinline__ u64* sort_keys(u64* buf, u64* tmp, int P) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  for (int w = warp; w < P / 64; w += n_warps) {
    u64* run = buf + w * 64;
    u64 v0 = run[2 * lane], v1 = run[2 * lane + 1];
    warp_sort64(v0, v1);
    run[2 * lane] = v0;
    run[2 * lane + 1] = v1;
  }
  __syncthreads();
  // outputs per thread in a merge round: enough that every thread has
  // some, at least 2
  const int run = max(2, P / (int)blockDim.x);
  u64 *src = buf, *dst = tmp;
  for (int W = 64; W < P; W <<= 1) {
    for (int o0 = threadIdx.x * run; o0 < P; o0 += blockDim.x * run) {
      const int base = o0 & ~(2 * W - 1), diag = o0 - base;
      const u64* A = src + base;
      const u64* B = A + W;
      int i = max(0, diag - W), hi = min(diag, W);
      while (i < hi) {
        const int mid = (i + hi) / 2;
        if (A[mid] >= B[diag - 1 - mid]) i = mid + 1;
        else hi = mid;
      }
      int j = diag - i;
      u64 a = i < W ? A[i] : 0, b = j < W ? B[j] : 0;
      for (int e = 0; e < run; ++e) {
        if (j >= W || (i < W && a >= b)) {
          dst[o0 + e] = a;
          ++i;
          a = i < W ? A[i] : 0;
        } else {
          dst[o0 + e] = b;
          ++j;
          b = j < W ? B[j] : 0;
        }
      }
    }
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Large k, stage 2: block (s, query) leaves the best m = min(k, n) of the
// n <= SORT_CAP keys of sub-slab s, sorted descending, at
// cand[(query * n_sub + s) * m_cap + j].  Slab keys are unique (each
// carries its own row), so the radix select finds exactly m survivors.
__global__ void __launch_bounds__(SORT_THREADS) select_sort_kernel(
    const u64* __restrict__ keys, int rows, int k, int n_sub, int m_cap,
    u64* __restrict__ cand) {
  extern __shared__ u64 buf[];                // 2 x pow2(m) keys
  __shared__ unsigned hist[256];
  __shared__ int scan_s[SORT_THREADS / 32];
  __shared__ unsigned sel[3];                 // bin, keys above it, in it
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x, qi = blockIdx.y;
  const int n = min(SORT_CAP, rows - s * SORT_CAP);
  const int m = min(k, n);
  const u64* src = keys + (long long)qi * rows + (long long)s * SORT_CAP;
  u64 my[SORT_KPT];
#pragma unroll
  for (int j = 0; j < SORT_KPT; ++j) {
    const int e = j * SORT_THREADS + tid;
    my[j] = e < n ? src[e] : 0;
  }
  // radix select, most significant byte first: after each pass the keys
  // whose processed bytes equal `prefix` hold the m-th key, and `need`
  // says how many of them to take.  Stops once a whole bin is taken.
  u64 prefix = 0, mask = 0;
  if (m < n) {
    unsigned need = m;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += SORT_THREADS) hist[i] = 0;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SORT_KPT; ++j) {
        // plain shared atomics: measured faster on the card than one
        // atomic per distinct byte of the warp via __match_any_sync
        if (j * SORT_THREADS + tid < n && (my[j] & mask) == prefix)
          atomicAdd(&hist[(unsigned)(my[j] >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        // lane L sums bins 255 - 8L down to 248 - 8L: a prefix sum over
        // the lanes counts the keys above each bin
        unsigned c[8], sum = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          c[b] = hist[255 - 8 * lane - b];
          sum += c[b];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        unsigned above = incl - sum;
        if (above < need && need <= incl) {
          for (int b = 0; b < 8; ++b) {
            if (need <= above + c[b]) {
              sel[0] = 255 - 8 * lane - b;
              sel[1] = above;
              sel[2] = c[b];
              break;
            }
            above += c[b];
          }
        }
      }
      __syncthreads();
      const unsigned bin = sel[0], above = sel[1], in_bin = sel[2];
      prefix |= (u64)bin << shift;
      mask |= 0xFFull << shift;
      if (above + in_bin == need) break;     // uniform over the block
      need -= above;
    }
  }
  // compact the survivors (processed bytes >= prefix) into buf[0, m)
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < SORT_KPT; ++j)
    cnt += (j * SORT_THREADS + tid < n && (my[j] & mask) >= prefix);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = scan_s[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    scan_s[lane] = wi - w;
  }
  __syncthreads();
  int pos = scan_s[warp] + incl - cnt;
#pragma unroll
  for (int j = 0; j < SORT_KPT; ++j) {
    if (j * SORT_THREADS + tid < n && (my[j] & mask) >= prefix) {
      if (pos < m) buf[pos] = my[j];
      ++pos;
    }
  }
  int P = 64;
  while (P < m) P <<= 1;
  for (int i = m + tid; i < P; i += SORT_THREADS) buf[i] = 0;
  __syncthreads();
  const u64* sorted = sort_keys(buf, buf + P, P);
  u64* out = cand + ((long long)qi * n_sub + s) * m_cap;
  for (int j = tid; j < m; j += SORT_THREADS) out[j] = sorted[j];
}

// How many of the first `diag` entries of the descending merge of the
// running list (keys built from rs/ri) and the sorted keys cb come from
// the running list; equal keys take the running entry first.  A warp
// searches together: each round its 32 lanes test 32 evenly spaced
// candidates, so ~2000 entries take 3 rounds of loads instead of 11.
// topk_similarity.py::merge_path_split is the same split on the host.
__device__ __forceinline__ int merge_split(
    const float* __restrict__ rs, const int* __restrict__ ri, int na,
    const u64* __restrict__ cb, int nb, int diag) {
  const int lane = threadIdx.x % 32;
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {                 // the split is in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    // true: running entry p is among the first diag
    const bool take = p < hi && make_key(rs[p], ri[p]) >= cb[diag - 1 - p];
    const int n_take = __popc(__ballot_sync(0xffffffffu, take));
    const int next_hi = min(hi, lo + n_take * step);
    if (n_take > 0) lo += (n_take - 1) * step + 1;
    hi = next_hi;
  }
  return lo;
}

// Large k, stage 3: outputs [x * MERGE_TILE, ...) of query y of the merge
// of the running list (k_run entries) and n_cand sorted candidate keys,
// the first k_out of it, decoded.
__global__ void __launch_bounds__(MERGE_TILE) merge_path_kernel(
    const float* __restrict__ run_s, const int* __restrict__ run_i,
    int k_run, const u64* __restrict__ cand, long long cand_stride,
    int n_cand, int k_out, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  __shared__ u64 ta[MERGE_TILE], tb[MERGE_TILE];
  __shared__ int split[2];
  const int qi = blockIdx.y, t = threadIdx.x;
  const int o0 = blockIdx.x * MERGE_TILE;
  const int o1 = min(o0 + MERGE_TILE, k_out);
  const float* rs = run_s + (long long)qi * k_run;
  const int* ri = run_i + (long long)qi * k_run;
  const u64* cb = cand + (long long)qi * cand_stride;
  if (t < 64) {                     // warp 0: start of the tile, 1: end
    const int sp = merge_split(rs, ri, k_run, cb, n_cand, t < 32 ? o0 : o1);
    if (t % 32 == 0) split[t / 32] = sp;
  }
  __syncthreads();
  const int a0 = split[0], na = split[1] - a0;
  const int b0 = o0 - a0, nb = (o1 - split[1]) - b0;
  if (t < na) ta[t] = make_key(rs[a0 + t], ri[a0 + t]);
  if (t < nb) tb[t] = cb[b0 + t];
  __syncthreads();
  u64 key;
  int pos;
  if (t < na) {                 // after the candidates strictly above it
    key = ta[t];
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (tb[mid] > key) lo = mid + 1; else hi = mid;
    }
    pos = t + lo;
  } else if (t < na + nb) {     // after the running entries at or above it
    const int j = t - na;
    key = tb[j];
    int lo = 0, hi = na;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ta[mid] >= key) lo = mid + 1; else hi = mid;
    }
    pos = j + lo;
  } else {
    return;
  }
  const long long o = (long long)qi * k_out + o0 + pos;
  out_s[o] = key ? key_score(key) : NEG_INF;
  out_i[o] = key ? key_index(key) : 0;
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int topk_score_select_launch(const float* q, int Q, int d, const float* tbl,
                             int stride, int rows, const float* norms,
                             const int* excl, int offset, int limit, int kc,
                             void* cand, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = ceil_div(rows, SR);
  if (Q <= 4)
    score_select_kernel<1, 64>
        <<<dim3(nb, ceil_div(Q, 4)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit, kc,
            (u64*)cand);
  else if (Q <= 16)
    score_select_kernel<4, 128>
        <<<dim3(nb, ceil_div(Q, 16)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit, kc,
            (u64*)cand);
  else
    score_select_kernel<16, 64>
        <<<dim3(nb, ceil_div(Q, 64)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit, kc,
            (u64*)cand);
  return (int)cudaGetLastError();
}

int topk_merge_lists_launch(const float* run_s, const int* run_i, int k_run,
                            const void* cand, int n_lists, int kc, int Q,
                            int k, float* out_s, int* out_i, void* stream) {
  // about 8 runs a warp, a power of two of warps, at most 32
  int warps = 1;
  while (warps < LIST_MERGE_THREADS / 32 && warps * 8 < n_lists) warps <<= 1;
  merge_lists_kernel<<<Q, 32 * warps, 0, (cudaStream_t)stream>>>(
      run_s, run_i, k_run, (const u64*)cand, n_lists, kc, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int topk_score_keys_launch(const float* q, int Q, int d, const float* tbl,
                           int stride, int rows, const float* norms,
                           const int* excl, int offset, int limit, void* keys,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = ceil_div(rows, SR);
  if (Q <= 4)
    score_keys_kernel<1, 64>
        <<<dim3(nb, ceil_div(Q, 4)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit,
            (u64*)keys);
  else if (Q <= 16)
    score_keys_kernel<4, 128>
        <<<dim3(nb, ceil_div(Q, 16)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit,
            (u64*)keys);
  else
    score_keys_kernel<16, 64>
        <<<dim3(nb, ceil_div(Q, 64)), SCORE_THREADS, 0, st>>>(
            q, Q, d, tbl, stride, rows, norms, excl, offset, limit,
            (u64*)keys);
  return (int)cudaGetLastError();
}

int topk_select_sort_launch(const void* keys, int Q, int rows, int k,
                            void* cand, void* stream) {
  const int m_cap = k < SORT_CAP ? k : SORT_CAP;
  int P = 64;
  while (P < m_cap) P <<= 1;
  const int smem = 2 * P * (int)sizeof(u64);
  if (smem > 48 * 1024) {         // above the default: ask for it (per card)
    const cudaError_t err = cudaFuncSetAttribute(
        select_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_sub = ceil_div(rows, SORT_CAP);
  select_sort_kernel<<<dim3(n_sub, Q), SORT_THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const u64*)keys, rows, k, n_sub, m_cap, (u64*)cand);
  return (int)cudaGetLastError();
}

int topk_merge_path_launch(const float* run_s, const int* run_i, int k_run,
                           const void* cand, long long cand_stride, int n_cand,
                           int Q, int k_out, float* out_s, int* out_i,
                           void* stream) {
  merge_path_kernel<<<dim3(ceil_div(k_out, MERGE_TILE), Q), MERGE_TILE, 0,
                      (cudaStream_t)stream>>>(
      run_s, run_i, k_run, (const u64*)cand, cand_stride, n_cand, k_out,
      out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points take their arguments packed as 64-bit integers, in
// the order of the launch functions above (one argument for ctypes to
// convert instead of up to thirteen); a null pointer is 0.
extern "C" {

int topk_score_select(const long long* a) {
  return topk_score_select_launch(
      (const float*)a[0], (int)a[1], (int)a[2], (const float*)a[3],
      (int)a[4], (int)a[5], (const float*)a[6], (const int*)a[7], (int)a[8],
      (int)a[9], (int)a[10], (void*)a[11], (void*)a[12]);
}

int topk_merge_lists(const long long* a) {
  return topk_merge_lists_launch(
      (const float*)a[0], (const int*)a[1], (int)a[2], (const void*)a[3],
      (int)a[4], (int)a[5], (int)a[6], (int)a[7], (float*)a[8], (int*)a[9],
      (void*)a[10]);
}

int topk_score_keys(const long long* a) {
  return topk_score_keys_launch(
      (const float*)a[0], (int)a[1], (int)a[2], (const float*)a[3],
      (int)a[4], (int)a[5], (const float*)a[6], (const int*)a[7], (int)a[8],
      (int)a[9], (void*)a[10], (void*)a[11]);
}

int topk_select_sort(const long long* a) {
  return topk_select_sort_launch((const void*)a[0], (int)a[1], (int)a[2],
                                 (int)a[3], (void*)a[4], (void*)a[5]);
}

int topk_merge_path(const long long* a) {
  return topk_merge_path_launch(
      (const float*)a[0], (const int*)a[1], (int)a[2], (const void*)a[3],
      a[4], (int)a[5], (int)a[6], (int)a[7], (float*)a[8], (int*)a[9],
      (void*)a[10]);
}

}  // extern "C"
