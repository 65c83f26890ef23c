// Cosine top-k for Hopper (sm_90a): one slab step of the serving top-k.
//
// Replaces the TPU kernel src/repro/kernels/topk_similarity.py::
// topk_cosine_pallas (kernel body _topk_kernel) together with the merge
// step of src/repro/kernels/ops.py::_topk_stream.  The Pallas grid walks
// the table one slab at a time on one core; here the slab is split into
// 256-row chunks x 16-query tiles, so every SM gets blocks, and the
// per-chunk results are merged by a second pass.
//
// Contract of one step (plain version: kernels/ref.py::stream_step_ref):
//   score = q . (e / max(norm, 1e-12)), fp32 accumulation, no TF32;
//   columns >= limit and each query's excluded column score -1e30;
//   result = the k best of (running list + slab), ordered by score
//   descending, then by global index ascending.
//
// Ordering trick: every candidate is one 64-bit key,
//   (order-preserving bits of the score) << 32 | (0xFFFFFFFF - index),
// so "larger key" is exactly "better candidate" and the keys of one slab
// never repeat (a running list may repeat its sentinel (-1e30, 0); equal
// keys decode alike).  Small-k selection takes k rounds of "largest key
// below the last one taken", which needs no removal and resolves ties by
// index for free.  Key 0 means "nothing left" and decodes to the sentinel
// (-1e30, 0).
//
// What bounds it on an H100: on the serving path the slab has just come
// over PCIe, so the step reads it once from HBM (rows*d*4 bytes) and does
// 2*Q*rows*d fp32 operations on the CUDA cores: Q/2 operations per byte,
// 32 at Q = 64.  The fp32 ridge of the card is 67 TFLOP/s over 3.35 TB/s
// = 20, so a full batch is bound by the fp32 rate, a small one by HBM.
// The design reads each chunk tile into shared memory with coalesced
// loads once per 16 queries, keeps 16 partial sums per thread in
// registers, and never writes the (Q, rows) score matrix to device memory
// for small k.
//
// k > 64 (up to N) takes three stages, and the running list, which is
// already sorted, is never sorted again:
//   1. score: one key per slab row and query into scratch (Q x rows), by
//      its own scorer: 64-row blocks that keep a stage's loads in flight
//      together (the small path's 256-row scorer waits on them one at a
//      time).  The two scorers compute the same masked score; the
//      duplication is deliberate and temporary: the small-k path is to
//      move onto this scorer, and score_rows to go, when that path is
//      redesigned next (ROADMAP.md, Queue 2);
//   2. select and sort: one block per (sub-slab of <= SORT_CAP rows,
//      query) holds the sub-slab's keys in registers, finds the m-th
//      largest key (m = min(k, sub-slab rows)) by a radix select over its
//      8 bytes,
//      compacts the m survivors into shared memory and sorts only them
//      (64-key runs in registers, then merge rounds);
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

constexpr int CHUNK = 256;        // rows per scoring block = its threads
constexpr int QT = 16;            // queries per scoring block
constexpr int DT = 32;            // feature columns per shared tile
constexpr int MERGE_THREADS = 256;
constexpr int SR = 64;            // slab rows per large-k scoring block
constexpr int SCORE_THREADS = 256;
constexpr int SORT_CAP = 8192;    // keys of one sub-slab (large k)
constexpr int SORT_THREADS = 1024;
constexpr int SORT_KPT = SORT_CAP / SORT_THREADS;  // keys per thread
constexpr int MERGE_TILE = 256;   // outputs per merge-path block (threads)
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

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Scores slab rows [r0, r0 + CHUNK) against queries [q0, q0 + QT): thread
// t ends with the masked scores of row r0 + t in acc[].  All threads of
// the block must call it (it synchronises).
__device__ __forceinline__ void score_rows(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, int r0, int q0,
    float* qs, float* es, float* nrm_s, float acc[QT]) {
  const int tid = threadIdx.x;
  const int nq = min(QT, Q - q0);
  {
    const int r = r0 + tid;
    nrm_s[tid] = (norms != nullptr && r < rows) ? fmaxf(norms[r], 1e-12f)
                                                : 1.0f;
  }
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.0f;
  __syncthreads();
  for (int c0 = 0; c0 < d; c0 += DT) {
    const int dc = min(DT, d - c0);
    // a warp reads DT consecutive floats of one row: coalesced; the
    // transposed store lands on distinct banks thanks to the +1 pad
    for (int e = tid; e < CHUNK * DT; e += CHUNK) {
      const int r = e / DT, c = e % DT;
      float v = 0.0f;
      if (r0 + r < rows && c < dc) {
        v = tbl[(long long)(r0 + r) * stride + c0 + c];
        if (norms != nullptr) v = v / nrm_s[r];
      }
      es[c * (CHUNK + 1) + r] = v;
    }
    for (int e = tid; e < QT * DT; e += CHUNK) {
      const int i = e / DT, c = e % DT;
      qs[i * (DT + 1) + c] =
          (i < nq && c < dc) ? q[(long long)(q0 + i) * d + c0 + c] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      const float ev = es[c * (CHUNK + 1) + tid];
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] = fmaf(qs[i * (DT + 1) + c], ev, acc[i]);
    }
    __syncthreads();
  }
  const int r = r0 + tid;
  const int col = offset + r;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const bool live = i < nq && r < rows && col < limit && col != excl[q0 + i];
    acc[i] = live ? acc[i] : NEG_INF;
  }
}

// Small k, stage 1: the best kc keys of each (chunk, query).
// cand[(query * n_chunks + chunk) * kc + j], descending.
__global__ void __launch_bounds__(CHUNK) select_chunks_kernel(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, int kc, int n_chunks, u64* __restrict__ cand) {
  __shared__ float qs[QT * (DT + 1)];
  __shared__ __align__(16) float es[DT * (CHUNK + 1)];
  __shared__ float nrm_s[CHUNK];
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int r0 = chunk * CHUNK;
  float acc[QT];
  score_rows(q, Q, d, tbl, stride, rows, norms, excl, offset, limit, r0, q0,
             qs, es, nrm_s, acc);
  float* sc = es;                   // reuse the tile: QT x CHUNK scores
#pragma unroll
  for (int i = 0; i < QT; ++i) sc[i * CHUNK + threadIdx.x] = acc[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = min(QT, Q - q0);
  for (int i = warp; i < nq; i += CHUNK / 32) {
    u64 keys[CHUNK / 32];
#pragma unroll
    for (int m = 0; m < CHUNK / 32; ++m) {
      const int r = lane + 32 * m;
      keys[m] = make_key(sc[i * CHUNK + r], offset + r0 + r);
    }
    u64* out = cand + ((long long)(q0 + i) * n_chunks + chunk) * kc;
    u64 prev = ~0ull;
    for (int j = 0; j < kc; ++j) {
      u64 best = 0;
#pragma unroll
      for (int m = 0; m < CHUNK / 32; ++m)
        best = (keys[m] < prev && keys[m] > best) ? keys[m] : best;
      best = warp_max(best);
      if (lane == 0) out[j] = best;
      prev = best;
    }
  }
}

// Small k, stage 2: one block per query merges the running list and the
// stage-1 candidates into the new running list of k entries.
__global__ void __launch_bounds__(MERGE_THREADS) merge_running_kernel(
    const float* __restrict__ run_s, const int* __restrict__ run_i, int k_run,
    const u64* __restrict__ cand, int n_cand, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ u64 red[MERGE_THREADS / 32];
  const int qi = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int total = k_run + n_cand;
  const float* rs = run_s + (long long)qi * k_run;
  const int* ri = run_i + (long long)qi * k_run;
  const u64* cq = cand + (long long)qi * n_cand;
  u64 prev = ~0ull;
  for (int j = 0; j < k; ++j) {
    u64 best = 0;
    for (int t = threadIdx.x; t < total; t += MERGE_THREADS) {
      const u64 key = t < k_run ? make_key(rs[t], ri[t]) : cq[t - k_run];
      best = (key < prev && key > best) ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      u64 v = lane < MERGE_THREADS / 32 ? red[lane] : 0;
      v = warp_max(v);
      if (lane == 0) red[0] = v;
    }
    __syncthreads();
    best = red[0];
    __syncthreads();                // red is rewritten next round
    if (threadIdx.x == 0) {
      out_s[(long long)qi * k + j] = best ? key_score(best) : NEG_INF;
      out_i[(long long)qi * k + j] = best ? key_index(best) : 0;
    }
    prev = best;
  }
}

// Large k, stage 1: the key of every slab row for every query,
// keys[query * rows + r].  Block = SR rows x 4 * QPT queries; thread
// (group g, row r) sums queries g * QPT .. + QPT of row r.  Each stage
// issues all of its SD columns' loads (SR * SD / 256 floats of the slab
// per thread) before it stores any, so a block has 16-32 KB in flight,
// and SR = 64 rows per block puts a block on every SM for an 8192-row
// slab.  SD is 128 columns (two stages at d = 200) where the queries'
// tile leaves room in 48 KB of shared memory (QPT <= 4), else 64.
// QPT follows Q (1, 4 or 16), so a single query wastes no threads' work
// and a batch of 64 shares each shared slab column among 16 sums.
template <int QPT, int SD>
__global__ void __launch_bounds__(SCORE_THREADS) score_keys_kernel(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit, u64* __restrict__ keys) {
  constexpr int KQ = 4 * QPT;                   // queries per block
  constexpr int QP = KQ + (QPT >= 4 ? 4 : 1);   // float4 rows when QPT >= 4
  constexpr int EPT = SR * SD / SCORE_THREADS;  // slab floats per thread
  constexpr int QPTL = KQ * SD / SCORE_THREADS; // query floats per thread
  __shared__ float es[SD * (SR + 1)];
  __shared__ __align__(16) float qs[SD * QP];
  __shared__ float nrm_s[SR];
  const int tid = threadIdx.x, row = tid % SR, grp = tid / SR;
  const int r0 = blockIdx.x * SR, q0 = blockIdx.y * KQ;
  const int nr = min(SR, rows - r0), nq = min(KQ, Q - q0);
  const bool busy = grp * QPT < nq;             // uniform per warp
  if (tid < SR)
    nrm_s[tid] = (norms != nullptr && tid < nr) ? fmaxf(norms[r0 + tid], 1e-12f)
                                                : 1.0f;
  float acc[QPT];
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
      es[c * (SR + 1) + r] = norms != nullptr ? ev[u] / nrm_s[r] : ev[u];
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
  if (!busy || row >= nr) return;
  const int col = offset + r0 + row;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + grp * QPT + i;
    if (qi < Q) {
      const bool live = col < limit && col != excl[qi];
      keys[(long long)qi * rows + r0 + row] =
          make_key(live ? acc[i] : NEG_INF, col);
    }
  }
}

// Descending sort of buf[0, P) (P a power of two, >= 64) by the block;
// returns the buffer that holds the result (buf or tmp, P keys each).
// First every warp sorts runs of 64 keys in registers, two keys a lane,
// with a bitonic network over shuffles (no barriers); then rounds of
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
    for (int size = 2; size <= 64; size <<= 1) {
      const bool desc = ((2 * lane) & size) == 0;
      for (int o = size / 4; o > 0; o >>= 1) {   // stride 2 * o: lane ^ o
        const u64 w0 = __shfl_xor_sync(0xffffffffu, v0, o);
        const u64 w1 = __shfl_xor_sync(0xffffffffu, v1, o);
        const bool keep_max = ((lane & o) == 0) == desc;
        v0 = keep_max ? (w0 > v0 ? w0 : v0) : (w0 < v0 ? w0 : v0);
        v1 = keep_max ? (w1 > v1 ? w1 : v1) : (w1 < v1 ? w1 : v1);
      }
      if ((v0 < v1) == desc) {                   // stride 1, in the lane
        const u64 x = v0;
        v0 = v1;
        v1 = x;
      }
    }
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

int topk_select_chunks_launch(const float* q, int Q, int d, const float* tbl,
                              int stride, int rows, const float* norms,
                              const int* excl, int offset, int limit, int kc,
                              void* cand, void* stream) {
  const int n_chunks = ceil_div(rows, CHUNK);
  select_chunks_kernel<<<dim3(n_chunks, ceil_div(Q, QT)), CHUNK, 0,
                         (cudaStream_t)stream>>>(
      q, Q, d, tbl, stride, rows, norms, excl, offset, limit, kc, n_chunks,
      (u64*)cand);
  return (int)cudaGetLastError();
}

int topk_merge_running_launch(const float* run_s, const int* run_i, int k_run,
                              const void* cand, int n_cand, int Q, int k,
                              float* out_s, int* out_i, void* stream) {
  merge_running_kernel<<<Q, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      run_s, run_i, k_run, (const u64*)cand, n_cand, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int topk_score_keys_launch(const float* q, int Q, int d, const float* tbl,
                           int stride, int rows, const float* norms,
                           const int* excl, int offset, int limit, void* keys,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = ceil_div(rows, SR);
  if (Q <= 4)
    score_keys_kernel<1, 128>
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

int topk_select_chunks(const long long* a) {
  return topk_select_chunks_launch(
      (const float*)a[0], (int)a[1], (int)a[2], (const float*)a[3],
      (int)a[4], (int)a[5], (const float*)a[6], (const int*)a[7], (int)a[8],
      (int)a[9], (int)a[10], (void*)a[11], (void*)a[12]);
}

int topk_merge_running(const long long* a) {
  return topk_merge_running_launch(
      (const float*)a[0], (const int*)a[1], (int)a[2], (const void*)a[3],
      (int)a[4], (int)a[5], (int)a[6], (float*)a[7], (int*)a[8],
      (void*)a[9]);
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
