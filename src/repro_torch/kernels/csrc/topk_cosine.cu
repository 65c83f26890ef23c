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
// so "larger key" is exactly "better candidate" and keys of real entries
// never repeat.  Selection takes k rounds of "largest key below the last
// one taken", which needs no removal and resolves ties by index for free.
// Key 0 means "nothing left" and decodes to the sentinel (-1e30, 0).
//
// What bounds it on an H100: on the serving path the slab has just come
// over PCIe, so the step reads it once from HBM (rows*d*4 bytes) and does
// 2*Q*rows*d fp32 operations on the CUDA cores: Q/2 operations per byte,
// 32 at Q = 64.  The fp32 ridge of the card is 67 TFLOP/s over 3.35 TB/s
// = 20, so a full batch is bound by the fp32 rate, a small one by HBM.  The design reads each chunk tile into shared memory
// with coalesced loads once per 16 queries, keeps 16 partial sums per
// thread in registers, and never writes the (Q, rows) score matrix to
// device memory for small k.  k > 64 (up to N) writes one key per
// candidate and sorts with a bitonic network in global memory, finished
// in shared memory for strides <= 1024: simple, and slower.
//
// Every entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;        // rows per scoring block = its threads
constexpr int QT = 16;            // queries per scoring block
constexpr int DT = 32;            // feature columns per shared tile
constexpr int MERGE_THREADS = 256;
constexpr int SORT_TILE = 2048;   // keys per shared-memory bitonic tile
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

// Large k: keys of every candidate, one row of P per query:
// [0, k_run) running list, [k_run, k_run + rows) slab, rest 0 (padding).
// Blocks past n_chunks fill the running and padding positions.
__global__ void __launch_bounds__(CHUNK) score_keys_kernel(
    const float* __restrict__ q, int Q, int d,
    const float* __restrict__ tbl, long long stride, int rows,
    const float* __restrict__ norms, const int* __restrict__ excl,
    int offset, int limit,
    const float* __restrict__ run_s, const int* __restrict__ run_i, int k_run,
    u64* __restrict__ keys, int P, int n_chunks) {
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  if ((int)blockIdx.x >= n_chunks) {
    const long long f = (long long)(blockIdx.x - n_chunks) * CHUNK + threadIdx.x;
    if (f >= (long long)P - rows) return;
    for (int i = 0; i < nq; ++i) {
      const long long qq = q0 + i;
      if (f < k_run)
        keys[qq * P + f] = make_key(run_s[qq * k_run + f], run_i[qq * k_run + f]);
      else
        keys[qq * P + rows + f] = 0;
    }
    return;
  }
  __shared__ float qs[QT * (DT + 1)];
  __shared__ __align__(16) float es[DT * (CHUNK + 1)];
  __shared__ float nrm_s[CHUNK];
  const int r0 = blockIdx.x * CHUNK;
  float acc[QT];
  score_rows(q, Q, d, tbl, stride, rows, norms, excl, offset, limit, r0, q0,
             qs, es, nrm_s, acc);
  const int r = r0 + threadIdx.x;
  if (r >= rows) return;
  for (int i = 0; i < nq; ++i)
    keys[(long long)(q0 + i) * P + k_run + r] = make_key(acc[i], offset + r);
}

// One (size, stride) pass of a descending bitonic sort over each row of P
// keys, for strides too wide for one shared-memory tile.
__global__ void bitonic_global_kernel(u64* __restrict__ keys, int P, int size,
                                      int stride) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P / 2) return;
  u64* row = keys + (long long)blockIdx.y * P;
  const long long i = 2LL * stride * (p / stride) + (p % stride);
  const long long l = i + stride;
  const bool desc = (i & size) == 0;
  const u64 a = row[i], b = row[l];
  if (desc ? (a < b) : (a > b)) {
    row[i] = b;
    row[l] = a;
  }
}

// Bitonic stages size_lo..size_hi (powers of two) for every stride that
// fits in one tile of min(SORT_TILE, P) keys, in shared memory.
__global__ void __launch_bounds__(SORT_TILE / 2) bitonic_shared_kernel(
    u64* __restrict__ keys, int P, int size_lo, int size_hi) {
  __shared__ u64 tile[SORT_TILE];
  const int T = min(SORT_TILE, P);
  const long long base = (long long)blockIdx.x * T;
  u64* row = keys + (long long)blockIdx.y * P + base;
  for (int t = threadIdx.x; t < T; t += blockDim.x) tile[t] = row[t];
  __syncthreads();
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, T) / 2; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
        const int i = 2 * stride * (p / stride) + (p % stride);
        const int l = i + stride;
        const bool desc = ((base + i) & size) == 0;
        const u64 a = tile[i], b = tile[l];
        if (desc ? (a < b) : (a > b)) {
          tile[i] = b;
          tile[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) row[t] = tile[t];
}

// Large k: the first k keys of each sorted row, decoded.
__global__ void gather_kernel(const u64* __restrict__ keys, int P, int k,
                              float* __restrict__ out_s, int* __restrict__ out_i) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const u64 key = keys[(long long)blockIdx.y * P + j];
  out_s[(long long)blockIdx.y * k + j] = key ? key_score(key) : NEG_INF;
  out_i[(long long)blockIdx.y * k + j] = key ? key_index(key) : 0;
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

int topk_select_chunks(const float* q, int Q, int d, const float* tbl,
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

int topk_merge_running(const float* run_s, const int* run_i, int k_run,
                       const void* cand, int n_cand, int Q, int k,
                       float* out_s, int* out_i, void* stream) {
  merge_running_kernel<<<Q, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      run_s, run_i, k_run, (const u64*)cand, n_cand, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int topk_score_keys(const float* q, int Q, int d, const float* tbl,
                    int stride, int rows, const float* norms, const int* excl,
                    int offset, int limit, const float* run_s,
                    const int* run_i, int k_run, void* keys, int P,
                    void* stream) {
  const int n_chunks = ceil_div(rows, CHUNK);
  const int n_fill = ceil_div((long long)P - rows, CHUNK);
  score_keys_kernel<<<dim3(n_chunks + n_fill, ceil_div(Q, QT)), CHUNK, 0,
                      (cudaStream_t)stream>>>(
      q, Q, d, tbl, stride, rows, norms, excl, offset, limit, run_s, run_i,
      k_run, (u64*)keys, P, n_chunks);
  return (int)cudaGetLastError();
}

int topk_bitonic_global(void* keys, int Q, int P, int size, int stride,
                        void* stream) {
  bitonic_global_kernel<<<dim3(ceil_div(P / 2, 256), Q), 256, 0,
                          (cudaStream_t)stream>>>((u64*)keys, P, size, stride);
  return (int)cudaGetLastError();
}

int topk_bitonic_shared(void* keys, int Q, int P, int size_lo, int size_hi,
                        void* stream) {
  const int T = P < SORT_TILE ? P : SORT_TILE;
  bitonic_shared_kernel<<<dim3(P / T, Q), T / 2, 0, (cudaStream_t)stream>>>(
      (u64*)keys, P, size_lo, size_hi);
  return (int)cudaGetLastError();
}

int topk_gather(const void* keys, int Q, int P, int k, float* out_s,
                int* out_i, void* stream) {
  gather_kernel<<<dim3(ceil_div(k, 256), Q), 256, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, P, k, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
