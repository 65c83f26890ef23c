// Fused KGE scoring for Hopper (sm_90a), forward and backward: the scoring
// of every training step of TransE (L1 and L2) and DistMult.
//
// Replaces the TPU kernel src/repro/kernels/kge_score.py::kge_score_pallas
// (kernel body _kge_kernel).  The JAX package has no backward kernel; the
// backward here is the analytic gradient of the same three formulas, held
// to jax.vjp of repro.kernels.ref.kge_score_ref by the tests.
//
// Contract (plain versions: kernels/ref.py::kge_score_ref and
// kge_score_backward_ref), for B positives with K negatives each:
//   h, r, t (B, d), neg (B, K, d) fp32; corrupt_head (B, K) bytes, nonzero
//   means neg replaces the head, zero the tail;
//   TransE-L1  score = -sum|x|,               x = h + r - t
//   TransE-L2  score = -sqrt(sum x^2 + 1e-12)
//   DistMult   score = sum h * r * t
//   forward -> pos (B,), negs (B, K);
//   backward(g_pos (B,), g_negs (B, K)) -> grad h, r, t (B, d) and
//   grad neg (B, K, d).
// Every difference and product is formed in the plain version's order
// ((neg + r) - t with the head corrupted, (h + r) - neg with the tail), so
// the sign of an exactly-zero coordinate agrees with it.  The derivative
// of |x| is +1 at x >= 0, 0 included, as JAX's is.
//
// What bounds it on an H100: both passes stream the (B, K, d) negatives
// (26.2 MB at B = 1024, K = 32, d = 200) and do ~2-4 operations per float
// read, far below the card's fp32 ridge of 67 TFLOP/s over 3.35 TB/s = 20:
// HBM bytes bound them.  The backward reads neg and writes grad neg, twice
// the forward's bytes.
//
// Forward: one block per positive b (B need not be padded, as the Pallas
// kernel pads it to block_b); h + r and r (or h * r and r * t) and t of
// the row go to shared memory once; one warp per candidate (the positive,
// then each negative), lanes over d with coalesced loads, a shuffle
// reduction.
//
// Backward: the whole tensor in flight, each byte of it moved once.  One
// block of 128 threads per positive b, whose negatives neg[b] are one
// contiguous (K, d) slab (25.6 KB at the shape above):
//   * staging: the slab goes to shared memory in chunks of rows.  When it
//     is 16-byte aligned (K * d and every chunk a multiple of 4 floats,
//     neg and grad neg aligned) each chunk is one cp.async.bulk copy (the
//     1-D TMA copy) completing on an mbarrier; otherwise the same kernel
//     stages it with 4-byte cp.async copies.  A slab of up to 10,240
//     floats is two chunks, both in flight from the start, so the first
//     is computed while the second lands; a larger one streams through a
//     two-stage ring of chunks of at most 5,120 floats.  At (32, 200) a
//     block holds 26.7 KB of shared memory and 8 blocks fit on an SM, so
//     all 1,024 slabs, the whole tensor, are in flight at once (one wave);
//   * every later read of the negatives comes from shared memory, so
//     neg is read from HBM once for all three models.  TransE-L2 first
//     writes x in place of n, then takes its norms from the staged x, one
//     warp per two rows, then forms the gradients from x;
//   * grad neg overwrites the staged chunk in place and leaves with one
//     bulk copy from shared to global memory (aligned), or coalesced
//     4-byte stores (otherwise);
//   * grad h, r, t: the 128 threads form G groups of (d / V) threads, V =
//     4 coordinates a thread (float4) where d is a multiple of 4 and the
//     rows are aligned, else 1.  Group g takes rows g, g + G, ... and
//     keeps its partial sums in fp32 registers, or, past 128 rows a thread
//     or with more than 128 vector columns (one group walking column
//     tiles), adds each chunk's fp32 partial into fp64 sums in shared
//     memory.  The groups combine in a fixed pairwise tree.  No atomics:
//     two runs give the same bits.  Group 0 starts from the positive's
//     term, formed exactly as the plain version forms it, so with g_negs =
//     0 the result equals it bit for bit.
// What is left above the bound: each block loads, computes, then stores,
// so the compute of the last slabs to land and the stores of the first
// do not overlap everything; TransE-L2's two extra passes over shared
// memory.
//
// Every entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().
// Its arguments come packed in one array of 64-bit integers (see the
// end of this file).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Model { TRANSE_L1 = 0, TRANSE_L2 = 1, DISTMULT = 2 };

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
// a slab of up to this many floats (40 KB) and 2 * MAX_CHUNK_ROWS rows is
// staged in two chunks ...
constexpr int SPLIT_SLAB_FLOATS = 10240;
constexpr int MAX_CHUNK_ROWS = 1024;
// ... a larger one through two stages of chunks of at most this many
// floats (20 KB) and MAX_CHUNK_ROWS rows
constexpr int RING_STAGE_FLOATS = 5120;
// a thread sums at most this many rows in fp32 registers; past it, and
// with column tiles, the running sums are fp64 in shared memory
constexpr int MAX_REG_ROWS = 128;
// above the most shared memory a plan takes over the wrapper's range of
// K and d (137 KB: two stages, fp64 sums of 3 x 4096 columns, up to 4 KB
// of coefficients and 1 KB of flags)
constexpr int MAX_BWD_SMEM = 160 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one coordinate's part of sum|x| or sum x^2
template <int MODEL>
__device__ __forceinline__ float dist_term(float x) {
  return MODEL == TRANSE_L1 ? fabsf(x) : x * x;
}

// the score from the summed coordinate terms
template <int MODEL>
__device__ __forceinline__ float finish(float s) {
  if (MODEL == TRANSE_L1) return -s;
  if (MODEL == TRANSE_L2) return -sqrtf(s + 1e-12f);
  return s;
}

// d score / d x times the cotangent, for TransE: coef is -g for L1 and
// -g / sqrt(sum x^2 + 1e-12) for L2
template <int MODEL>
__device__ __forceinline__ float grad_x(float coef, float x) {
  if (MODEL == TRANSE_L1) return coef * (x >= 0.0f ? 1.0f : -1.0f);
  return coef * x;
}

template <int MODEL>
__global__ void __launch_bounds__(FWD_THREADS)
kge_forward_kernel(const float* __restrict__ h, const float* __restrict__ r,
                   const float* __restrict__ t, const float* __restrict__ neg,
                   const unsigned char* __restrict__ ch, int K, int d,
                   float* __restrict__ pos, float* __restrict__ negs) {
  extern __shared__ float sh[];
  float* s_a = sh;            // TransE: h + r    DistMult: h * r
  float* s_r = sh + d;        // TransE: r        DistMult: r * t
  float* s_t = sh + 2 * d;    // t
  const int b = blockIdx.x;
  const size_t row = (size_t)b * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float hv = h[row + c], rv = r[row + c], tv = t[row + c];
    if (MODEL == DISTMULT) {
      s_a[c] = hv * rv;
      s_r[c] = rv * tv;
    } else {
      s_a[c] = hv + rv;
      s_r[c] = rv;
    }
    s_t[c] = tv;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // candidate j = -1 is the positive, j >= 0 negative j of this row
  for (int j = (int)(threadIdx.x >> 5) - 1; j < K; j += n_warps) {
    float acc = 0.0f;
    if (j < 0) {
      for (int c = lane; c < d; c += 32)
        acc += MODEL == DISTMULT ? s_a[c] * s_t[c]
                                 : dist_term<MODEL>(s_a[c] - s_t[c]);
    } else {
      const float* nrow = neg + ((size_t)b * K + j) * d;
      const bool head = ch[(size_t)b * K + j] != 0;
      for (int c = lane; c < d; c += 32) {
        const float n = nrow[c];
        if (MODEL == DISTMULT)
          acc += head ? n * s_r[c] : s_a[c] * n;
        else
          acc += dist_term<MODEL>(head ? (n + s_r[c]) - s_t[c] : s_a[c] - n);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (j < 0)
        pos[b] = finish<MODEL>(acc);
      else
        negs[(size_t)b * K + j] = finish<MODEL>(acc);
    }
  }
}

// ---- backward: staging primitives -------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on `bar` and expect `bytes` more bytes of copies to complete on it
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// the bulk stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the bulk stores issued so far are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory become visible to
// the bulk copies (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V consecutive floats (V = 4: one 16-byte access)
template <int V>
__device__ __forceinline__ void ldv(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// How one launch walks its slabs; the host fills it (backward_plan).
struct BwdPlan {
  int K, d;
  int kc;            // rows a chunk
  int n_chunks;
  int stage_floats;  // floats a stage (kc * d rounded up to 4)
  int groups;        // G: groups of threads over K
  int tc;            // threads of a group (vector columns of a tile)
  int n_tiles;       // column tiles (> 1 only with one group)
  int bulk;          // 1: bulk copies, 0: 4-byte cp.async and stores
  int wide;          // 1: running sums in fp64 in shared memory
  int off_bar, off_coef, off_sums, off_ch;  // bytes into shared memory
};

// The gradient of one chunk's rows [g, g + G, ...) for the V coordinates
// at c: grad neg in place in the stage, the partial sums in a_h, a_r, a_t.
template <int MODEL, int V>
__device__ __forceinline__ void chunk_rows(
    float* st, const float* coef, const unsigned char* s_ch, int rows,
    int g, int groups, int d, int c, const float (&hv)[V],
    const float (&rv)[V], const float (&tv)[V], float (&a_h)[V],
    float (&a_r)[V], float (&a_t)[V]) {
  for (int k = g; k < rows; k += groups) {
    const float gk = coef[1 + k];
    const bool head = s_ch[k] != 0;
    float* p = st + (size_t)k * d + c;
    float n[V], out[V];
    ldv<V>(n, p);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (MODEL == DISTMULT) {
        if (head) {             // score = sum n * (r * t)
          out[v] = gk * (rv[v] * tv[v]);
          a_r[v] += gk * (n[v] * tv[v]);
          a_t[v] += gk * (n[v] * rv[v]);
        } else {                // score = sum (h * r) * n
          out[v] = gk * (hv[v] * rv[v]);
          a_h[v] += gk * (rv[v] * n[v]);
          a_r[v] += gk * (hv[v] * n[v]);
        }
      } else if (MODEL == TRANSE_L2) {
        const float gx = gk * n[v];   // the stage holds x (l2_x)
        out[v] = head ? gx : -gx;
        if (head) {
          a_r[v] += gx;
          a_t[v] -= gx;
        } else {
          a_h[v] += gx;
          a_r[v] += gx;
        }
      } else {
        if (head) {             // x = (n + r) - t
          const float gx = grad_x<MODEL>(gk, (n[v] + rv[v]) - tv[v]);
          out[v] = gx;
          a_r[v] += gx;
          a_t[v] -= gx;
        } else {                // x = (h + r) - n
          const float gx = grad_x<MODEL>(gk, (hv[v] + rv[v]) - n[v]);
          out[v] = -gx;
          a_h[v] += gx;
          a_r[v] += gx;
        }
      }
    }
    stv<V>(p, out);
  }
}

// TransE-L2, first: the difference x of each of the group's rows in
// place of n in the stage, formed as the plain version forms it
template <int V>
__device__ __forceinline__ void l2_x(float* st, const unsigned char* s_ch,
                                    int rows, int g, int groups, int d, int c,
                                    const float (&hv)[V],
                                    const float (&rv)[V],
                                    const float (&tv)[V]) {
  for (int k = g; k < rows; k += groups) {
    const bool head = s_ch[k] != 0;
    float* p = st + (size_t)k * d + c;
    float x[V];
    ldv<V>(x, p);
#pragma unroll
    for (int v = 0; v < V; ++v)
      x[v] = head ? (x[v] + rv[v]) - tv[v] : (hv[v] + rv[v]) - x[v];
    stv<V>(p, x);
  }
}

// ... then coef[1 + k] = -g / sqrt(sum x^2 + 1e-12) from the staged x of
// the chunk's rows: one warp per two rows, lanes over V-wide columns
template <int V>
__device__ __forceinline__ void l2_coefs(const float* st, float* coef,
                                        int rows, int d, int warp, int lane) {
  for (int k0 = 2 * warp; k0 < rows; k0 += 2 * BWD_WARPS) {
    const bool two = k0 + 1 < rows;
    const float* x0 = st + (size_t)k0 * d;
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int c = lane * V; c < d; c += 32 * V) {
      float x[V];
      ldv<V>(x, x0 + c);
#pragma unroll
      for (int v = 0; v < V; ++v) acc0 += x[v] * x[v];
      if (two) {
        ldv<V>(x, x0 + d + c);
#pragma unroll
        for (int v = 0; v < V; ++v) acc1 += x[v] * x[v];
      }
    }
    acc0 = warp_sum(acc0);
    acc1 = warp_sum(acc1);
    if (lane == 0) {
      coef[1 + k0] = -coef[1 + k0] / sqrtf(acc0 + 1e-12f);
      if (two) coef[2 + k0] = -coef[2 + k0] / sqrtf(acc1 + 1e-12f);
    }
  }
}

// Sum the groups' partials `a` (one of grad h, r, t) through `scratch` in
// a fixed pairwise tree and write the sum to out[c, c + V).  Every thread
// of the block calls it (it synchronises).
template <int V>
__device__ __forceinline__ void group_tree(float* scratch, const float (&a)[V],
                                          bool active, int g, int groups,
                                          int tc, int col, float* out) {
  float* mine = scratch + ((size_t)g * tc + col) * V;
  if (active) stv<V>(mine, a);
  __syncthreads();
  for (int s = 1; s < groups; s <<= 1) {
    if (active && g % (2 * s) == 0 && g + s < groups) {
      float x[V], y[V];
      ldv<V>(x, mine);
      ldv<V>(y, mine + (size_t)s * tc * V);
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] += y[v];
      stv<V>(mine, x);
    }
    __syncthreads();
  }
  if (active && g == 0) {
    float x[V];
    ldv<V>(x, mine);
    stv<V>(out, x);
  }
  __syncthreads();   // the scratch is free for the next sum
}

template <int MODEL, int V>
__global__ void __launch_bounds__(BWD_THREADS, 8)
kge_backward_kernel(const float* __restrict__ h, const float* __restrict__ r,
                    const float* __restrict__ t,
                    const float* __restrict__ neg,
                    const unsigned char* __restrict__ ch,
                    const float* __restrict__ g_pos,
                    const float* __restrict__ g_negs, BwdPlan p,
                    float* __restrict__ gh, float* __restrict__ gr,
                    float* __restrict__ gt, float* __restrict__ gneg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  const uint32_t bar0 = smem_u32(smem + p.off_bar);  // one a stage
  // coef[0]: the positive's, coef[1 + j]: row j of the chunk
  float* coef = reinterpret_cast<float*>(smem + p.off_coef);
  // wide: the fp64 running sums, three arrays of one slot a (group, tile,
  // vector column); otherwise the fp32 scratch of group_tree
  unsigned char* sums = smem + p.off_sums;
  unsigned char* s_ch = smem + p.off_ch;

  const int K = p.K, d = p.d;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid / p.tc, col = tid % p.tc;
  const bool in_group = g < p.groups;
  h += (size_t)b * d;
  r += (size_t)b * d;
  t += (size_t)b * d;
  gh += (size_t)b * d;
  gr += (size_t)b * d;
  gt += (size_t)b * d;
  const float* nslab = neg + (size_t)b * K * d;
  float* gslab = gneg + (size_t)b * K * d;
  const int slots = p.groups * p.n_tiles * p.tc * V;
  double* wide = reinterpret_cast<double*>(sums);

  // chunk i of the slab into stage i & 1
  auto issue = [&](int i) {
    const int k0 = i * p.kc, n = min(p.kc, K - k0) * d;
    float* dst = stage + (i & 1) * p.stage_floats;
    const float* src = nslab + (size_t)k0 * d;
    if (p.bulk) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (i & 1);
        mbar_expect_tx(bar, n * 4);
        bulk_load(smem_u32(dst), src, n * 4, bar);
      }
    } else {
      for (int e = tid; e < n; e += BWD_THREADS) cp_async4(dst + e, src + e);
      cp_async_commit();
    }
  };

  if (p.bulk && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue(0);
  if (p.n_chunks > 1) issue(1);

  // while the first chunks are in flight: the positive's coefficient, and
  // the row values of this thread's columns (one tile)
  if (warp == 0) {
    float c0 = g_pos[b];
    if (MODEL == TRANSE_L2) {
      float acc = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float x = (h[c] + r[c]) - t[c];
        acc += x * x;
      }
      acc = warp_sum(acc);
      c0 = -c0 / sqrtf(acc + 1e-12f);
    } else if (MODEL == TRANSE_L1) {
      c0 = -c0;
    }
    if (lane == 0) coef[0] = c0;
  }
  float hv[V], rv[V], tv[V];
  if (p.n_tiles == 1 && in_group && col * V < d) {
    ldv<V>(hv, h + col * V);
    ldv<V>(rv, r + col * V);
    ldv<V>(tv, t + col * V);
  }

  float a_h[V], a_r[V], a_t[V];
  for (int i = 0; i < p.n_chunks; ++i) {
    const int k0 = i * p.kc, rows = min(p.kc, K - k0);
    float* st = stage + (i & 1) * p.stage_floats;
    for (int j = tid; j < rows; j += BWD_THREADS) {
      const float gk = g_negs[(size_t)b * K + k0 + j];
      coef[1 + j] = MODEL == TRANSE_L1 ? -gk : gk;
      s_ch[j] = ch[(size_t)b * K + k0 + j] != 0;
    }
    if (p.bulk)
      mbar_wait(bar0 + 8 * (i & 1), (i >> 1) & 1);
    else if (i + 1 < p.n_chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    if (MODEL == TRANSE_L2) {
      for (int tile = 0; tile < p.n_tiles; ++tile) {
        const int c = (tile * p.tc + col) * V;
        if (!in_group || c >= d) continue;
        if (p.n_tiles > 1) {
          ldv<V>(hv, h + c);
          ldv<V>(rv, r + c);
          ldv<V>(tv, t + c);
        }
        l2_x<V>(st, s_ch, rows, g, p.groups, d, c, hv, rv, tv);
      }
      __syncthreads();
      l2_coefs<V>(st, coef, rows, d, warp, lane);
      __syncthreads();
    }

    for (int tile = 0; tile < p.n_tiles; ++tile) {
      const int c = (tile * p.tc + col) * V;
      if (!in_group || c >= d) continue;
      if (p.n_tiles > 1) {
        ldv<V>(hv, h + c);
        ldv<V>(rv, r + c);
        ldv<V>(tv, t + c);
      }
      if (p.wide || i == 0) {
        if (i == 0 && g == 0) {
          // the positive's term, formed as the plain version forms it
          const float c0 = coef[0];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (MODEL == DISTMULT) {
              a_h[v] = c0 * (rv[v] * tv[v]);
              a_r[v] = c0 * (hv[v] * tv[v]);
              a_t[v] = c0 * (hv[v] * rv[v]);
            } else {
              const float gx0 = grad_x<MODEL>(c0, (hv[v] + rv[v]) - tv[v]);
              a_h[v] = gx0;
              a_r[v] = gx0;
              a_t[v] = -gx0;
            }
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) a_h[v] = a_r[v] = a_t[v] = 0.0f;
        }
      }
      chunk_rows<MODEL, V>(st, coef, s_ch, rows, g, p.groups, d, c, hv, rv,
                           tv, a_h, a_r, a_t);
      if (p.wide) {
        // this chunk's fp32 partial into the fp64 running sums
        double* w = wide + ((size_t)(g * p.n_tiles + tile) * p.tc + col) * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          w[v] = (i ? w[v] : 0.0) + a_h[v];
          w[slots + v] = (i ? w[slots + v] : 0.0) + a_r[v];
          w[2 * slots + v] = (i ? w[2 * slots + v] : 0.0) + a_t[v];
        }
      }
    }

    // grad neg of the chunk, from the stage to global memory
    if (p.bulk) {
      fence_proxy_async();
      __syncthreads();
      if (tid == 0)
        bulk_store(gslab + (size_t)k0 * d, smem_u32(st), rows * d * 4);
    } else {
      __syncthreads();
      float* out = gslab + (size_t)k0 * d;
      for (int e = tid; e < rows * d; e += BWD_THREADS) out[e] = st[e];
    }
    if (i + 2 < p.n_chunks) {      // refill this stage with chunk i + 2
      if (p.bulk) {
        if (tid == 0) bulk_wait_read();
      } else {
        __syncthreads();
      }
      issue(i + 2);
    }
    __syncthreads();               // coef, s_ch and the sums are complete
  }

  if (p.wide) {
    // the groups' fp64 sums in a fixed pairwise tree (one tile), then out
    const bool active = in_group && col * V < d;
    for (int s = 1; s < p.groups; s <<= 1) {
      if (active && g % (2 * s) == 0 && g + s < p.groups) {
        double* w = wide + ((size_t)g * p.tc + col) * V;
        const double* o = w + (size_t)s * p.tc * V;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int v = 0; v < V; ++v) w[q * slots + v] += o[q * slots + v];
      }
      __syncthreads();
    }
    if (g == 0) {
      for (int tile = 0; tile < p.n_tiles; ++tile) {
        const int c = (tile * p.tc + col) * V;
        if (c >= d) continue;
        const double* w = wide + ((size_t)tile * p.tc + col) * V;
        float x[V];
        float* outs[3] = {gh, gr, gt};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = (float)w[q * slots + v];
          stv<V>(outs[q] + c, x);
        }
      }
    }
  } else {
    const int c = col * V;
    const bool active = in_group && c < d;
    if (p.groups == 1) {
      if (active) {
        stv<V>(gh + c, a_h);
        stv<V>(gr + c, a_r);
        stv<V>(gt + c, a_t);
      }
    } else {
      float* scratch = reinterpret_cast<float*>(sums);
      group_tree<V>(scratch, a_h, active, g, p.groups, p.tc, col, gh + c);
      group_tree<V>(scratch, a_r, active, g, p.groups, p.tc, col, gr + c);
      group_tree<V>(scratch, a_t, active, g, p.groups, p.tc, col, gt + c);
    }
  }
  if (p.bulk && tid == 0) bulk_wait_all();
}

// model: 0 TransE-L1, 1 TransE-L2, 2 DistMult.  One block per positive.
int forward_launch(const float* h, const float* r, const float* t,
                   const float* neg, const unsigned char* ch, int B, int K,
                   int d, int model, float* pos, float* negs, void* stream) {
  const size_t smem = 3 * (size_t)d * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case TRANSE_L1:
      kge_forward_kernel<TRANSE_L1><<<B, FWD_THREADS, smem, s>>>(
          h, r, t, neg, ch, K, d, pos, negs);
      break;
    case TRANSE_L2:
      kge_forward_kernel<TRANSE_L2><<<B, FWD_THREADS, smem, s>>>(
          h, r, t, neg, ch, K, d, pos, negs);
      break;
    case DISTMULT:
      kge_forward_kernel<DISTMULT><<<B, FWD_THREADS, smem, s>>>(
          h, r, t, neg, ch, K, d, pos, negs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The plan of one backward launch and its shared memory in bytes (at
// most MAX_BWD_SMEM).
BwdPlan backward_plan(const float* neg, const float* gneg, int K, int d,
                      int V, size_t* smem) {
  BwdPlan p;
  p.K = K;
  p.d = d;
  const int dc = d / V;          // vector columns
  if (dc >= BWD_THREADS) {
    p.groups = 1;
    p.tc = BWD_THREADS;
    p.n_tiles = (dc + BWD_THREADS - 1) / BWD_THREADS;
  } else {
    p.groups = BWD_THREADS / dc;
    p.tc = dc;
    p.n_tiles = 1;
  }
  const long long slab = (long long)K * d;
  int kc;
  if (slab <= SPLIT_SLAB_FLOATS && K <= 2 * MAX_CHUNK_ROWS) {
    kc = (K + 1) / 2;            // two chunks: compute one, load the other
  } else {
    kc = RING_STAGE_FLOATS / d;  // >= 1: d <= 4096
    if (kc > MAX_CHUNK_ROWS) kc = MAX_CHUNK_ROWS;
  }
  bool bulk = aligned16(neg) && aligned16(gneg) && slab % 4 == 0;
  if (bulk && kc < K && (kc * d) % 4 != 0) {
    if (kc >= 4)
      kc -= kc % 4;              // every chunk a multiple of 16 bytes
    else
      bulk = false;
  }
  p.kc = kc;
  p.n_chunks = (K + kc - 1) / kc;
  p.bulk = bulk ? 1 : 0;
  // fp32 partials a thread sums in registers: at most MAX_REG_ROWS rows
  p.wide = p.n_tiles > 1 || (K + p.groups - 1) / p.groups > MAX_REG_ROWS;
  p.stage_floats = (kc * d + 3) / 4 * 4;
  size_t off = (size_t)(p.n_chunks > 1 ? 2 : 1) * p.stage_floats * 4;
  p.off_bar = (int)off;
  off += 16;
  p.off_coef = (int)off;
  off += ((size_t)(kc + 1) * 4 + 15) / 16 * 16;
  p.off_sums = (int)off;
  const size_t slots = (size_t)p.groups * p.n_tiles * p.tc * V;
  if (p.wide)
    off += 3 * slots * sizeof(double);
  else if (p.groups > 1)
    off += slots * sizeof(float);
  p.off_ch = (int)off;
  off += ((size_t)kc + 15) / 16 * 16;
  *smem = off;
  return p;
}

// Once per kernel and device: allow up to MAX_BWD_SMEM of dynamic shared
// memory, and prefer the largest carveout (8 blocks of 26.7 KB an SM at
// the training shape).  A device past MAX_DEVICES sets them on every
// launch.
constexpr int MAX_DEVICES = 64;

template <int MODEL, int V>
cudaError_t launch_backward(const float* h, const float* r, const float* t,
                            const float* neg, const unsigned char* ch,
                            const float* g_pos, const float* g_negs, int B,
                            const BwdPlan& p, size_t smem, float* gh,
                            float* gr, float* gt, float* gneg,
                            cudaStream_t s) {
  static bool configured[MAX_DEVICES] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (!cached || !configured[dev]) {
    e = cudaFuncSetAttribute(kge_backward_kernel<MODEL, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_BWD_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kge_backward_kernel<MODEL, V>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (cached) configured[dev] = true;
  }
  kge_backward_kernel<MODEL, V><<<B, BWD_THREADS, smem, s>>>(
      h, r, t, neg, ch, g_pos, g_negs, p, gh, gr, gt, gneg);
  return cudaGetLastError();
}

template <int MODEL>
cudaError_t launch_backward_v(bool vec, const float* h, const float* r,
                              const float* t, const float* neg,
                              const unsigned char* ch, const float* g_pos,
                              const float* g_negs, int B, int K, int d,
                              float* gh, float* gr, float* gt, float* gneg,
                              cudaStream_t s) {
  size_t smem;
  const BwdPlan p = backward_plan(neg, gneg, K, d, vec ? 4 : 1, &smem);
  if (vec)
    return launch_backward<MODEL, 4>(h, r, t, neg, ch, g_pos, g_negs, B, p,
                                     smem, gh, gr, gt, gneg, s);
  return launch_backward<MODEL, 1>(h, r, t, neg, ch, g_pos, g_negs, B, p,
                                   smem, gh, gr, gt, gneg, s);
}

int backward_launch(const float* h, const float* r, const float* t,
                    const float* neg, const unsigned char* ch,
                    const float* g_pos, const float* g_negs, int B, int K,
                    int d, int model, float* gh, float* gr, float* gt,
                    float* gneg, void* stream) {
  // float4 rows: d a multiple of 4 and every row operand 16-byte aligned
  const bool vec = d % 4 == 0 && aligned16(h) && aligned16(r) &&
                   aligned16(t) && aligned16(gh) && aligned16(gr) &&
                   aligned16(gt);
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case TRANSE_L1:
      return (int)launch_backward_v<TRANSE_L1>(vec, h, r, t, neg, ch, g_pos,
                                               g_negs, B, K, d, gh, gr, gt,
                                               gneg, s);
    case TRANSE_L2:
      return (int)launch_backward_v<TRANSE_L2>(vec, h, r, t, neg, ch, g_pos,
                                               g_negs, B, K, d, gh, gr, gt,
                                               gneg, s);
    case DISTMULT:
      return (int)launch_backward_v<DISTMULT>(vec, h, r, t, neg, ch, g_pos,
                                              g_negs, B, K, d, gh, gr, gt,
                                              gneg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The entry points take their arguments packed as 64-bit integers, in
// the order of the launch functions above (pointers, then ints, then the
// stream): one argument for ctypes to convert instead of twelve or
// sixteen, which is most of a call's host time.
extern "C" {

int kge_score_forward(const long long* a) {
  return forward_launch((const float*)a[0], (const float*)a[1],
                        (const float*)a[2], (const float*)a[3],
                        (const unsigned char*)a[4], (int)a[5], (int)a[6],
                        (int)a[7], (int)a[8], (float*)a[9], (float*)a[10],
                        (void*)a[11]);
}

int kge_score_backward(const long long* a) {
  return backward_launch((const float*)a[0], (const float*)a[1],
                         (const float*)a[2], (const float*)a[3],
                         (const unsigned char*)a[4], (const float*)a[5],
                         (const float*)a[6], (int)a[7], (int)a[8], (int)a[9],
                         (int)a[10], (float*)a[11], (float*)a[12],
                         (float*)a[13], (float*)a[14], (void*)a[15]);
}

}  // extern "C"
