// Sliding-window GQA flash attention for Hopper (sm_90a), forward: the
// attention of every layer of every h2o-danube prefill in the port.
//
// Replaces the TPU kernel src/repro/kernels/swa_attention.py::
// swa_attention_pallas (kernel body _swa_kernel).
//
// Contract (plain version: kernels/ref.py::swa_attention_ref on the
// folded layout), heads folded into the leading dim:
//   q (BHq, Sq, d), k and v (BHkv, Skv, d), all fp32 or all bf16,
//   contiguous; BHq a multiple of BHkv, kv row = q row / (BHq / BHkv);
//   key j is visible to query i iff  q_offset + i - window < j <= q_offset + i
//   (and j < Skv); scores scaled by d^-1/2; softmax in fp32;
//   o (BHq, Sq, d) in q's dtype; a row that sees no key is 0.
//   d in {16, 32, 64, 80, 128}; any Sq, Skv >= 1, window >= 1,
//   q_offset >= 0: ragged tiles are masked here, nothing is padded.
//
// Arithmetic:
//   * bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators; bf16 products are exact in fp32).  The scale is
//     applied to the fp32 scores; p is rounded to bf16 before P.V, as the
//     reference model path does (models/attention.py); l sums the fp32 p.
//   * fp32: FP32 FMA on the CUDA cores, no TF32 anywhere.
//   Masked scores are -1e30 and their probabilities are set to 0
//   explicitly, so a row whose first visited tile is wholly masked does
//   not pick up exp(0) = 1 (the Pallas kernel and models/attention.py do
//   the same).
//
// What bounds it on an H100: at h2o-danube's layer shape (B = 2, 32 q
// heads, 8 kv heads, S = 6144, W = 4096, d = 80) each head sees 16.8 M
// (query, key) pairs: 4 * d * pairs = 343.6 GFLOP per call, 0.347 ms at
// 989 TFLOP/s bf16, while q, k, v and o are 157 MB, 0.047 ms at
// 3.35 TB/s.  The tensor cores bound it.  Design, simple and right first:
//   * one block of 4 warps per (64-query tile, q head); each warp owns 16
//     query rows and keeps q (bf16: as mma A fragments), the online-softmax
//     state (m, l) and the output accumulator in registers, fp32;
//   * the block loops only over the 64-key tiles that meet its band
//     [q_lo - W + 1, q_hi] (the Pallas grid visits every kv block and
//     masks it): 4,160 of the 9,216 tiles per head at the shape above;
//     a warp skips a tile that misses its own 16 rows' band;
//   * K and V tiles of the head's kv row are staged in shared memory with
//     cp.async, double-buffered, zero-filled past Skv; V's B fragments
//     come from ldmatrix.trans;
//   * q tiles are scheduled heaviest first, and the q heads that share a
//     kv row are neighbours in the grid, so their K/V tiles meet in L2.
// Later work: wgmma with TMA-fed tiles, a persistent schedule.
//
// The entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block, 16 per warp
constexpr int BK = 64;         // keys per kv tile
constexpr int THREADS = 128;   // 4 warps
constexpr int NT = BK / 8;     // 8-key column tiles of a score fragment
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// elements per 16-byte chunk; a shared row is padded by one chunk so
// the rows of a fragment load fall in different banks
template <typename T>
constexpr int VEC = 16 / (int)sizeof(T);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row
// addresses of matrix i; r[i] is matrix i's B fragment half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [key0, key0 + BK) of one kv head's K and V in shared memory
// (row stride LD elements); rows at or past skv are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(T* sk, T* sv, const T* kh,
                                             const T* vh, int key0, int skv) {
  constexpr int V = VEC<T>, LD = HD + V, CHUNKS = HD / V;
  for (int c = threadIdx.x; c < BK * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * V;
    const int key = key0 + r;
    const bool ok = key < skv;
    const size_t off = (size_t)(ok ? key : 0) * HD + col;
    cp_async16(sk + r * LD + col, kh + off, ok);
    cp_async16(sv + r * LD + col, vh + off, ok);
  }
}

// The score fragment s[nt][e] of a warp holds row (g + 8 * (e >> 1)),
// column (8 * nt + 2 * t + (e & 1)) of its 16 x BK tile, g = lane / 4,
// t = lane % 4: the mma accumulator layout, used by both paths.
//
// Mask and scale one tile of scores, then fold it into the online softmax:
// m and l (this lane's part of the row sum) are updated, alpha gets the
// factor the accumulator must be rescaled by, s becomes p.
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               int key_base, int qpos0,
                                               int window, int skv,
                                               float scale) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key_base + 8 * nt + (e & 1);
      const int qp = qpos0 + 8 * (e >> 1);
      const bool ok = key <= qp && qp - key < window && key < skv;
      const float x = ok ? s[nt][e] * scale : NEG;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = s[nt][e] > 0.5f * NEG ? expf(s[nt][e] - m[r]) : 0.0f;
      s[nt][e] = p;
      sum[r] += p;
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// ---- bf16: tensor cores ------------------------------------------------ //
template <int HD>
__device__ __forceinline__ void scores_bf16(float (&s)[NT][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const __nv_bfloat16* sk, int g,
                                            int t) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const __nv_bfloat16* krow = sk + (8 * nt + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + 16 * kk);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8);
      mma_bf16(s[nt], qa[kk], b0, b1);
    }
  }
}

template <int HD>
__device__ __forceinline__ void pv_bf16(float (&acc)[HD / 8][4],
                                        const float (&p)[NT][4],
                                        const __nv_bfloat16* sv, int lane) {
  constexpr int LD = HD + 8;
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    // the accumulator layout of two 8-key score tiles is the A layout of
    // one 16-key step of P
    const uint32_t pa[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                            pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                            pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                            pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
    // matrix mat: keys 16 ks + 8 (mat & 1) + [0, 8), dims 8 (mat >> 1) + [0, 8)
    const __nv_bfloat16* base =
        sv + (16 * ks + 8 * (mat & 1) + r) * LD + 8 * (mat >> 1);
#pragma unroll
    for (int nd = 0; nd < HD / 16; ++nd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + 16 * nd);
      mma_bf16(acc[2 * nd], pa, b[0], b[1]);
      mma_bf16(acc[2 * nd + 1], pa, b[2], b[3]);
    }
  }
}

// ---- fp32: CUDA-core FMA, same fragment layout --------------------------- //
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int HD>
__device__ __forceinline__ void scores_f32(float (&s)[NT][4], const float* sq,
                                           const float* sk, int row, int t) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
  const float* qa = sq + row * LD;
  const float* qb = qa + 8 * LD;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qa + d);
    const float4 b = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* k0 = sk + (8 * nt + 2 * t) * LD + d;
      const float4 x = *reinterpret_cast<const float4*>(k0);
      const float4 y = *reinterpret_cast<const float4*>(k0 + LD);
      s[nt][0] = dot4(s[nt][0], a, x);
      s[nt][1] = dot4(s[nt][1], a, y);
      s[nt][2] = dot4(s[nt][2], b, x);
      s[nt][3] = dot4(s[nt][3], b, y);
    }
  }
}

template <int HD>
__device__ __forceinline__ void pv_f32(float (&acc)[HD / 8][4],
                                       const float (&p)[NT][4], const float* sv,
                                       int lane) {
  constexpr int LD = HD + 4;
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // p of key 8 nt + 2 tp + i for rows g and g + 8 sits in lane
        // (g, tp) of this quad
        const float p0 = __shfl_sync(FULL, p[nt][i], quad + tp);
        const float p1 = __shfl_sync(FULL, p[nt][2 + i], quad + tp);
        const float* vrow = sv + (8 * nt + 2 * tp + i) * LD + 2 * t;
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 8 * nd);
          acc[nd][0] = fmaf(p0, x.x, acc[nd][0]);
          acc[nd][1] = fmaf(p0, x.y, acc[nd][1]);
          acc[nd][2] = fmaf(p1, x.x, acc[nd][2]);
          acc[nd][3] = fmaf(p1, x.y, acc[nd][3]);
        }
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
swa_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int sq,
                   int skv, int group, int window, int q_offset,
                   float scale) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = HD + VEC<T>;
  constexpr int TILE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* s_q = smem;                                  // fp32 only: BQ x LD
  T* s_kv = BF16 ? smem : smem + BQ * LD;         // 2 x (K tile, V tile)

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const T* qh = q + (size_t)head * sq * HD;
  const T* kh = k + (size_t)(head / group) * skv * HD;
  const T* vh = v + (size_t)(head / group) * skv * HD;
  T* oh = o + (size_t)head * sq * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;                 // rows row0, row0 + 8
  const int qpos0 = q_offset + q0 + row0;

  // keys any row of the block sees, and those of this warp's rows
  const int k_lo = max(0, q_offset + q0 - window + 1);
  const int k_hi = min(skv - 1, q_offset + min(q0 + BQ, sq) - 1);
  const int w_first = q0 + warp * 16;
  const bool warp_live = w_first < sq;
  const int wk_lo = q_offset + w_first - window + 1;
  const int wk_hi = q_offset + min(w_first + 15, sq - 1);
  const int tile0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - tile0 + 1 : 0;

  if constexpr (!BF16) {
    constexpr int CH = HD / 4;
    for (int c = threadIdx.x; c < BQ * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 4;
      const bool ok = q0 + r < sq;
      cp_async16(s_q + r * LD + col, qh + (size_t)(ok ? q0 + r : 0) * HD + col,
                 ok);
    }
  }
  if (n_tiles > 0)
    load_kv_tile<T, HD>(s_kv, s_kv + TILE, kh, vh, tile0 * BK, skv);
  cp_async_commit();

  uint32_t qa[BF16 ? HD / 16 : 1][4];
  if constexpr (BF16) {
    // A fragments of this warp's 16 query rows: rows row0 / row0 + 8,
    // columns 16 kk + 2 t (+ 8); rows past sq are zero
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + row0 + 8 * (j & 1);
        const int col = 16 * kk + 2 * t + 8 * (j >> 1);
        qa[kk][j] = r < sq ? *reinterpret_cast<const uint32_t*>(
                                 qh + (size_t)r * HD + col)
                           : 0u;
      }
    }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    T* sk = s_kv + (i & 1) * 2 * TILE;
    if (i + 1 < n_tiles) {
      T* nk = s_kv + ((i + 1) & 1) * 2 * TILE;
      load_kv_tile<T, HD>(nk, nk + TILE, kh, vh, (tile0 + i + 1) * BK, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = (tile0 + i) * BK;
    if (warp_live && key0 <= wk_hi && key0 + BK - 1 >= wk_lo) {
      float s[NT][4], alpha[2];
      if constexpr (BF16)
        scores_bf16<HD>(s, qa, sk, g, t);
      else
        scores_f32<HD>(s, s_q, sk, row0, t);
      online_softmax(s, m, l, alpha, key0 + 2 * t, qpos0, window, skv, scale);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
      }
      if constexpr (BF16)
        pv_bf16<HD>(acc, s, sk + TILE, lane);
      else
        pv_f32<HD>(acc, s, sk + TILE, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(FULL, l[r], 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const int qi = q0 + row0 + 8 * r;
    if (qi >= sq) continue;
    const float den = fmaxf(lt, 1e-30f);
    T* orow = oh + (size_t)qi * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const float a = acc[nd][2 * r] / den, b = acc[nd][2 * r + 1] / den;
      if constexpr (BF16)
        *reinterpret_cast<uint32_t*>(orow + 8 * nd) = pack_bf16(a, b);
      else
        *reinterpret_cast<float2*>(orow + 8 * nd) = make_float2(a, b);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bhq,
           int bhkv, int sq, int skv, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = HD + VEC<T>;
  constexpr size_t smem = ((BF16 ? 0 : BQ * LD) + 4 * BK * LD) * sizeof(T);
  auto kern = swa_forward_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(bhq, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, bhq / bhkv,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int bhq, int bhkv, int sq, int skv, int window, int q_offset,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: q, k, v, o (device pointers), bhq, bhkv, sq, skv, hd, window,
// q_offset, is_bf16 (1 for bf16 tensors, 0 for fp32), stream.  The scale
// hd^-1/2 is rounded once to fp32 here.
extern "C" int swa_attention_forward(const long long* a) {
  const int hd = (int)a[8];
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  const void *q = (const void*)a[0], *k = (const void*)a[1],
             *v = (const void*)a[2];
  void* o = (void*)a[3];
  const int bhq = (int)a[4], bhkv = (int)a[5], sq = (int)a[6],
            skv = (int)a[7], window = (int)a[9], q_offset = (int)a[10];
  cudaStream_t s = (cudaStream_t)a[12];
  if (a[11])
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, bhq, bhkv, sq, skv, window,
                                   q_offset, scale, s);
  return dispatch<float>(hd, q, k, v, o, bhq, bhkv, sq, skv, window, q_offset,
                         scale, s);
}
