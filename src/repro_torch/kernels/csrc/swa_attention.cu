// Sliding-window GQA flash attention for Hopper (sm_90a): the attention
// of every layer of every h2o-danube prefill and training step in the
// port, forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/swa_attention.py::
// swa_attention_pallas (kernel body _swa_kernel).  The backward has no
// Pallas counterpart: the reference differentiates its jnp scan
// (src/repro/models/attention.py::swa_attention); it is described at
// "backward" below.
//
// Contract (plain version: kernels/ref.py::swa_attention_ref on the
// folded layout), heads folded into the leading dim:
//   q (BHq, Sq, d), k and v (BHkv, Skv, d), all fp32 or all bf16,
//   contiguous; BHq a multiple of BHkv, kv row = q row / (BHq / BHkv);
//   key j is visible to query i iff  q_offset + i - window < j <= q_offset + i
//   (and j < Skv); scores scaled by d^-1/2; softmax in fp32;
//   o (BHq, Sq, d) in q's dtype; a row that sees no key is 0.
//   Optionally lse (BHq, Sq) fp32: ln sum_j exp(scale q_i.k_j) over the
//   visible keys, -inf for a row that sees none (training saves it for
//   the backward; prefill passes no pointer).
//   d in {16, 32, 64, 80, 128, 256}; any Sq, Skv >= 1, window >= 1,
//   q_offset >= 0: ragged tiles are masked here, nothing is padded.
//
// Arithmetic:
//   * bf16: both products on the tensor cores (wgmma, fp32 accumulators;
//     bf16 products are exact in fp32).  The scale is applied to the fp32
//     scores (folded into exp2 with log2 e); p is rounded to bf16 before
//     P.V, as the reference model path does (models/attention.py), while
//     l sums the fp32 p.
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
// 3.35 TB/s.  The tensor cores bound it; next come the exp2 of every
// visible pair (16 a clock per SM) and the softmax's other FP32 work.
//
// The tile plan (both kernels; swa_attention.py::swa_tile_plan replays
// it): a block of query rows visits only the BK-key tiles that meet the
// keys its real rows see together, [q_offset + first - W + 1,
// q_offset + last] cut to [0, Skv); a tile in which every (real row, key)
// pair is visible is interior and skips the mask, and only the tiles on
// the diagonal, the window's lower edge and Skv's edge compute it: 2 of
// ~66 per 64-row block at W = 4096 and S = 6144.
//
// bf16 design (swa_bf16_kernel): one CTA per (128-query tile, q head) of
// two consumer warpgroups, 64 rows each, and one producer warp; 2^x of
// the softmax on the SFU (ex2.approx) with scale * log2 e folded in.
//   * The producer loads the Q tile once and keeps a STAGES-deep ring of
//     K and V tiles (BK keys) in flight with TMA, one full and one empty
//     mbarrier per stage; the consumers' eight warps each release a
//     stage after their last wgmma on it has completed.
//   * S = Q K^T is wgmma with both operands in shared memory (K-major),
//     d / 16 k-steps; O += P V is wgmma with P from registers: the S
//     accumulator's layout, packed to bf16, is wgmma's A-fragment layout
//     (two 8-key column blocks make one 16-key k-step); V is read through
//     MN-major ("transposed-B") descriptors, N = a panel's width.
//   * q tiles run heaviest first, and the q heads that share a kv row
//     are neighbours in the grid, so their K/V tiles meet in L2.
// Where the trouble lies, and what the design does about it:
//   * d = 80 and TMA swizzle: a 160 B row is wider than a 128 B swizzle
//     span, so d is loaded in panels, each its own TMA box and swizzle:
//     64-column panels with 128 B swizzle, then a 16- or 32-column tail
//     with 32 B or 64 B swizzle (d = 128 is two 64-column panels).  Each
//     panel has its own wgmma descriptors: k-steps of Q K^T walk the
//     panels, and P V issues one instruction per panel (N = 64 or the
//     tail's width), into that panel's columns of O.
//   * Zero-fill stops at the head: each map is 3-D (d, S, rows of the
//     folded tensor), so keys past Skv and queries past Sq are out of
//     bounds and come back zero instead of the next head's rows; O is
//     stored from registers, row by row, only for rows below Sq.
//   * Tensor maps on the host: cuTensorMapEncodeTiled is a driver
//     function, reached through cudaGetDriverEntryPoint so the library
//     needs no -lcuda; the maps are encoded per call (microseconds
//     against a millisecond-long call) and passed as a
//     __grid_constant__ parameter beside the scalar arguments.  The
//     wrapper keeps its checks on 16 B alignment and contiguity, which
//     TMA needs.
//   * Register pressure: S is 64 x BK fp32 per warpgroup (32 a thread),
//     O 64 x d (d / 2 a thread), P 16 registers.  Occupancy matters more
//     than overlap inside a warpgroup: with two CTAs an SM (four consumer
//     warpgroups), one warpgroup's softmax runs while another's wgmma
//     does.  A software-pipelined loop (S of tile i beside P V of tile
//     i - 1) needs more registers than two CTAs an SM leave at d = 80,
//     and at one CTA an SM it was not faster on an H100.  So d <= 80 is
//     bounded to two CTAs (ptxas
//     then gives d = 80 90 registers and 128 B of spills), d = 128 runs
//     one (147 registers, no spills); the producer is a single warp, so
//     there is no setmaxnreg split.  Read -Xptxas=-v (chip_smoke.py's
//     build phase prints it) for spills.
//   * d = 256 (recurrentgemma-2b): O alone is 128 registers a thread and
//     a 3-stage ring does not fit (Q 64 KB + 3 x 64 KB of K and V).  So
//     the ring has 2 stages (193 KB in all) and the producer is a
//     warpgroup that hands its registers to the consumers with
//     setmaxnreg (40 / 232), as the backward's (Fwd<HD>).
//   * Build time: the kernel is instantiated for 6 head dims; TMA and
//     wgmma need no extra headers beyond cuda.h's types.
//
// fp32 design (swa_f32_kernel, unchanged in shape): one block of 4 warps
// per (64-query tile, q head), each warp 16 query rows with q, the
// online-softmax state and the output accumulator in registers; K and V
// tiles staged with cp.async, double-buffered (one buffer at d = 256,
// where two would need 325 KB), zero-filled past Skv; the same tile plan,
// so interior tiles skip the mask.
//
// Each entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

typedef unsigned long long u64;

constexpr int BK = 64;         // keys per kv tile (both kernels)
constexpr int NT = BK / 8;     // 8-key column blocks of a score tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// ---- the tile plan ----------------------------------------------------- //
// Keys [band_lo, band_hi] are what the real rows [first, last] see
// together (none when band_lo > band_hi).
__device__ __forceinline__ int band_lo(int first, int q_offset, int window) {
  return max(0, q_offset + first - window + 1);
}

__device__ __forceinline__ int band_hi(int last, int q_offset, int skv) {
  return min(skv - 1, q_offset + last);
}

// Every pair of real rows [first, last] x keys [k0, k0 + BK) is visible.
__device__ __forceinline__ bool tile_interior(int k0, int first, int last,
                                              int q_offset, int window,
                                              int skv) {
  return k0 + BK - 1 <= q_offset + first &&
         k0 >= q_offset + last - window + 1 && k0 + BK <= skv;
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22); -1e30-like inputs
// give 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The score tile of a warp is the mma / wgmma accumulator layout: s[4 j +
// e] holds row g + 8 (e >> 1), key 8 j + 2 t + (e & 1) of its 16 rows x
// BK keys, g = lane / 4, t = lane % 4.
//
// Mask (unless the tile is interior) and fold one tile of scores into the
// online softmax: m (raw-score maximum) and l (this lane's part of the
// row sum) are updated, alpha gets the factor the accumulator must be
// rescaled by, s becomes p.  scale_log2 = d^-1/2 * log2 e.
__device__ __forceinline__ void online_softmax(float (&s)[4 * NT],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               bool interior, int key_base,
                                               int qpos0, int window, int skv,
                                               float scale_log2) {
  if (!interior) {
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) {
      const int key = key_base + 8 * (e >> 2) + (e & 1);
      const int qp = qpos0 + 8 * ((e >> 1) & 1);
      const bool ok = key <= qp && qp - key < window && key < skv;
      s[e] = ok ? s[e] : NEG;
    }
  }
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    mc[r] = m_new * scale_log2;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) {
    const int r = (e >> 1) & 1;
    const float p = (interior || s[e] > 0.5f * NEG)
                        ? fast_exp2(fmaf(s[e], scale_log2, -mc[r]))
                        : 0.0f;
    s[e] = p;
    sum[r] += p;
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// A row's log-sum-exp of the scaled scores, in natural-log units, from
// its raw-score maximum m and its sum lt of 2^(s * scale_log2 - m *
// scale_log2): ln(sum_j exp(scale * s_j)) = (m * scale_log2 + log2 lt) *
// ln 2.  -inf for a row that sees no key.
__device__ __forceinline__ float row_lse(float m, float lt, float scale_log2) {
  return lt > 0.0f ? (m * scale_log2 + log2f(lt)) * LN2 : -INFINITY;
}

// ---- bf16: TMA, mbarriers, wgmma ---------------------------------------- //
constexpr int BQ = 128;            // queries per CTA: two warpgroups of 64
constexpr int STAGES = 3;          // K/V ring depth
constexpr int CONSUMER_WARPS = 8;
constexpr int BF16_THREADS = 32 * CONSUMER_WARPS + 32;   // + the producer

// d in panels: NF full 64-column panels (128 B rows, 128 B swizzle),
// then a tail of TW = 16 or 32 columns (32 B or 64 B rows and swizzle).
// A tile of `rows` rows stores its panels one after another, each
// rows x row-bytes, full panels first; every panel starts on a multiple
// of 1024 B, the 128 B swizzle's period.
template <int HD>
struct Panels {
  static constexpr int NF = HD / 64;
  static constexpr int TW = HD % 64;
  static_assert(TW == 0 || TW == 16 || TW == 32, "d must be 16, 32 or 64k (+16/32)");
  // a tile of `rows` rows, all panels
  __host__ __device__ static constexpr int bytes(int rows) { return rows * HD * 2; }
  __host__ __device__ static constexpr int offset(int p, int rows) {
    return rows * 128 * p;
  }
};

// The tensor maps of one call: [0] the 64-column panels, [1] the tail.
struct SwaMaps {
  CUtensorMap q[2], k[2], v[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
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

// One TMA box of a 3-D map at (column, row, folded head) into shared
// memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<u64>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile whose rows are
// `row_bytes` (128, 64 or 32) apart: start address, leading offset 1
// (unused by swizzled layouts), 8-row groups 8 * row_bytes apart, the
// swizzle of that width.
__device__ __forceinline__ u64 smem_desc(uint32_t addr, int row_bytes) {
  const u64 layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)1 << 16) |
         ((u64)((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to this point: the compiler may not read or move them
// across it (wgmma writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n64, fp32) = A B + (scale_d ? d : 0): A (64 x 16) and
// B (16 x 64) bf16 from shared memory through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, u64 desc_a, u64 desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64 x n64, fp32) += A B: A (64 x 16 bf16) from registers, B
// (16 x 64 bf16) from shared memory through a descriptor, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            u64 desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64 x n32, fp32) += A B: A (64 x 16 bf16) from registers, B
// (16 x 32 bf16) from shared memory through a descriptor, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            u64 desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64 x n16, fp32) += A B: A (64 x 16 bf16) from registers, B
// (16 x 16 bf16) from shared memory through a descriptor, MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                            u64 desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One tile of `rows` rows (row r0 of folded head h), every panel of it,
// onto `bar`: [0] maps the 64-column panels, [1] the tail.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int r0,
                                         int h) {
  using P = Panels<HD>;
#pragma unroll
  for (int p = 0; p < P::NF; ++p)
    tma_load_3d(dst + P::offset(p, rows), &map[0], bar, 64 * p, r0, h);
  if (P::TW) tma_load_3d(dst + P::offset(P::NF, rows), &map[1], bar, 64 * P::NF, r0, h);
}

// d (m64 x n64, fp32) = A B^T over the head dim: A the 64 rows from
// `a_row0` of an `a_rows`-row tile, B a 64-row tile, both K-major in
// shared memory; d / 16 k-steps walking the panels.
template <int HD>
__device__ __forceinline__ void wgmma_ss_panels(float* d, uint32_t a_tile,
                                                int a_rows, int a_row0,
                                                uint32_t b_tile) {
  using P = Panels<HD>;
  constexpr int NF = P::NF, TW = P::TW;
#pragma unroll
  for (int p = 0; p < NF; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(d, smem_desc(a_tile + P::offset(p, a_rows) + a_row0 * 128 + 32 * kk, 128),
                   smem_desc(b_tile + P::offset(p, 64) + 32 * kk, 128), p + kk > 0);
  }
  if constexpr (TW > 0) {
    // the tail's rows are 2 TW bytes
    const uint32_t aa = a_tile + P::offset(NF, a_rows) + a_row0 * 2 * TW;
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk)
      wgmma_ss_n64(d, smem_desc(aa + 32 * kk, 2 * TW),
                   smem_desc(b_tile + P::offset(NF, 64) + 32 * kk, 2 * TW),
                   NF + kk > 0);
  }
}

// acc (m64 x HD, fp32) += A B: A one 16-deep k-step from registers, B
// rows [16 kk, 16 kk + 16) of a `rows`-row tile read MN-major, one
// instruction per panel (N = 64 or the tail's width) into its columns.
template <int HD>
__device__ __forceinline__ void wgmma_rs_panels(float* acc, const uint32_t* a,
                                                uint32_t tile, int rows,
                                                int kk) {
  using P = Panels<HD>;
  constexpr int NF = P::NF, TW = P::TW;
#pragma unroll
  for (int p = 0; p < NF; ++p)
    wgmma_rs_n64(acc + 32 * p, a, smem_desc(tile + P::offset(p, rows) + kk * 16 * 128, 128));
  if constexpr (TW == 32)
    wgmma_rs_n32(acc + 32 * NF, a, smem_desc(tile + P::offset(NF, rows) + kk * 16 * 64, 64));
  if constexpr (TW == 16)
    wgmma_rs_n16(acc + 32 * NF, a, smem_desc(tile + P::offset(NF, rows) + kk * 16 * 32, 32));
}

// The score layout (s[4 j + e]: row g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1)) packed to bf16 as wgmma's A fragments: two 8-column blocks
// make one 16-deep k-step.
__device__ __forceinline__ void pack_a(uint32_t (&a)[BK / 16][4],
                                       const float (&s)[4 * NT]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
}

// The score layout split into two bf16 A-fragment sets, hi = bf16(s) and
// lo = bf16(s - hi): hi + lo carries ~16 significant bits, so a product
// taken as A(hi) B + A(lo) B is as exact as B's own bf16 values allow.
__device__ __forceinline__ void split_a(uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4],
                                        const float (&s)[4 * NT]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = s[8 * kk + 2 * c], y = s[8 * kk + 2 * c + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][c] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][c] = pack_bf16(x - hf.x, y - hf.y);
    }
}

// Warp specialisation's register split (setmaxnreg, which every thread
// of a warpgroup executes together): the producer warpgroup drops to
// PRODUCER_REGS, each consumer warpgroup rises to CONSUMER_REGS.  Two
// consumer warpgroups and a producer one (384 threads) start at 168 a
// thread; after the split they hold 2 x 128 x 232 + 128 x 40 of the SM's
// 65,536.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BWD_BF16_THREADS = 32 * CONSUMER_WARPS + 128;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// The forward's CTA by head dim: up to d = 128 one producer warp beside
// the two consumer warpgroups and a STAGES-deep ring; at d = 256 (WIDE) a
// producer warpgroup that gives its registers to the consumers and a
// 2-stage ring, which is what fits 227 KB beside the 64 KB Q tile.
template <int HD>
struct Fwd {
  static constexpr bool WIDE = HD > 128;
  static constexpr int RING = WIDE ? 2 : STAGES;
  static constexpr int THREADS = WIDE ? BWD_BF16_THREADS : BF16_THREADS;
  static constexpr int SMEM = 1024 + Panels<HD>::bytes(BQ) +
                              2 * RING * Panels<HD>::bytes(BK) +
                              8 * (2 * RING + 1);
};

// d <= 80 asks for two CTAs an SM (d = 80: 90 registers, 128 B of
// spills), d = 128 for one (147 registers, no spills), d = 256 for one
// with the register split.
template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::THREADS, HD <= 80 ? 2 : 1)
swa_bf16_kernel(const __grid_constant__ SwaMaps maps,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int skv, int group, int window, int q_offset,
                float scale_log2) {
  using P = Panels<HD>;
  using F = Fwd<HD>;
  constexpr int Q_BYTES = P::bytes(BQ), KV_BYTES = P::bytes(BK);
  extern __shared__ unsigned char smem_bf16[];
  const uint32_t s_q = (smem_u32(smem_bf16) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + Q_BYTES;                // stage s: + s * KV_BYTES
  const uint32_t s_v = s_k + F::RING * KV_BYTES;
  const uint32_t bar_full = s_v + F::RING * KV_BYTES;  // RING barriers
  const uint32_t bar_empty = bar_full + 8 * F::RING;
  const uint32_t bar_q = bar_empty + 8 * F::RING;

  const int head = blockIdx.x, kvh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int k_lo = band_lo(q0, q_offset, window);
  const int k_hi = band_hi(min(q0 + BQ, sq) - 1, q_offset, skv);
  const int tile0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - tile0 + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::RING; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {        // the producer: one thread issues TMA
    if constexpr (F::WIDE) producer_regs();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_tile<HD>(s_q, maps.q, bar_q, BQ, q0, head);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % F::RING;
        if (i >= F::RING) mbar_wait(bar_empty + 8 * s, (i / F::RING - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * KV_BYTES);
        const int key0 = (tile0 + i) * BK;
        tma_tile<HD>(s_k + s * KV_BYTES, maps.k, full, BK, key0, kvh);
        tma_tile<HD>(s_v + s * KV_BYTES, maps.v, full, BK, key0, kvh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  if constexpr (F::WIDE) consumer_regs();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int first = q0 + 64 * wg, last = min(first + 63, sq - 1);
  const bool live = first < sq;
  const int wk_lo = band_lo(first, q_offset, window);
  const int wk_hi = band_hi(last, q_offset, skv);
  const int row0 = first + 16 * (warp % 4) + g;      // rows row0, row0 + 8
  float acc[HD / 2];                 // O: acc[4 j + e] is column 8 j + 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % F::RING;
    mbar_wait(bar_full + 8 * s, (i / F::RING) & 1);
    const int k0 = (tile0 + i) * BK;
    if (live && k0 <= wk_hi && k0 + BK - 1 >= wk_lo) {
      const uint32_t k_t = s_k + s * KV_BYTES, v_t = s_v + s * KV_BYTES;
      float sc[4 * NT];
      wgmma_fence();
      wgmma_ss_panels<HD>(sc, s_q, BQ, 64 * wg, k_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      const bool interior = tile_interior(k0, first, last, q_offset, window, skv);
      float alpha[2];
      online_softmax(sc, m, l, alpha, interior, k0 + 2 * t, q_offset + row0,
                     window, skv, scale_log2);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[BK / 16][4];       // p rounded to bf16 here
      pack_a(pa, sc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_panels<HD>(acc, pa[kk], v_t, BK, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);    // this warp is done with it
  }

  __nv_bfloat16* oh = o + (size_t)head * sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(FULL, l[r], 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    if (lse != nullptr && t == 0) lse[(size_t)head * sq + qi] = row_lse(m[r], lt, scale_log2);
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = oh + (size_t)qi * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

// ---- fp32: CUDA-core FMA ---------------------------------------------- //
constexpr int F32_BQ = 64;         // query rows per block, 16 per warp
constexpr int F32_THREADS = 128;   // 4 warps
constexpr int F32_LD = 4;          // row padding (floats): rows of a
                                   // fragment load fall in different banks

// K/V buffers of the fp32 forward: two (double-buffered) up to d = 128;
// one at d = 256, where two would take 325 KB with the Q tile.
__host__ __device__ constexpr int f32_kv_buffers(int hd) { return hd > 128 ? 1 : 2; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = smem_u32(smem);
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

// Stage rows [key0, key0 + BK) of one kv head's K and V in shared memory
// (row stride HD + F32_LD floats); rows at or past skv are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv_tile(float* sk, float* sv,
                                             const float* kh, const float* vh,
                                             int key0, int skv) {
  constexpr int LD = HD + F32_LD, CHUNKS = HD / 4;
  for (int c = threadIdx.x; c < BK * CHUNKS; c += F32_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 4;
    const int key = key0 + r;
    const bool ok = key < skv;
    const size_t off = (size_t)(ok ? key : 0) * HD + col;
    cp_async16(sk + r * LD + col, kh + off, ok);
    cp_async16(sv + r * LD + col, vh + off, ok);
  }
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int HD>
__device__ __forceinline__ void scores_f32(float (&s)[4 * NT], const float* sq,
                                           const float* sk, int row, int t) {
  constexpr int LD = HD + F32_LD;
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) s[e] = 0.0f;
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
      s[4 * nt] = dot4(s[4 * nt], a, x);
      s[4 * nt + 1] = dot4(s[4 * nt + 1], a, y);
      s[4 * nt + 2] = dot4(s[4 * nt + 2], b, x);
      s[4 * nt + 3] = dot4(s[4 * nt + 3], b, y);
    }
  }
}

template <int HD>
__device__ __forceinline__ void pv_f32(float (&acc)[HD / 2],
                                       const float (&p)[4 * NT],
                                       const float* sv, int lane) {
  constexpr int LD = HD + F32_LD;
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // p of key 8 nt + 2 tp + i for rows g and g + 8 sits in lane
        // (g, tp) of this quad
        const float p0 = __shfl_sync(FULL, p[4 * nt + i], quad + tp);
        const float p1 = __shfl_sync(FULL, p[4 * nt + 2 + i], quad + tp);
        const float* vrow = sv + (8 * nt + 2 * tp + i) * LD + 2 * t;
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 8 * nd);
          acc[4 * nd] = fmaf(p0, x.x, acc[4 * nd]);
          acc[4 * nd + 1] = fmaf(p0, x.y, acc[4 * nd + 1]);
          acc[4 * nd + 2] = fmaf(p1, x.x, acc[4 * nd + 2]);
          acc[4 * nd + 3] = fmaf(p1, x.y, acc[4 * nd + 3]);
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int sq, int skv, int group,
               int window, int q_offset, float scale_log2) {
  constexpr int LD = HD + F32_LD;
  constexpr int TILE = BK * LD;
  constexpr int BUFS = f32_kv_buffers(HD);
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* s_q = reinterpret_cast<float*>(smem_f32);    // F32_BQ x LD
  float* s_kv = s_q + F32_BQ * LD;                     // BUFS x (K tile, V tile)

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_BQ;   // heaviest first
  const float* qh = q + (size_t)head * sq * HD;
  const float* kh = k + (size_t)(head / group) * skv * HD;
  const float* vh = v + (size_t)(head / group) * skv * HD;
  float* oh = o + (size_t)head * sq * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;                 // rows row0, row0 + 8
  const int qpos0 = q_offset + q0 + row0;

  // keys the block's real rows see, and those of this warp's rows
  const int last = min(q0 + F32_BQ, sq) - 1;
  const int k_lo = band_lo(q0, q_offset, window);
  const int k_hi = band_hi(last, q_offset, skv);
  const int w_first = q0 + warp * 16;
  const bool warp_live = w_first < sq;
  const int wk_lo = q_offset + w_first - window + 1;
  const int wk_hi = q_offset + min(w_first + 15, sq - 1);
  const int tile0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - tile0 + 1 : 0;

  {
    constexpr int CH = HD / 4;
    for (int c = threadIdx.x; c < F32_BQ * CH; c += F32_THREADS) {
      const int r = c / CH, col = (c % CH) * 4;
      const bool ok = q0 + r < sq;
      cp_async16(s_q + r * LD + col, qh + (size_t)(ok ? q0 + r : 0) * HD + col,
                 ok);
    }
  }
  if (n_tiles > 0) load_kv_tile<HD>(s_kv, s_kv + TILE, kh, vh, tile0 * BK, skv);
  cp_async_commit();

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    float* sk = s_kv + (BUFS == 2 ? (i & 1) : 0) * 2 * TILE;
    if (BUFS == 1) {
      // one buffer: tile i loads once tile i - 1's readers are done (the
      // barrier that ends each iteration)
      if (i > 0) {
        load_kv_tile<HD>(sk, sk + TILE, kh, vh, (tile0 + i) * BK, skv);
        cp_async_commit();
      }
      cp_async_wait<0>();
    } else if (i + 1 < n_tiles) {
      float* nk = s_kv + ((i + 1) & 1) * 2 * TILE;
      load_kv_tile<HD>(nk, nk + TILE, kh, vh, (tile0 + i + 1) * BK, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = (tile0 + i) * BK;
    if (warp_live && key0 <= wk_hi && key0 + BK - 1 >= wk_lo) {
      float s[4 * NT], alpha[2];
      scores_f32<HD>(s, s_q, sk, row0, t);
      online_softmax(s, m, l, alpha,
                     tile_interior(key0, q0, last, q_offset, window, skv),
                     key0 + 2 * t, qpos0, window, skv, scale_log2);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        acc[4 * nd] *= alpha[0];
        acc[4 * nd + 1] *= alpha[0];
        acc[4 * nd + 2] *= alpha[1];
        acc[4 * nd + 3] *= alpha[1];
      }
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
    if (lse != nullptr && t == 0) lse[(size_t)head * sq + qi] = row_lse(m[r], lt, scale_log2);
    const float den = fmaxf(lt, 1e-30f);
    float* orow = oh + (size_t)qi * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd) =
          make_float2(acc[4 * nd + 2 * r] / den, acc[4 * nd + 2 * r + 1] / den);
  }
}

// ---- host ------------------------------------------------------------- //
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A folded (rows, s, d) bf16 tensor as a 3-D map (d, s, rows): boxes of
// `width` columns x box_rows rows of one folded head, swizzled to the
// width's span; rows past s read as zero.
bool encode(CUtensorMap* map, const void* ptr, int rows, int s, int d,
            int width, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bhq, int bhkv, int sq, int skv, int window,
                int q_offset, float scale, cudaStream_t stream) {
  using P = Panels<HD>;
  SwaMaps maps = {};
  bool ok = true;
  for (int j = 0; j < 2; ++j) {        // [0]: 64-column panels, [1]: tail
    const int width = j == 0 ? 64 : P::TW;
    if (j == 0 ? P::NF == 0 : P::TW == 0) continue;
    ok = ok && encode(&maps.q[j], q, bhq, sq, HD, width, BQ) &&
         encode(&maps.k[j], k, bhkv, skv, HD, width, BK) &&
         encode(&maps.v[j], v, bhkv, skv, HD, width, BK);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const int smem = Fwd<HD>::SMEM;
  auto kern = swa_bf16_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's unified memory as shared memory: only then do two
  // CTAs (83 KB each at d = 80) fit on an SM
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bhq, (sq + BQ - 1) / BQ);
  kern<<<grid, Fwd<HD>::THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), lse, sq, skv, bhq / bhkv,
      window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bhq, int bhkv, int sq, int skv, int window,
               int q_offset, float scale, cudaStream_t stream) {
  constexpr int LD = HD + F32_LD;
  constexpr size_t smem =
      (F32_BQ * LD + 2 * f32_kv_buffers(HD) * BK * LD) * sizeof(float);
  auto kern = swa_f32_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(bhq, (sq + F32_BQ - 1) / F32_BQ);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, skv,
      bhq / bhkv, window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           float* lse, int bhq, int bhkv, int sq, int skv, int window,
           int q_offset, float scale, cudaStream_t s) {
  return bf16 ? launch_bf16<HD>(q, k, v, o, lse, bhq, bhkv, sq, skv, window,
                                q_offset, scale, s)
              : launch_f32<HD>(q, k, v, o, lse, bhq, bhkv, sq, skv, window,
                               q_offset, scale, s);
}

// ---- backward: dQ, dK, dV ---------------------------------------------- //
// The gradient of the forward's contract, with P recomputed from the
// forward's log-sum-exp: for a visible pair (i, j),
//   P_ij = exp(scale q_i.k_j - lse_i),  D_i = dO_i . O_i,
//   dS_ij = P_ij (dO_i . v_j - D_i),
//   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,
//   dQ_i = scale sum_j dS_ij k_j,
// summed over the q heads of a kv row for dK and dV (the GQA fold).
//
// Three kernels a call, each output written exactly once, no atomics,
// every sum in a fixed order (the same bits on every run):
//   * swa_bwd_dot_kernel: D, one warp a row (both dtypes).
//   * dK and dV: one CTA per (kv row, key tile).  K and V stay in shared
//     memory; it walks the q heads of the kv row and, for each, the
//     64-query tiles whose band meets the key tile (the transpose of the
//     forward's plan: keys [k0, k1] are seen by queries [k0 - q_offset,
//     k1 - q_offset + W - 1], in 64 bits), recomputing S and dP for each
//     tile pair; the sum over the q heads stays in the CTA.
//   * dQ: one CTA per (q row, query tile), walking the forward's key tiles.
// Both mask only the tile pairs tile_interior does not call interior;
// rows past Sq read lse = +inf and D = 0 (their p and dS are 0), keys past
// Skv are zero and masked.
//
// What bounds it on an H100: at h2o-danube's layer shape (B = 1, 32 q / 8
// kv heads, S = 6144, W = 4096, d = 80: 537 M visible pairs) the
// function is 10 d operations a visible pair (five products), 0.43
// TFLOP, 0.434 ms at 989 TFLOP/s bf16; its bytes (q, k, v, o, dO, the
// three gradients, lse: 158 MB) take 0.047 ms at 3.35 TB/s.  Two kernels
// recompute S and dP: 14 d a pair, 0.608 ms.  One pass would need dQ
// summed across the key tiles' CTAs: atomics (which break the same-bits
// contract) or per-tile partials (~2.7 GB at this shape).
//
// bf16 (swa_bwd_dkdv_bf16_kernel, swa_bwd_dq_bf16_kernel): the forward's
// machinery, every product on wgmma with fp32 accumulators: a producer
// keeps a STAGES-deep mbarrier ring of 3-D TMA boxes in flight, the
// consumer warpgroups release each stage after their last wgmma on it,
// and d runs in 64-column panels plus a 16- or 32-column tail.
//   * dK/dV: a CTA holds Dkdv::KEYS keys of one kv row, 64 a consumer
//     warpgroup.  The ring streams a (Q, dO) tile pair with its lse and D
//     per (q head, query tile).  A warpgroup computes S^T = K Q^T and
//     dP^T = V dO^T with both operands in shared memory, K-major (the
//     forward's Q K^T with the roles swapped; dP^T's wgmma runs while
//     P^T's exp2s do), P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T =
//     P^T (dP^T - D), lse and D now per column (8 j + 2 t + {0, 1} of the
//     accumulator layout), then dV += P^T dO and dK += dS^T Q with A from
//     registers (the accumulator layout packed to bf16, as the forward's
//     P V) and dO / Q read through the MN-major descriptors of the
//     forward's V.  dK is scaled once at the store.
//   * lse and D are not TMA boxes: a row of Sq floats need not start on
//     16 bytes, and rows past Sq must read +inf and 0, not TMA's zeros.
//     The producer's first warp loads them (two rows a lane, before it
//     waits for the stage), stores them beside the stage's tiles, and
//     each lane arrives on the stage's full barrier: 32 arrivals plus
//     the TMA bytes.
//   * dQ: a CTA of BQ queries (two warpgroups) holds Q and dO; the ring
//     streams K and V tiles.  S = Q K^T and dP = dO V^T smem-smem, dQ +=
//     dS K with dS from registers and K MN-major; lse and D are per row.
//   * Rounding of P and dS: FlashAttention rounds them to bf16 before
//     the products that take them from registers, as the forward rounds
//     P before P V.  Here that alone put the h2o-danube layer's dV past
//     1e-2 (1 + |plain|) of the fp32 plain version (by 0.03125 at |dV| ~
//     2: the early keys, whose P are near 1, sum a few large, rounded
//     terms; an emulation of that rounding on the card used 0.5-0.7 of
//     the tolerance on other seeds).  So each of P^T, dS^T and dS is
//     split into hi = bf16(x) and lo = bf16(x - hi), and dV, dK and dQ
//     take A(hi) B + A(lo) B: ~16 bits of P and dS, at the price of those
//     three products twice (20 d operations a pair in all, 0.869 ms at
//     this shape).  S, dP, lse, D and every sum stay fp32, and each
//     gradient is rounded once, at its store.
//   * Load balance: keys past S - W see fewer queries.  The dK/dV grid
//     runs key tiles in ascending order with the kv rows fastest, so at
//     q_offset = 0 the full-band tiles start first; dQ's query tiles run
//     heaviest first, as the forward's.
//   * d = 256 (recurrentgemma-2b): dK and dV alone would be 128 + 128
//     registers a thread, and a 64-key K and V with a 3-stage ring of
//     64-query Q and dO tiles 256 KB.  So the CTA's two consumer
//     warpgroups share one 64-key tile (dK/dV) or one 64-query tile (dQ)
//     and split d's columns: warpgroup wg computes the whole S and dP
//     (each warpgroup its own, the products taken twice) and keeps the
//     gradients' columns [128 wg, 128 wg + 128), as FlashAttention 3 does
//     at d = 256; the rings have 2 stages (194 KB and 193 KB).
//   * Registers: a dK/dV warpgroup holds S^T and dP^T (32 + 32 a thread),
//     dK and dV (d / 2 + d / 2) and the split fragments (64).  Two
//     consumer warpgroups and a producer warpgroup (384 threads) start at
//     168 registers a thread; the producer drops to 40 and the consumers
//     rise to 232 (setmaxnreg), and ptxas spills nothing.  At d = 128 a
//     dK/dV CTA holds one consumer warpgroup (64 keys) and a producer
//     warp, 160 threads at up to 255 registers.  The dQ kernel takes the
//     same split.  chip_smoke.py's build phase prints each kernel's
//     registers and spills and finds HGMMA in its SASS.
//
// fp32 (swa_bwd_dkdv_f32_kernel, swa_bwd_dq_f32_kernel; not on the
// training path): fp32 FMA on the CUDA cores, no TF32, 8 warps a CTA,
// QR x 64 tile pairs (QR query rows, 64 keys) staged synchronously; each
// thread holds a QR / 16 x 4 block of the score tile, P and dS are staged
// in shared memory (dS transposed for dQ) and the gradients accumulate in
// registers.  QR is 64 up to d = 128 and 32 at d = 256, where 64-row
// tiles of Q, dO, K and V alone would take 266 KB.
constexpr int BWD_THREADS = 256;     // fp32 kernels and bwd_dot: 8 warps
constexpr int BWD_BQ = 64;           // query rows of a tile (QR up to d = 128)
constexpr int BWD_LDS = BK + 16;     // row stride of P, dS [query][key]

// query rows of an fp32 backward tile
__host__ __device__ constexpr int f32_bwd_rows(int hd) { return hd > 128 ? 32 : BWD_BQ; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + ROWS) of one head's (n, HD) matrix into a ROWS x
// (HD + 4) fp32 tile; rows at or past n are zero.
template <int HD, int ROWS = 64>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n) {
  constexpr int LD = HD + F32_LD, CH = HD / 4;
  for (int c = threadIdx.x; c < ROWS * CH; c += BWD_THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) x = ld4(src + (size_t)(row0 + r) * HD + col);
    *reinterpret_cast<float4*>(dst + r * LD + col) = x;
  }
}

// lse (in log2 units) and D of rows [row0, row0 + rows): rows past n get
// +inf and 0, so their p and dS are 0.
__device__ __forceinline__ void load_stats(float* s_l, float* s_d,
                                           const float* lse,
                                           const float* dvec, int row0,
                                           int n, int rows) {
  for (int r = threadIdx.x; r < rows; r += BWD_THREADS) {
    const bool ok = row0 + r < n;
    s_l[r] = ok ? lse[row0 + r] * LOG2E : INFINITY;
    s_d[r] = ok ? dvec[row0 + r] : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T for the thread's QI x 4 pairs of the tile:
// rows tq + 16 i, keys tk + 16 j.
template <int HD, int QI>
__device__ __forceinline__ void scores_bwd(float (&s)[QI][4], float (&dp)[QI][4],
                                           const float* sQ, const float* sK,
                                           const float* sDO, const float* sV,
                                           int tq, int tk) {
  constexpr int LD = HD + F32_LD;
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < HD; c += 4) {
    float4 a[QI], b[4];
#pragma unroll
    for (int i = 0; i < QI; ++i) a[i] = ld4(sQ + (tq + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(sK + (tk + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(s[i][j], a[i], b[j]);
#pragma unroll
    for (int i = 0; i < QI; ++i) a[i] = ld4(sDO + (tq + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(sV + (tk + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(dp[i][j], a[i], b[j]);
  }
}

// s becomes P = 2^(s scale_log2 - lse_log2) on visible pairs (0 on the
// others) and dp becomes dS = P (dp - D).  Tile row r is query q0 + r,
// tile key c is key k0 + c.
template <int QI>
__device__ __forceinline__ void probs_bwd(float (&s)[QI][4], float (&dp)[QI][4],
                                          const float* s_l, const float* s_d,
                                          int tq, int tk, int q0, int k0,
                                          bool interior, int sq, int skv,
                                          int window, int q_offset,
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int r = tq + 16 * i;
    const int qp = q_offset + q0 + r;
    const float l = s_l[r], dd = s_d[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tk + 16 * j;
      const bool ok = interior || (q0 + r < sq && key < skv && key <= qp &&
                                   qp - key < window);
      const float p = ok ? fast_exp2(fmaf(s[i][j], scale_log2, -l)) : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dd);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
swa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ dvec, long long rows, int hd) {
  const long long row =
      (long long)blockIdx.x * (BWD_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // the whole warp leaves
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) dvec[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
swa_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dk,
                        float* __restrict__ dv, int sq, int skv, int group,
                        int window, int q_offset, float scale,
                        float scale_log2) {
  constexpr int QR = f32_bwd_rows(HD), QI = QR / 16;
  constexpr int LD = HD + F32_LD, TILE = 64 * LD, NM = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  float* sK = reinterpret_cast<float*>(smem_bwd);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;                    // QR x LD
  float* sDO = sQ + QR * LD;
  float* sP = sDO + QR * LD;                // QR x BWD_LDS
  float* sS = sP + QR * BWD_LDS;            // dS, the same layout
  float* sL = sS + QR * BWD_LDS;
  float* sD = sL + QR;

  const int kvh = blockIdx.x, k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;   // score tile: rows tq + 16 i, keys tk + 16 j
  const int ka = tid % 16, cb = tid / 16;   // dK, dV: keys 4 ka + r, columns cb + 16 m
  load_rows<HD>(sK, k + (size_t)kvh * skv * HD, k0, skv);
  load_rows<HD>(sV, v + (size_t)kvh * skv * HD, k0, skv);

  float adk[4][NM], adv[4][NM];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < NM; ++m) adk[r][m] = adv[r][m] = 0.0f;

  // the queries that see a key of [k0, k_last]: q_offset + i in
  // [k0, k_last + window - 1], cut to [0, sq)
  const int k_last = min(k0 + BK, skv) - 1;
  const long long lo = max(0LL, (long long)k0 - q_offset);
  const long long hi = min((long long)sq - 1,
                           (long long)k_last - q_offset + window - 1);
  if (lo <= hi) {
    const int t0 = (int)(lo / QR), t1 = (int)(hi / QR);
    for (int h = 0; h < group; ++h) {
      const size_t head = (size_t)kvh * group + h;
      const float* qh = q + head * sq * HD;
      const float* doh = dout + head * sq * HD;
      for (int t = t0; t <= t1; ++t) {
        const int q0 = t * QR, last = min(q0 + QR, sq) - 1;
        __syncthreads();                    // the last tile's readers are done
        load_rows<HD, QR>(sQ, qh, q0, sq);
        load_rows<HD, QR>(sDO, doh, q0, sq);
        load_stats(sL, sD, lse + head * sq, dvec + head * sq, q0, sq, QR);
        __syncthreads();
        float s[QI][4], dp[QI][4];
        scores_bwd<HD, QI>(s, dp, sQ, sK, sDO, sV, tq, tk);
        probs_bwd<QI>(s, dp, sL, sD, tq, tk, q0, k0,
                      tile_interior(k0, q0, last, q_offset, window, skv), sq,
                      skv, window, q_offset, scale_log2);
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sP[(tq + 16 * i) * BWD_LDS + tk + 16 * j] = s[i][j];
            sS[(tq + 16 * i) * BWD_LDS + tk + 16 * j] = dp[i][j];
          }
        __syncthreads();
#pragma unroll 2
        for (int r = 0; r < QR; ++r) {
          const float4 p = ld4(sP + r * BWD_LDS + 4 * ka);
          const float4 d = ld4(sS + r * BWD_LDS + 4 * ka);
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            const float g = sDO[r * LD + cb + 16 * m];
            const float x = sQ[r * LD + cb + 16 * m];
            adv[0][m] = fmaf(p.x, g, adv[0][m]);
            adv[1][m] = fmaf(p.y, g, adv[1][m]);
            adv[2][m] = fmaf(p.z, g, adv[2][m]);
            adv[3][m] = fmaf(p.w, g, adv[3][m]);
            adk[0][m] = fmaf(d.x, x, adk[0][m]);
            adk[1][m] = fmaf(d.y, x, adk[1][m]);
            adk[2][m] = fmaf(d.z, x, adk[2][m]);
            adk[3][m] = fmaf(d.w, x, adk[3][m]);
          }
        }
      }
    }
  }
  // every key of the tile below skv is written, 0 where no query sees it
  float* dkh = dk + (size_t)kvh * skv * HD;
  float* dvh = dv + (size_t)kvh * skv * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 4 * ka + r;
    if (key >= skv) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      dkh[(size_t)key * HD + cb + 16 * m] = scale * adk[r][m];
      dvh[(size_t)key * HD + cb + 16 * m] = adv[r][m];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
swa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, float* __restrict__ dq,
                      int sq, int skv, int group, int window, int q_offset,
                      float scale, float scale_log2) {
  constexpr int QR = f32_bwd_rows(HD), QI = QR / 16;
  // dQ: QA threads across the rows, CB column groups of NM columns
  constexpr int QA = QR / 4, CB = BWD_THREADS / QA, NM = HD / CB;
  constexpr int LD = HD + F32_LD, TILE = 64 * LD, LDT = QR + 4;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  float* sQ = reinterpret_cast<float*>(smem_bwd);   // QR x LD
  float* sDO = sQ + QR * LD;
  float* sK = sDO + QR * LD;
  float* sV = sK + TILE;
  float* sT = sV + TILE;                    // dS^T: BK x LDT
  float* sL = sT + BK * LDT;
  float* sD = sL + QR;

  const size_t head = blockIdx.x;
  const size_t kvh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;   // heaviest first
  const int last = min(q0 + QR, sq) - 1;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;   // score tile
  const int qa = tid % QA, cb = tid / QA;   // dQ: rows 4 qa + r, columns cb + CB m
  const float* kh = k + kvh * skv * HD;
  const float* vh = v + kvh * skv * HD;
  load_rows<HD, QR>(sQ, q + head * sq * HD, q0, sq);
  load_rows<HD, QR>(sDO, dout + head * sq * HD, q0, sq);
  load_stats(sL, sD, lse + head * sq, dvec + head * sq, q0, sq, QR);

  float acc[4][NM];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[r][m] = 0.0f;

  const int k_lo = band_lo(q0, q_offset, window);
  const int k_hi = band_hi(last, q_offset, skv);
  const int tile0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - tile0 + 1 : 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (tile0 + i) * BK;
    __syncthreads();                        // the last tile's readers are done
    load_rows<HD>(sK, kh, k0, skv);
    load_rows<HD>(sV, vh, k0, skv);
    __syncthreads();
    float s[QI][4], dp[QI][4];
    scores_bwd<HD, QI>(s, dp, sQ, sK, sDO, sV, tq, tk);
    probs_bwd<QI>(s, dp, sL, sD, tq, tk, q0, k0,
                  tile_interior(k0, q0, last, q_offset, window, skv), sq, skv,
                  window, q_offset, scale_log2);
#pragma unroll
    for (int a = 0; a < QI; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sT[(tk + 16 * j) * LDT + tq + 16 * a] = dp[a][j];
    __syncthreads();
#pragma unroll 2
    for (int key = 0; key < BK; ++key) {
      const float4 d = ld4(sT + key * LDT + 4 * qa);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float x = sK[key * LD + cb + CB * m];
        acc[0][m] = fmaf(d.x, x, acc[0][m]);
        acc[1][m] = fmaf(d.y, x, acc[1][m]);
        acc[2][m] = fmaf(d.z, x, acc[2][m]);
        acc[3][m] = fmaf(d.w, x, acc[3][m]);
      }
    }
  }
  // every row of the tile below sq is written, 0 where it sees no key
  float* dqh = dq + head * sq * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * qa + r;
    if (row >= sq) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      dqh[(size_t)row * HD + cb + CB * m] = scale * acc[r][m];
  }
}

// ---- bf16 backward: wgmma, TMA ------------------------------------------ //
constexpr int BT = 64;             // queries of a dK/dV stage (one Q, dO tile)
constexpr int STAT_BYTES = 2 * BT * 4;   // a stage's lse (log2 units), then D

// The tensor maps of one backward call: [0] the 64-column panels, [1] the
// tail.  dK/dV: q and dout boxes of BT rows, k and v of Dkdv::KEYS; dQ: q
// and dout boxes of Dq::ROWS rows, k and v of BK.
struct BwdMaps {
  CUtensorMap q[2], dout[2], k[2], v[2];
};

// A dK/dV CTA: 64 keys a consumer warpgroup, two at d <= 80, one at d =
// 128 (whose dK and dV take 64 + 64 registers a thread); at d = 256
// (SPLIT) two warpgroups over the same 64 keys, each with COLS = 128 of
// dK's and dV's columns, and a RING-stage ring.
template <int HD>
struct Dkdv {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int WGS = HD <= 80 || SPLIT ? 2 : 1;
  static constexpr int KEYS = SPLIT ? 64 : 64 * WGS;
  static constexpr int COLS = SPLIT ? HD / 2 : HD;
  static constexpr int RING = SPLIT ? 2 : STAGES;
  static constexpr int CONSUMERS = 4 * WGS;             // warps
  // + the producer: a warpgroup that gives its registers away (two
  // consumer warpgroups), or one warp (one: 255 registers a thread)
  static constexpr int THREADS = 32 * CONSUMERS + (WGS > 1 ? 128 : 32);
  static constexpr int SMEM = 1024 + 2 * Panels<HD>::bytes(KEYS) +
                              RING * (2 * Panels<HD>::bytes(BT) + STAT_BYTES) +
                              8 * (2 * RING + 1);
};

// A dQ CTA: ROWS queries, two consumer warpgroups of 64 rows up to d =
// 128; at d = 256 (SPLIT) both over the same 64 rows, each with COLS =
// 128 of dQ's columns, and a RING-stage ring of K and V tiles.
template <int HD>
struct Dq {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int ROWS = SPLIT ? 64 : BQ;
  static constexpr int COLS = SPLIT ? HD / 2 : HD;
  static constexpr int RING = SPLIT ? 2 : STAGES;
  static constexpr int SMEM = 1024 + 2 * Panels<HD>::bytes(ROWS) +
                              2 * RING * Panels<HD>::bytes(BK) +
                              8 * (2 * RING + 1);
};

// acc (m64 x COLS, fp32) += A B, as wgmma_rs_panels: all of d (COLS =
// HD), or the COLS / 64 full panels from panel p0 (a SPLIT warpgroup's
// columns).
template <int HD, int COLS>
__device__ __forceinline__ void wgmma_rs_cols(float* acc, const uint32_t* a,
                                              uint32_t tile, int rows, int kk,
                                              int p0) {
  if constexpr (COLS == HD) {
    wgmma_rs_panels<HD>(acc, a, tile, rows, kk);
  } else {
#pragma unroll
    for (int p = 0; p < COLS / 64; ++p)
      wgmma_rs_n64(acc + 32 * p, a,
                   smem_desc(tile + Panels<HD>::offset(p0 + p, rows) + kk * 16 * 128, 128));
  }
}

// A stage's per-query values (lse or D) at this thread's columns of the
// score layout: v[4 j + e] is column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void column_stats(float (&v)[4 * NT],
                                             const float* st, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
    v[4 * j] = v[4 * j + 2] = x.x;
    v[4 * j + 1] = v[4 * j + 3] = x.y;
  }
}

// P = 2^(s scale_log2 - lse) for each pair of the score layout that is
// visible (0 for the others); lse[e] (log2 units) is that of element e's
// query.  Element e is row `row_base` + 8 ((e >> 1) & 1) and column
// `col_base` + 8 (e >> 2) + (e & 1): row_base holds this lane's g,
// col_base its 2 t.  `query_rows`: the rows are queries and the columns
// keys (dQ); else the transpose (dK/dV).
template <bool query_rows>
__device__ __forceinline__ void probs_tile(float (&s)[4 * NT],
                                           const float (&lse)[4 * NT],
                                           bool interior, int row_base,
                                           int col_base, int q_offset,
                                           int window, int skv,
                                           float scale_log2) {
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) {
    bool ok = interior;
    if (!interior) {
      const int row = row_base + 8 * ((e >> 1) & 1);
      const int col = col_base + 8 * (e >> 2) + (e & 1);
      const int key = query_rows ? col : row;
      const int qp = q_offset + (query_rows ? row : col);
      ok = key <= qp && qp - key < window && key < skv;
    }
    s[e] = ok ? fast_exp2(fmaf(s[e], scale_log2, -lse[e])) : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(Dkdv<HD>::THREADS, 1)
swa_bwd_dkdv_bf16_kernel(const __grid_constant__ BwdMaps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int skv,
                         int group, int window, int q_offset, float scale,
                         float scale_log2) {
  using P = Panels<HD>;
  using C = Dkdv<HD>;
  constexpr int KEYS = C::KEYS, KV_BYTES = P::bytes(KEYS), Q_BYTES = P::bytes(BT);
  extern __shared__ unsigned char smem_dkdv[];
  const uint32_t base = smem_u32(smem_dkdv);
  const uint32_t s_k = (base + 1023u) & ~1023u;
  const uint32_t s_v = s_k + KV_BYTES;
  const uint32_t s_q = s_v + KV_BYTES;                 // stage s: + s * Q_BYTES
  const uint32_t s_do = s_q + C::RING * Q_BYTES;
  const uint32_t s_stat = s_do + C::RING * Q_BYTES;     // stage s: + s * STAT_BYTES
  const uint32_t bar_full = s_stat + C::RING * STAT_BYTES;
  const uint32_t bar_empty = bar_full + 8 * C::RING;
  const uint32_t bar_kv = bar_empty + 8 * C::RING;
  float* stat = reinterpret_cast<float*>(smem_dkdv + (s_stat - base));

  const int kvh = blockIdx.x, k0 = blockIdx.y * KEYS;
  // the queries that see a key of [k0, k_last], in 64 bits: q_offset + i
  // in [k0, k_last + window - 1], cut to [0, sq); their 64-query tiles
  // for each of the group's q heads, heads outer
  const int k_last = min(k0 + KEYS, skv) - 1;
  const long long lo = max(0LL, (long long)k0 - q_offset);
  const long long hi = min((long long)sq - 1,
                           (long long)k_last - q_offset + window - 1);
  const int t0 = lo <= hi ? (int)(lo / BT) : 0;
  const int nt = lo <= hi ? (int)(hi / BT) - t0 + 1 : 0;
  const int n_items = group * nt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::RING; ++s) {
      mbar_init(bar_full + 8 * s, 32);           // the producer's lanes
      mbar_init(bar_empty + 8 * s, C::CONSUMERS);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CONSUMERS) {          // the producer: its first warp works
    if constexpr (C::WGS > 1) producer_regs();
    if (warp > C::CONSUMERS) return;
    if (n_items > 0 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * KV_BYTES);
      tma_tile<HD>(s_k, maps.k, bar_kv, KEYS, k0, kvh);
      tma_tile<HD>(s_v, maps.v, bar_kv, KEYS, k0, kvh);
    }
    for (int i = 0; i < n_items; ++i) {
      const int s = i % C::RING;
      const int head = kvh * group + i / nt, q0 = (t0 + i % nt) * BT;
      float l2[2], d[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + lane + 32 * u;
        const bool ok = row < sq;
        const size_t at = (size_t)head * sq + (ok ? row : 0);
        l2[u] = ok ? lse[at] * LOG2E : INFINITY;
        d[u] = ok ? dvec[at] : 0.0f;
      }
      if (i >= C::RING) mbar_wait(bar_empty + 8 * s, (i / C::RING - 1) & 1);
      float* st = stat + s * (2 * BT);
      st[lane] = l2[0];
      st[lane + 32] = l2[1];
      st[BT + lane] = d[0];
      st[BT + lane + 32] = d[1];
      const uint32_t full = bar_full + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * Q_BYTES);
        tma_tile<HD>(s_q + s * Q_BYTES, maps.q, full, BT, q0, head);
        tma_tile<HD>(s_do + s * Q_BYTES, maps.dout, full, BT, q0, head);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 (SPLIT: both
  // own the CTA's 64 keys, wg the columns c0 .. c0 + COLS - 1)
  if constexpr (C::WGS > 1) consumer_regs();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int kw0 = k0 + (C::SPLIT ? 0 : 64 * wg);
  const int c0 = C::SPLIT ? C::COLS * wg : 0;
  const int kw_last = min(kw0 + 63, skv - 1);
  const long long wlo = max(0LL, (long long)kw0 - q_offset);
  const long long whi = min((long long)sq - 1,
                            (long long)kw_last - q_offset + window - 1);
  const bool live = kw0 < skv && wlo <= whi;     // some query sees its keys
  const int key0 = kw0 + 16 * (warp % 4) + g;        // keys key0, key0 + 8
  // dK, dV: [4 j + e] is key key0 + 8 (e >> 1), column c0 + 8 j + 2 t +
  // (e & 1)
  float adk[C::COLS / 2], adv[C::COLS / 2];
#pragma unroll
  for (int i = 0; i < C::COLS / 2; ++i) adk[i] = adv[i] = 0.0f;
  if (n_items > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % C::RING;
    mbar_wait(bar_full + 8 * s, (i / C::RING) & 1);
    const int q0 = (t0 + i % nt) * BT;
    if (live && q0 <= whi && q0 + BT - 1 >= wlo) {
      const uint32_t q_t = s_q + s * Q_BYTES, do_t = s_do + s * Q_BYTES;
      const float* st = stat + s * (2 * BT);
      float sc[4 * NT], dp[4 * NT];    // S^T, dP^T: rows keys, columns queries
      wgmma_fence();
      wgmma_ss_panels<HD>(sc, s_k, KEYS, kw0 - k0, q_t);
      wgmma_commit();
      wgmma_ss_panels<HD>(dp, s_v, KEYS, kw0 - k0, do_t);
      wgmma_commit();
      wgmma_wait<1>();                 // S^T is in; dP^T may still run
      fence_regs(sc);
      // each thread's columns 8 j + 2 t + {0, 1}: their lse, then D
      float col[4 * NT];
      column_stats(col, st, t);
      const int qlast = min(q0 + BT, sq) - 1;
      probs_tile<false>(sc, col, tile_interior(kw0, q0, qlast, q_offset, window, skv),
                        key0, q0 + 2 * t, q_offset, window, skv, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
      column_stats(col, st + BT, t);
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) dp[e] = sc[e] * (dp[e] - col[e]);
      // P^T and dS^T as bf16 hi + lo A fragments
      uint32_t ph[BK / 16][4], pl[BK / 16][4], dh[BK / 16][4], dl[BK / 16][4];
      split_a(ph, pl, sc);
      split_a(dh, dl, dp);
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        wgmma_rs_cols<HD, C::COLS>(adv, ph[kk], do_t, BT, kk, c0 / 64);
        wgmma_rs_cols<HD, C::COLS>(adv, pl[kk], do_t, BT, kk, c0 / 64);
      }
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        wgmma_rs_cols<HD, C::COLS>(adk, dh[kk], q_t, BT, kk, c0 / 64);
        wgmma_rs_cols<HD, C::COLS>(adk, dl[kk], q_t, BT, kk, c0 / 64);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);    // this warp is done with it
  }

  // every key below skv is written, 0 where no query sees it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    const size_t at = ((size_t)kvh * skv + key) * HD + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < C::COLS / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(scale * adk[4 * j + 2 * r], scale * adk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(BWD_BF16_THREADS, 1)
swa_bwd_dq_bf16_kernel(const __grid_constant__ BwdMaps maps,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dq, int sq, int skv,
                       int group, int window, int q_offset, float scale,
                       float scale_log2) {
  using P = Panels<HD>;
  using D = Dq<HD>;
  constexpr int ROWS = D::ROWS;
  constexpr int Q_BYTES = P::bytes(ROWS), KV_BYTES = P::bytes(BK);
  extern __shared__ unsigned char smem_dq[];
  const uint32_t s_q = (smem_u32(smem_dq) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + Q_BYTES;
  const uint32_t s_k = s_do + Q_BYTES;               // stage s: + s * KV_BYTES
  const uint32_t s_v = s_k + D::RING * KV_BYTES;
  const uint32_t bar_full = s_v + D::RING * KV_BYTES;
  const uint32_t bar_empty = bar_full + 8 * D::RING;
  const uint32_t bar_q = bar_empty + 8 * D::RING;

  const int head = blockIdx.x, kvh = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest tiles first
  const int k_lo = band_lo(q0, q_offset, window);
  const int k_hi = band_hi(min(q0 + ROWS, sq) - 1, q_offset, skv);
  const int tile0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - tile0 + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < D::RING; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {        // the producer: one thread issues TMA
    producer_regs();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
      tma_tile<HD>(s_q, maps.q, bar_q, ROWS, q0, head);
      tma_tile<HD>(s_do, maps.dout, bar_q, ROWS, q0, head);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % D::RING;
        if (i >= D::RING) mbar_wait(bar_empty + 8 * s, (i / D::RING - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * KV_BYTES);
        const int key0 = (tile0 + i) * BK;
        tma_tile<HD>(s_k + s * KV_BYTES, maps.k, full, BK, key0, kvh);
        tma_tile<HD>(s_v + s * KV_BYTES, maps.v, full, BK, key0, kvh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 (SPLIT:
  // both own the CTA's 64 rows, wg the columns c0 .. c0 + COLS - 1)
  consumer_regs();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int first = q0 + (D::SPLIT ? 0 : 64 * wg), last = min(first + 63, sq - 1);
  const int c0 = D::SPLIT ? D::COLS * wg : 0;
  const bool live = first < sq;
  const int wk_lo = band_lo(first, q_offset, window);
  const int wk_hi = band_hi(last, q_offset, skv);
  const int row0 = first + 16 * (warp % 4) + g;      // rows row0, row0 + 8
  // each score element's row: its lse (log2 units) and D; rows past sq
  // read +inf and 0
  float row_l[4 * NT], row_d[4 * NT];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const bool ok = qi < sq;
    const size_t at = (size_t)head * sq + (ok ? qi : 0);
    const float l2 = ok ? lse[at] * LOG2E : INFINITY, d = ok ? dvec[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      row_l[4 * j + 2 * r] = row_l[4 * j + 2 * r + 1] = l2;
      row_d[4 * j + 2 * r] = row_d[4 * j + 2 * r + 1] = d;
    }
  }
  // dQ: acc[4 j + e] is column c0 + 8 j + 2 t + (e & 1)
  float acc[D::COLS / 2];
#pragma unroll
  for (int i = 0; i < D::COLS / 2; ++i) acc[i] = 0.0f;
  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % D::RING;
    mbar_wait(bar_full + 8 * s, (i / D::RING) & 1);
    const int k0 = (tile0 + i) * BK;
    if (live && k0 <= wk_hi && k0 + BK - 1 >= wk_lo) {
      const uint32_t k_t = s_k + s * KV_BYTES, v_t = s_v + s * KV_BYTES;
      float sc[4 * NT], dp[4 * NT];
      wgmma_fence();
      wgmma_ss_panels<HD>(sc, s_q, ROWS, first - q0, k_t);
      wgmma_commit();
      wgmma_ss_panels<HD>(dp, s_do, ROWS, first - q0, v_t);
      wgmma_commit();
      wgmma_wait<1>();                 // S is in; dP may still run
      fence_regs(sc);
      probs_tile<true>(sc, row_l, tile_interior(k0, first, last, q_offset, window, skv),
                       row0, k0 + 2 * t, q_offset, window, skv, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) dp[e] = sc[e] * (dp[e] - row_d[e]);
      uint32_t dh[BK / 16][4], dl[BK / 16][4];   // dS as bf16 hi + lo
      split_a(dh, dl, dp);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs_cols<HD, D::COLS>(acc, dh[kk], k_t, BK, kk, c0 / 64);
        wgmma_rs_cols<HD, D::COLS>(acc, dl[kk], k_t, BK, kk, c0 / 64);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);    // this warp is done with it
  }

  // every row below sq is written, 0 where it sees no key
  __nv_bfloat16* dqh = dq + (size_t)head * sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row = dqh + (size_t)qi * HD + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < D::COLS / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(scale * acc[4 * j + 2 * r], scale * acc[4 * j + 2 * r + 1]);
  }
}

// ---- backward launchers ------------------------------------------------ //
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  cudaError_t e = cudaSuccess;
  if (bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  return e;
}

template <int HD>
constexpr size_t dkdv_f32_smem() {
  constexpr int QR = f32_bwd_rows(HD);
  return (2 * (64 + QR) * (HD + F32_LD) + 2 * QR * BWD_LDS + 2 * QR) *
         sizeof(float);
}

template <int HD>
constexpr size_t dq_f32_smem() {
  constexpr int QR = f32_bwd_rows(HD);
  return (2 * (64 + QR) * (HD + F32_LD) + BK * (QR + 4) + 2 * QR) *
         sizeof(float);
}

// The tensors and shapes of one backward call.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *dvec;
  int bhq, bhkv, sq, skv, window, q_offset;
  float scale;
  cudaStream_t stream;
};

// The four maps of a bf16 backward call: q and dout boxes of q_rows rows,
// k and v boxes of kv_rows.
template <int HD>
bool encode_bwd(BwdMaps* maps, const BwdArgs& b, int q_rows, int kv_rows) {
  using P = Panels<HD>;
  bool ok = true;
  for (int j = 0; j < 2; ++j) {        // [0]: 64-column panels, [1]: tail
    const int width = j == 0 ? 64 : P::TW;
    if (j == 0 ? P::NF == 0 : P::TW == 0) continue;
    ok = ok && encode(&maps->q[j], b.q, b.bhq, b.sq, HD, width, q_rows) &&
         encode(&maps->dout[j], b.dout, b.bhq, b.sq, HD, width, q_rows) &&
         encode(&maps->k[j], b.k, b.bhkv, b.skv, HD, width, kv_rows) &&
         encode(&maps->v[j], b.v, b.bhkv, b.skv, HD, width, kv_rows);
  }
  return ok;
}

template <typename Kern>
cudaError_t prepare_bf16(Kern kern, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int HD>
int launch_dkdv_bf16(const BwdArgs& b, void* dk, void* dv) {
  using C = Dkdv<HD>;
  BwdMaps maps = {};
  if (!encode_bwd<HD>(&maps, b, BT, C::KEYS)) return (int)cudaErrorInvalidValue;
  auto kern = swa_bwd_dkdv_bf16_kernel<HD>;
  const cudaError_t e = prepare_bf16(kern, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b.bhkv, (b.skv + C::KEYS - 1) / C::KEYS);
  kern<<<grid, C::THREADS, C::SMEM, b.stream>>>(
      maps, b.lse, b.dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), b.sq, b.skv, b.bhq / b.bhkv, b.window,
      b.q_offset, b.scale, b.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_bf16(const BwdArgs& b, void* dq) {
  BwdMaps maps = {};
  using D = Dq<HD>;
  if (!encode_bwd<HD>(&maps, b, D::ROWS, BK)) return (int)cudaErrorInvalidValue;
  auto kern = swa_bwd_dq_bf16_kernel<HD>;
  const cudaError_t e = prepare_bf16(kern, D::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b.bhq, (b.sq + D::ROWS - 1) / D::ROWS);
  kern<<<grid, BWD_BF16_THREADS, D::SMEM, b.stream>>>(
      maps, b.lse, b.dvec, static_cast<__nv_bfloat16*>(dq), b.sq, b.skv,
      b.bhq / b.bhkv, b.window, b.q_offset, b.scale, b.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkdv_f32(const BwdArgs& b, void* dk, void* dv) {
  auto kern = swa_bwd_dkdv_f32_kernel<HD>;
  const cudaError_t e = allow_smem(kern, dkdv_f32_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b.bhkv, (b.skv + BK - 1) / BK);
  kern<<<grid, BWD_THREADS, dkdv_f32_smem<HD>(), b.stream>>>(
      static_cast<const float*>(b.q), static_cast<const float*>(b.k),
      static_cast<const float*>(b.v), static_cast<const float*>(b.dout), b.lse,
      b.dvec, static_cast<float*>(dk), static_cast<float*>(dv), b.sq, b.skv,
      b.bhq / b.bhkv, b.window, b.q_offset, b.scale, b.scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_f32(const BwdArgs& b, void* dq) {
  auto kern = swa_bwd_dq_f32_kernel<HD>;
  const cudaError_t e = allow_smem(kern, dq_f32_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  constexpr int QR = f32_bwd_rows(HD);
  const dim3 grid(b.bhq, (b.sq + QR - 1) / QR);
  kern<<<grid, BWD_THREADS, dq_f32_smem<HD>(), b.stream>>>(
      static_cast<const float*>(b.q), static_cast<const float*>(b.k),
      static_cast<const float*>(b.v), static_cast<const float*>(b.dout), b.lse,
      b.dvec, static_cast<float*>(dq), b.sq, b.skv, b.bhq / b.bhkv, b.window,
      b.q_offset, b.scale, b.scale * LOG2E);
  return (int)cudaGetLastError();
}

// dK and dV (dq == nullptr) or dQ, by dtype and head dim: bf16 on
// wgmma, fp32 on FMA.
template <int HD>
int launch_bwd_hd(bool bf16, const BwdArgs& b, void* dq, void* dk, void* dv) {
  if (bf16) return dq ? launch_dq_bf16<HD>(b, dq) : launch_dkdv_bf16<HD>(b, dk, dv);
  return dq ? launch_dq_f32<HD>(b, dq) : launch_dkdv_f32<HD>(b, dk, dv);
}

int launch_bwd(bool bf16, int hd, const BwdArgs& b, void* dq, void* dk,
               void* dv) {
  switch (hd) {
    case 16: return launch_bwd_hd<16>(bf16, b, dq, dk, dv);
    case 32: return launch_bwd_hd<32>(bf16, b, dq, dk, dv);
    case 64: return launch_bwd_hd<64>(bf16, b, dq, dk, dv);
    case 80: return launch_bwd_hd<80>(bf16, b, dq, dk, dv);
    case 128: return launch_bwd_hd<128>(bf16, b, dq, dk, dv);
    case 256: return launch_bwd_hd<256>(bf16, b, dq, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

float head_scale(int hd) { return (float)(1.0 / std::sqrt((double)hd)); }

}  // namespace

// a: q, k, v, o, lse (device pointers; lse 0 to skip it), bhq, bhkv, sq,
// skv, hd, window, q_offset, is_bf16 (1 for bf16 tensors, 0 for fp32),
// stream.  The scale hd^-1/2 is rounded once to fp32 here.
extern "C" int swa_attention_forward(const long long* a) {
  const void *q = (const void*)a[0], *k = (const void*)a[1],
             *v = (const void*)a[2];
  void* o = (void*)a[3];
  float* lse = (float*)a[4];
  const int bhq = (int)a[5], bhkv = (int)a[6], sq = (int)a[7],
            skv = (int)a[8], hd = (int)a[9], window = (int)a[10],
            q_offset = (int)a[11];
  const bool bf16 = a[12] != 0;
  cudaStream_t s = (cudaStream_t)a[13];
  const float scale = head_scale(hd);
  switch (hd) {
    case 16: return launch<16>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 32: return launch<32>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 64: return launch<64>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 80: return launch<80>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 128: return launch<128>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    case 256: return launch<256>(bf16, q, k, v, o, lse, bhq, bhkv, sq, skv, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a: o, do, dvec (device pointers: O and dO (rows, hd) in one dtype, D
// (rows,) fp32), rows, hd, is_bf16, stream.  D_i = dO_i . O_i in fp32.
extern "C" int swa_attention_bwd_dot(const long long* a) {
  const void *o = (const void*)a[0], *dout = (const void*)a[1];
  float* dvec = (float*)a[2];
  const long long rows = a[3];
  const int hd = (int)a[4];
  const bool bf16 = a[5] != 0;
  cudaStream_t s = (cudaStream_t)a[6];
  const dim3 grid((unsigned)((rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32)));
  if (bf16)
    swa_bwd_dot_kernel<__nv_bfloat16><<<grid, BWD_THREADS, 0, s>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, dvec, rows, hd);
  else
    swa_bwd_dot_kernel<float><<<grid, BWD_THREADS, 0, s>>>(
        (const float*)o, (const float*)dout, dvec, rows, hd);
  return (int)cudaGetLastError();
}

// a: q, k, v, do, lse, dvec, dk, dv (device pointers; q, do (bhq, sq,
// hd), k, v, dk, dv (bhkv, skv, hd) in one dtype, lse and D (bhq, sq)
// fp32), bhq, bhkv, sq, skv, hd, window, q_offset, is_bf16, stream.
extern "C" int swa_attention_backward_dkdv(const long long* a) {
  const int hd = (int)a[12];
  const BwdArgs b = {(const void*)a[0], (const void*)a[1], (const void*)a[2],
                     (const void*)a[3], (const float*)a[4], (const float*)a[5],
                     (int)a[8], (int)a[9], (int)a[10], (int)a[11], (int)a[13],
                     (int)a[14], head_scale(hd), (cudaStream_t)a[16]};
  void *dk = (void*)a[6], *dv = (void*)a[7];
  return launch_bwd(a[15] != 0, hd, b, nullptr, dk, dv);
}

// a: q, k, v, do, lse, dvec, dq (device pointers; dq (bhq, sq, hd) in
// q's dtype), bhq, bhkv, sq, skv, hd, window, q_offset, is_bf16, stream.
extern "C" int swa_attention_backward_dq(const long long* a) {
  const int hd = (int)a[11];
  const BwdArgs b = {(const void*)a[0], (const void*)a[1], (const void*)a[2],
                     (const void*)a[3], (const float*)a[4], (const float*)a[5],
                     (int)a[7], (int)a[8], (int)a[9], (int)a[10], (int)a[12],
                     (int)a[13], head_scale(hd), (cudaStream_t)a[15]};
  void* dq = (void*)a[6];
  return launch_bwd(a[14] != 0, hd, b, dq, nullptr, nullptr);
}
