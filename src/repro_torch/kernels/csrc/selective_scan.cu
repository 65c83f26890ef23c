// Mamba's selective scan (mamba1), forward, for Hopper (sm_90a): the bare
// scan and the fused tail of a Mamba layer, one kernel body for both.
//
// Replaces no TPU kernel: the JAX package computes the scan in jnp
// (repro/models/blocks.py:605 _selective_scan_chunk, a log-depth
// associative scan over 256-step chunks under lax.scan) and the tail
// around it in jnp (blocks.py:634-659).  The plain versions are
// repro_torch/kernels/ref.py::selective_scan and ::selective_scan_fused.
// For one layer, over the whole sequence in one launch:
//
//   dtf_t  = softplus(float(dt_t + bias, rounded to the model dtype))
//   h_t    = exp(dtf_t * A) * h_{t-1} + (dtf_t * x_t) Bm_t      (fp32)
//   y_t    = <h_t, Cm_t>
//   out_t  = model_dtype((y_t + D * x_t) * silu(float(z_t)))     (fused)
//
// from h_{-1} = h0 (or 0); h_last = h_{S-1}.  The bare entry point takes dt
// already softplus'd in fp32 and returns y in fp32 (no bias, D or gate);
// the fused one takes dt, x, z, Bm, Cm in the model's dtype (fp32 or bf16),
// with z read in place at its own row stride (the second half of
// in_proj's output), and returns out in the model's dtype.
//
// What bounds it: one exp per (b, t, channel, state) on the SFUs, plus
// the exp and log of softplus and one for silu (z/2 (1 + tanh(z/2)); this
// kernel issues an exp and a reciprocal) per (b, t, channel): at
// falcon-mamba-7b's B 2, S 2048, d_in 8192, d_state 16, 537 M + 101 M
// MUFU operations, 16 a clock an SM, ~0.15 ms, against
// ~270 MB read and written once (~0.08 ms at 3.35 TB/s).  Measured on
// an H100, neither binds: taking the exps off the SFUs or the waits off
// the TMA ring saves under 4 %; the passes' instructions and their
// stalls do, and the prologue and epilogue a fifth (tools/scan_probes.py).
//
// Design.  Each input is read from device memory once and the state never
// leaves registers.  A block owns CPB = 32 channels of one sequence and
// walks time in tiles of T = 16 steps:
//
//   * TMA.  One thread keeps STAGES - 2 tiles in flight: 2-D boxes of
//     (T rows, 32 channels) of dt, x and z over their (B S, d_in) rows,
//     z at its own row stride, and (T rows, 2 st) of Bm | Cm, which sit
//     side by side in x_proj's output; each stage completes on one
//     mbarrier.  Rows past S are masked by the prologue.
//   * Prologue, once a (t, channel): the bias and softplus of dt and
//     dt * x, in fp32, into a channel-major, padded copy (a row of T + 4
//     floats a channel, so that lanes walking time along neighbouring
//     channels read pairs of steps on distinct banks); Bm | Cm to fp32.
//   * Parallel over time.  A channel's st states split over P = st / 4
//     lanes (4 states a lane) and its tile over R = 2 runs of L = 8
//     steps, so falcon-mamba-7b runs 131,072 threads (~32 warps an SM;
//     65,536 with time sequential).  Pass 1: each lane runs its 8 steps
//     from a zero state, its exps beside the FMA work: the local state
//     hl, the decay product cum = prod exp(dt A), the local y = <C, hl>
//     and C * cum a step, kept in registers.  A shuffle scan across the
//     lanes that hold successive runs combines the runs' (cum, hl) pairs
//     as the reference's `comb` does, so each run learns the state h0
//     it starts from; pass 2 adds <C * cum, h0> to each step's local y
//     (h_t = hl_t + cum_t h0; no exp is computed twice) and stores the
//     lane's partial y (4 states).  The last run's end state, broadcast
//     by a shuffle, is the next tile's.  With a `states` buffer (the
//     fused entry point under autograd; an instance of its own) the
//     state each tile starts from is stored there for the backward.
//   * Epilogue, once a (t, channel pair): the P partial y summed, the D
//     skip and the silu(z) gate in fp32, out stored in the model's dtype
//     as coalesced row segments.  It runs one tile late, after the next
//     tile's prologue, so one barrier a tile separates the phases (the
//     prologue's buffers and the partial y are double-buffered).
//
// exp is one MUFU.EX2 (ex2.approx.ftz) of the argument times log2(e),
// folded into A.  Channels past d_in read zeros and store nothing.
//
// Entry points: plain C, arguments packed in one int64 array, launch on
// the given stream, allocate nothing, return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the tensor maps cannot take).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;

constexpr int SPT = 4;                // states a lane holds
constexpr int L = 8;                  // steps a run
constexpr int R = 2;                  // runs a tile
constexpr int T = L * R;              // steps a tile
constexpr int CPB = 32;               // channels a block
constexpr int STAGES = 4;             // TMA ring depth
constexpr int ROW = T + 4;            // floats a channel in the prologue's copy
constexpr int RUN_SHIFT = 4;          // lane = run << RUN_SHIFT | (channel, part)
static_assert((32 >> RUN_SHIFT) == R, "the runs of a channel share a warp");
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// torch.nn.functional.softplus's default threshold: above it, x itself
constexpr float SOFTPLUS_THRESHOLD = 20.f;

// 2^x, log2(x), 1/x: one SFU instruction each (ftz)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the model's dtype and back, as a bf16 tensor op rounds
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename O>
__device__ __forceinline__ void store1(O* p, float a) {
  if constexpr (std::is_same_v<O, float>) *p = a;
  else *p = __float2bfloat16_rn(a);
}

// the P partial y of one (step, channel), in one shared-memory load
template <int P>
__device__ __forceinline__ float sum_parts(const float* p) {
  if constexpr (P == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return (v.x + v.y) + (v.z + v.w);
  } else if constexpr (P == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return v.x + v.y;
  } else {
    return *p;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---- TMA and mbarriers ------------------------------------------------ //
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

// One TMA box of a 2-D map at (column, row) into shared memory;
// completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<u64>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The tensor maps of one launch: dt, x, z (fused only) over (B S, d_in)
// rows, and Bm | Cm over (B S, 2 st) rows.
struct ScanMaps {
  CUtensorMap dt, x, z, bc;
};

// One instance's shapes and shared-memory plan, on host and device.
template <int ST, typename In, bool FUSED>
struct Geo {
  using Dt = std::conditional_t<FUSED, In, float>;   // dt as it comes in
  using Out = std::conditional_t<FUSED, In, float>;  // out, or bare y
  static constexpr int P = ST / SPT;                 // lanes a channel
  static constexpr int THREADS = CPB * P * R;
  static constexpr int CH_W = 16 / P;                // channels a half-warp
  static constexpr int YS = CPB * P;                 // floats a row of s_y
  static constexpr int DT_BYTES = T * CPB * (int)sizeof(Dt);
  static constexpr int X_BYTES = T * CPB * (int)sizeof(In);
  static constexpr int Z_BYTES = FUSED ? X_BYTES : 0;
  static constexpr int BC_BYTES = T * 2 * ST * (int)sizeof(In);
  static constexpr int LOAD_BYTES = DT_BYTES + X_BYTES + Z_BYTES + BC_BYTES;
  static constexpr int STAGE_BYTES = (LOAD_BYTES + 127) / 128 * 128;
  // two of each buffer a tile fills, by the tile's parity: tile k's
  // prologue and passes run while tile k - 1's epilogue reads the others
  static constexpr int DTF_FLOATS = CPB * ROW;
  static constexpr int BC_FLOATS = T * 2 * ST;
  static constexpr int Y_FLOATS = T * YS;
  static constexpr int OFF_DTF = STAGES * STAGE_BYTES;
  static constexpr int OFF_DX = OFF_DTF + 2 * DTF_FLOATS * 4;
  static constexpr int OFF_BC = OFF_DX + 2 * DTF_FLOATS * 4;
  static constexpr int OFF_Y = OFF_BC + 2 * BC_FLOATS * 4;
  // per thread: its 4 states' A log2(e) and its tile-boundary state, read
  // once a tile (kept out of the 64 registers the step loops need)
  static constexpr int OFF_A2 = OFF_Y + 2 * Y_FLOATS * 4;
  static constexpr int OFF_H = OFF_A2 + THREADS * SPT * 4;
  // per channel of the block: dt's bias and D
  static constexpr int OFF_BIAS = OFF_H + THREADS * SPT * 4;
  static constexpr int OFF_D = OFF_BIAS + CPB * 4;
  static constexpr int OFF_BAR = OFF_D + CPB * 4;
  static constexpr int SMEM = OFF_BAR + 8 * STAGES;
  static_assert(ST % SPT == 0 && P >= 1 && P <= 4, "d_state 4, 8 or 16");
  static_assert(DT_BYTES % 128 == 0 && X_BYTES % 128 == 0 &&
                BC_BYTES % 128 == 0, "TMA boxes on 128-byte boundaries");
};

// Tile k's boxes into its stage of the ring (one thread).
template <typename G, bool FUSED>
__device__ __forceinline__ void issue(const ScanMaps& maps, unsigned char* smem,
                                      uint32_t bar0, int k, int c0, int row0) {
  const int s = k % STAGES;
  const uint32_t st = smem_u32(smem + s * G::STAGE_BYTES);
  const uint32_t bar = bar0 + 8 * s;
  const int row = row0 + k * T;
  mbar_expect_tx(bar, G::LOAD_BYTES);
  tma_load_2d(st, &maps.dt, bar, c0, row);
  tma_load_2d(st + G::DT_BYTES, &maps.x, bar, c0, row);
  if constexpr (FUSED)
    tma_load_2d(st + G::DT_BYTES + G::X_BYTES, &maps.z, bar, c0, row);
  tma_load_2d(st + G::DT_BYTES + G::X_BYTES + G::Z_BYTES, &maps.bc, bar, 0,
              row);
}

// d_state 16: 1,024 threads an SM (64 registers a thread), so that at
// falcon-mamba-7b's width its 512 blocks of 256 threads are all resident
// at once on 132 SMs.  The test-size state sizes (4, 8) take 768 (85
// registers): at 64 their builds spill.  STATES (fused only) writes each
// tile's starting state for the backward; without it the instance is
// the prefill's, its code untouched by the option.
template <int ST, typename In, bool FUSED, bool STATES>
__global__ void __launch_bounds__(Geo<ST, In, FUSED>::THREADS,
                                 (ST == 16 ? 1024 : 768) /
                                     Geo<ST, In, FUSED>::THREADS)
selective_scan_kernel(const __grid_constant__ ScanMaps maps,
                      const float* __restrict__ A,
                      const float* __restrict__ h0,
                      const float* __restrict__ D,
                      const In* __restrict__ dt_bias,
                      typename Geo<ST, In, FUSED>::Out* __restrict__ out,
                      float* __restrict__ h_last,
                      float* __restrict__ states, int S, int d_in) {
  using G = Geo<ST, In, FUSED>;
  using Dt = typename G::Dt;
  constexpr int P = G::P;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_dtf = reinterpret_cast<float*>(smem + G::OFF_DTF);
  float* s_dx = reinterpret_cast<float*>(smem + G::OFF_DX);
  float* s_bc = reinterpret_cast<float*>(smem + G::OFF_BC);
  float* s_y = reinterpret_cast<float*>(smem + G::OFF_Y);
  float* s_a2 = reinterpret_cast<float*>(smem + G::OFF_A2) + tid * SPT;
  float* s_h = reinterpret_cast<float*>(smem + G::OFF_H) + tid * SPT;
  float* s_bias = reinterpret_cast<float*>(smem + G::OFF_BIAS);
  float* s_d = reinterpret_cast<float*>(smem + G::OFF_D);
  const uint32_t bar0 = smem_u32(smem + G::OFF_BAR);

  const int run = lane >> RUN_SHIFT;
  const int q = lane & ((1 << RUN_SHIFT) - 1);
  const int part = q % P;
  const int ch = warp * G::CH_W + q / P;      // channel in the block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int c = c0 + ch;
  const bool live = c < d_in;
  const int row0 = b * S;                     // (b, t) row of t = 0
  const int n_tiles = (S + T - 1) / T;

  {
    const size_t i = (size_t)c * ST + part * SPT;
    const float4 av = live ? ld4(A + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s_a2) = make_float4(
        av.x * LOG2E, av.y * LOG2E, av.z * LOG2E, av.w * LOG2E);
    *reinterpret_cast<float4*>(s_h) =
        live && h0 != nullptr ? ld4(h0 + (size_t)b * d_in * ST + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (FUSED) {
    if (tid < CPB) {
      const bool ok = c0 + tid < d_in;
      s_bias[tid] = ok ? to_f(dt_bias[c0 + tid]) : 0.f;
      s_d[tid] = ok ? D[c0 + tid] : 0.f;
    }
  }
  // the prologue's channel (fixed a thread: THREADS is a multiple of CPB)
  // and the epilogue's channel pair (THREADS a multiple of CPB / 2)
  const int pc = tid % CPB;
  const int ec = (tid % (CPB / 2)) * 2;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < STAGES && k < n_tiles; ++k)
      issue<G, FUSED>(maps, smem, bar0, k, c0, row0);
  }
  __syncthreads();

  // ---- epilogue of tile j: y summed over the P lanes, D skip, gate; out
  // rows
  auto epilogue = [&](int j) {
    const int t0 = j * T;
    const unsigned char* st = smem + (j % STAGES) * G::STAGE_BYTES;
    const In* g_x = reinterpret_cast<const In*>(st + G::DT_BYTES);
    const In* g_z = reinterpret_cast<const In*>(st + G::DT_BYTES + G::X_BYTES);
    const float* y_buf = s_y + (j & 1) * G::Y_FLOATS;
#pragma unroll 1
    for (int i = tid; i < T * CPB / 2; i += G::THREADS) {
      const int t = i / (CPB / 2);
      if (t0 + t >= S) break;                  // t grows with i
      const float* yr = y_buf + t * G::YS;
      const int swz = (t / L) << 4;
      float y[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        y[u] = sum_parts<P>(yr + (((ec + u) * P) ^ swz));
        if constexpr (FUSED) {
          const float xv = to_f(g_x[t * CPB + ec + u]);
          const float zv = to_f(g_z[t * CPB + ec + u]);
          // y + D x as two roundings, as the plain version computes it
          y[u] = __fadd_rn(y[u], __fmul_rn(s_d[ec + u], xv));
          y[u] *= zv * rcp(1.f + ex2(-zv * LOG2E));
        }
      }
      const int col = c0 + ec;
      auto* o = out + (size_t)(row0 + t0 + t) * d_in + col;
      if (col + 1 < d_in) store2(o, y[0], y[1]);
      else if (col < d_in) store1(o, y[0]);
    }
  };

  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * T;
    float* const dtf = s_dtf + (k & 1) * G::DTF_FLOATS;
    float* const dxb = s_dx + (k & 1) * G::DTF_FLOATS;
    float* const bcb = s_bc + (k & 1) * G::BC_FLOATS;
    const unsigned char* st = smem + (k % STAGES) * G::STAGE_BYTES;
    const Dt* g_dt = reinterpret_cast<const Dt*>(st);
    const In* g_x = reinterpret_cast<const In*>(st + G::DT_BYTES);
    const In* g_bc = reinterpret_cast<const In*>(st + G::DT_BYTES + G::X_BYTES +
                                                 G::Z_BYTES);
    mbar_wait(bar0 + 8 * (k % STAGES), (k / STAGES) & 1);

    // ---- prologue: softplus'd dt and dt * x, channel-major; B | C fp32
#pragma unroll 1
    for (int i = tid; i < CPB * T / 2; i += G::THREADS) {
      const int t2 = (i / CPB) * 2;
      float dv[2], xv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t2 + u;
        float d = to_f(g_dt[t * CPB + pc]);
        if constexpr (FUSED) {
          d = round_as(d + s_bias[pc], In());
          d = d > SOFTPLUS_THRESHOLD ? d : LN2 * lg2(1.f + ex2(d * LOG2E));
        }
        const bool ok = t0 + t < S;
        dv[u] = ok ? d : 0.f;           // dt = 0: the state carries over
        xv[u] = ok ? d * to_f(g_x[t * CPB + pc]) : 0.f;
      }
      *reinterpret_cast<float2*>(dtf + pc * ROW + t2) =
          make_float2(dv[0], dv[1]);
      *reinterpret_cast<float2*>(dxb + pc * ROW + t2) =
          make_float2(xv[0], xv[1]);
    }
#pragma unroll 1
    for (int i = tid; i < T * 2 * ST; i += G::THREADS)
      bcb[i] = t0 + i / (2 * ST) < S ? to_f(g_bc[i]) : 0.f;
    // the one barrier a tile: tile k's prologue written, tile k - 1's
    // partial y written, tile k - 2's epilogue done (its stage free)
    __syncthreads();
    if (tid == 0 && k >= 2 && k + STAGES - 2 < n_tiles)
      issue<G, FUSED>(maps, smem, bar0, k + STAGES - 2, c0, row0);
    if (k > 0) epilogue(k - 1);

    // ---- pass 1: this run's 8 steps from a zero state: its local state
    // hl, decay product cum, local y (yl) and C times the decay product
    // (cc) a step; with the exps, the FMA work, so the SFUs and the FMA
    // pipe overlap
    const float* pd = dtf + ch * ROW + run * L;
    const float* px = dxb + ch * ROW + run * L;
    const float* pb = bcb + run * L * 2 * ST + part * SPT;
    const float4 a2v = ld4(s_a2);
    const float a2[SPT] = {a2v.x, a2v.y, a2v.z, a2v.w};
    float cc[L][SPT], yl[L], cum[SPT], hl[SPT];
    float2 dq, xq;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if ((i & 1) == 0) {
        dq = *reinterpret_cast<const float2*>(pd + i);
        xq = *reinterpret_cast<const float2*>(px + i);
      }
      const float d = (i & 1) ? dq.y : dq.x, dx = (i & 1) ? xq.y : xq.x;
      const float4 bv = ld4(pb + i * 2 * ST);
      const float4 cv = ld4(pb + i * 2 * ST + ST);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float a = ex2(d * a2[j]);
        const float u = dx * get(bv, j);
        hl[j] = i == 0 ? u : fmaf(a, hl[j], u);
        cum[j] = i == 0 ? a : cum[j] * a;
        acc = fmaf(get(cv, j), hl[j], acc);
        cc[i][j] = cum[j] * get(cv, j);
      }
      yl[i] = acc;
    }
    // ---- the shuffle scan across runs: comb((p1, q1), (p2, q2)) =
    // (p1 p2, p2 q1 + q2) on (cum, hl), inclusive; each run starts where
    // the run before it ended
#pragma unroll
    for (int off = 1; off < R; off <<= 1) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float pu = __shfl_up_sync(FULL, cum[j], off << RUN_SHIFT);
        const float qu = __shfl_up_sync(FULL, hl[j], off << RUN_SHIFT);
        if (run >= off) {
          hl[j] = fmaf(cum[j], qu, hl[j]);
          cum[j] *= pu;
        }
      }
    }
    const float4 hv = ld4(s_h);
    // the state tile k starts from, for the backward (fused, with grad)
    if constexpr (STATES) {
      if (live && run == 0)
        *reinterpret_cast<float4*>(states +
                                   (((size_t)b * n_tiles + k) * d_in + c) *
                                       ST +
                                   part * SPT) = hv;
    }
    float hs[SPT], hn[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float h = get(hv, j);
      const float end = fmaf(cum[j], h, hl[j]);
      const float prev = __shfl_up_sync(FULL, end, 1 << RUN_SHIFT);
      hs[j] = run == 0 ? h : prev;
      // the tile-boundary state, from the last run to every run
      hn[j] = __shfl_sync(FULL, end, ((R - 1) << RUN_SHIFT) | q);
    }
    const float4 hnv = make_float4(hn[0], hn[1], hn[2], hn[3]);
    *reinterpret_cast<float4*>(s_h) = hnv;
    if (k == n_tiles - 1 && live && run == 0)       // h_last = h_{S-1}
      *reinterpret_cast<float4*>(h_last + ((size_t)b * d_in + c) * ST +
                                 part * SPT) = hnv;
    // ---- pass 2: y_t = yl_t + <cc_t, h at the run's start>, partial
    // over this lane's 4 states
    float* py = s_y + (k & 1) * G::Y_FLOATS + ((ch * P + part) ^ (run << 4));
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float acc = yl[i];
#pragma unroll
      for (int j = 0; j < SPT; ++j) acc = fmaf(cc[i][j], hs[j], acc);
      py[(run * L + i) * G::YS] = acc;
    }
  }
  __syncthreads();
  epilogue(n_tiles - 1);
}

// ---- backward of the fused entry point -------------------------------- //
// The gradient of every input of one layer's fused tail (the contract is
// ref.py::selective_scan_fused_backward), in fp32, from the output's
// gradient dout (and h_last's, or 0) and the forward's `states`, the
// state each 16-step tile starts from.  With g = dout silu(z) and a_t =
// exp(dtf_t A), the adjoint runs from the last step to the first:
//
//   dh_t    = C_t g_t + a_{t+1} dh_{t+1}     (dh past the end: dh_last)
//   dC_t    = sum over channels of g_t h_t,  dB_t = of dh_t dtf_t x_t
//   dx_t    = g_t D + dtf_t sum over states of dh_t B_t
//   ddtf_t  = sum over states of dh_t (A a_t h_{t-1} + B_t x_t)
//   dA     += dh_t dtf_t a_t h_{t-1},        dD += g_t x_t
//   dz_t    = dout_t (y_t + D x_t) silu'(z_t),  ddt = ddtf softplus'(v)
//
// What bounds it: per (b, t, channel, state) a recomputed state exp
// (MUFU), ~23 fp32 operations (the recompute, the adjoint, the
// gradients' terms) and the sums over states and over channels; per (b,
// t, channel) softplus, its derivative and silu; the bytes of its inputs,
// the saved states and its outputs.  At falcon-mamba-7b's B 2, S 2048,
// d_in 8192, d_state 16 that is 0.19 ms of fp32 work, 0.16 of MUFU and
// 0.18 of bytes (chip_smoke.scan_bwd_bound_ms).  The sums over channels
// are what a layout of one thread a (channel, state) pays for most: a
// shuffle tree a step.  Tensor cores do not apply: each sum is a batched
// dot product whose matrix changes with t (dB_t = dtf_t x_t . dh_t over
// channels), not a product of tiles.  Measured on an H100 (PERF.md,
// tools/scan_probes.py), this design issues ~45 instructions a (t,
// channel, state), two thirds in the passes, and is held by their
// latency at 16 warps an SM (fewer warps with more registers run
// slower); no single cost binds it: the epilogue's items take a tenth,
// the cluster's sums and barriers under a tenth, the SFUs, the TMA waits
// and the channel shuffles a percent or two each.
//
// Design.  A block owns CPB = 32 channels of one sequence, four blocks
// along the channels a thread-block cluster; it walks the tiles of T =
// 16 steps from the last to the first:
//
//   * TMA.  One thread (in the last warp) keeps BWD_STAGES - 1 tiles in
//     flight on a ring walked backwards: 2-D boxes of (T rows, 32
//     channels) of dt, x, z (at its own row stride) and dout, and (T
//     rows, 2 st) of Bm | Cm, each stage on one mbarrier.
//   * Prologue, once a (t, channel): v = dt + bias rounded as the
//     forward rounds it, dtf = softplus(v) as the forward computes it,
//     dtf x and g = dout silu(z), into channel-major padded rows (as the
//     forward's); Bm | Cm to fp32.  Rows past S are zeros: dt = 0
//     carries the state and the adjoint over.
//   * Four states a lane, a tile in R = 2 runs of L = 8 steps, the
//     forward's lanes (lane = run << 4 | channel, part).  Pass 1: each
//     run recomputes its 8 states from the tile's saved state (run 0) or
//     from zero (run 1), keeping h_t and the decay products cum_t (of a
//     up to t) in registers, and forms its local adjoint sum lc = sum
//     cum_t C_t g_t (the carry it would hand the run before it from a
//     zero carry in).  A shuffle gives run 1 run 0's end state, which
//     pass 2 adds (h_t += cum_t h_start); another hands the adjoint
//     across: run 1's carry out (lc + cum carry in) is run 0's carry in.
//     Pass 3 walks the run's steps backwards from its carry, a_t
//     recomputed (a second exp: a_t kept beside h_t and cum_t would
//     spill at the 128 registers two blocks an SM allow): dh, its
//     partial sums over the lane's 4 states (y, sum dh B, the A a h term
//     of ddtf; 3 register adds each) into shared memory, dA in
//     registers, and dB | dC (4 + 4 values a step) reduced over the
//     warp's channels by a reduce-scatter that halves the values at each
//     shuffle level (2 levels at d_state 16), then over the warps in
//     shared memory once a tile.  Run 0's carry out is the earlier
//     tile's carry in.
//   * Epilogue, once a (t, channel): the P partials a sum; dtf, g,
//     softplus' and silu' again from the tile's raw rows (so that the
//     prologue's rows are the passes' alone, one buffer); ddt, dx, dz in
//     the model's dtype into a staged tile, stored one tile later as
//     16-byte row segments; dD and ddt_bias by item in shared memory.
//   * The cluster's dB | dC: each block's tile sums wait in its shared
//     memory, two groups of BWD_GROUP tiles; one cluster barrier a group
//     rather than a tile, and in the group after, each block reads a
//     quarter of the four blocks' sums of one tile an iteration through
//     distributed shared memory (the first block also the quarters of
//     blocks past d_in), adds them in rank order after the epilogue, and
//     writes them to the cluster's one partial row: d_in / 128 rows of (B, S, 2 st) reach device memory, not d_in
//     / 32.  The grid pads to whole clusters; a block past d_in computes
//     and stores nothing.
//
// dA, dD and ddt_bias go to per-sequence partials; the caller sums the
// partials (over clusters, over sequences) afterwards.  Every sum has a
// fixed order and there are no float atomics, so two launches give the
// same bits.
constexpr int BWD_CLUSTER = 4;        // blocks of a cluster, along channels
constexpr int BWD_GROUP = 4;          // tiles a cluster barrier
constexpr int BWD_STAGES = 3;         // TMA ring depth
constexpr int OROW = 40;              // elements a row of a staged output
constexpr int NQ = 3;                 // prologue rows: dtf, dtf x, g

template <int ST, typename In>
struct BwdGeo {
  static constexpr int P = ST / SPT;                 // lanes a channel
  static constexpr int LOG_P = P == 4 ? 2 : P == 2 ? 1 : 0;
  static constexpr int THREADS = CPB * P * R;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CH_W = 16 / P;                // channels a half-warp
  // reduce-scatter levels of dB | dC over a half-warp's channels (8
  // values a lane: 4 dB, 4 dC), the values a lane keeps, and the lanes
  // of a half-warp left holding the same ones
  static constexpr int LEVELS = 4 - LOG_P < 3 ? 4 - LOG_P : 3;
  static constexpr int NV = 8 >> LEVELS;
  static constexpr int DUP = CH_W >> LEVELS;
  static constexpr int NSLOT = WARPS * DUP;          // partials a (t, value)
  static constexpr int BC = 2 * ST;
  static constexpr int RAW = T * CPB * (int)sizeof(In);   // one (t, c) box
  static constexpr int BC_BYTES = T * BC * (int)sizeof(In);
  static constexpr int LOAD_BYTES = 4 * RAW + BC_BYTES;
  static constexpr int STAGE_BYTES = (LOAD_BYTES + 127) / 128 * 128;
  static constexpr int QF = CPB * ROW;               // floats a prologue row set
  // the partial sums over a lane's states, [part][channel][step], a
  // part's rows 8 floats apart so that neither the passes' 16-byte
  // stores nor the epilogue's loads meet on a bank
  static constexpr int PSTRIDE = CPB * ROW + 8;
  static constexpr int PART = P * PSTRIDE;
  static constexpr int OUT = T * OROW;               // elements a staged output
  // shared memory, in bytes: the ring; the rows the prologue fills (the
  // passes read them, the epilogue reads the ring); the partials over
  // states (y, dh . B, the A a h term of ddtf) and over the warps'
  // channels; two groups of BWD_GROUP tiles of the block's dB | dC for
  // the cluster; two staged tiles of ddt, dx, dz; each thread's A and
  // the state before its run's first step; the epilogue's dD and
  // ddt_bias by item; dt's bias and D
  static constexpr int OFF_Q = BWD_STAGES * STAGE_BYTES;
  static constexpr int OFF_BC = OFF_Q + NQ * QF * 4;
  static constexpr int OFF_PART = OFF_BC + T * BC * 4;
  static constexpr int OFF_RED = OFF_PART + 3 * PART * 4;
  static constexpr int OFF_TILE = OFF_RED + T * NSLOT * BC * 4;
  static constexpr int OFF_OUT = OFF_TILE + 2 * BWD_GROUP * T * BC * 4;
  static constexpr int OFF_A = OFF_OUT + 2 * 3 * OUT * (int)sizeof(In);
  static constexpr int OFF_FIN = OFF_A + 2 * THREADS * SPT * 4;
  static constexpr int OFF_BIAS = OFF_FIN + 2 * T * CPB * 4;
  static constexpr int OFF_D = OFF_BIAS + CPB * 4;
  static constexpr int OFF_BAR = OFF_D + CPB * 4;
  static constexpr int SMEM = OFF_BAR + 8 * BWD_STAGES;
  // the epilogue's (t, channel) items a thread: warp-items of 8
  // channels x 4 steps, so that its channel-major loads meet on no bank
  static constexpr int NITEM = T * CPB / THREADS;
  static_assert(CPB == 32 && T == 16, "the epilogue's item map");
  static_assert(T * BC / 4 <= THREADS, "a tile's dB | dC a float4 a thread");
  static_assert(OFF_Q % 128 == 0 && (OUT * (int)sizeof(In)) % 16 == 0,
                "aligned buffers");
};

struct BwdMaps {
  CUtensorMap dt, x, z, dout, bc;
};

struct BwdArgs {
  const void* dt_bias;
  const float *A, *D, *dh_last, *states;
  void *ddt, *dx, *dz;
  float *dbc_part, *red_part, *dh0;
  int B, S, d_in;
};

// The backward's mbarrier wait: a bounded spin that traps (a launch
// error) where a wait never ends, rather than hanging the card.
__device__ __forceinline__ void bwd_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0; n < (1u << 24); ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// ---- thread-block clusters -------------------------------------------- //
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// 16 bytes of block `rank`'s shared memory at this block's address `a`
__device__ __forceinline__ float4 ld_cluster4(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// Iteration j's boxes (tile n_tiles - 1 - j) into its stage (one thread).
template <typename G>
__device__ __forceinline__ void issue_bwd(const BwdMaps& m, unsigned char* smem,
                                          uint32_t bar0, int j, int n_tiles,
                                          int c0, int row0) {
  const int s = j % BWD_STAGES;
  const uint32_t st = smem_u32(smem + s * G::STAGE_BYTES);
  const uint32_t bar = bar0 + 8 * s;
  const int row = row0 + (n_tiles - 1 - j) * T;
  mbar_expect_tx(bar, G::LOAD_BYTES);
  tma_load_2d(st, &m.dt, bar, c0, row);
  tma_load_2d(st + G::RAW, &m.x, bar, c0, row);
  tma_load_2d(st + 2 * G::RAW, &m.z, bar, c0, row);
  tma_load_2d(st + 3 * G::RAW, &m.dout, bar, c0, row);
  tma_load_2d(st + 4 * G::RAW, &m.bc, bar, 0, row);
}

// d_state 16: 512 threads an SM (two blocks; up to 128 registers a
// thread, for a run's h_t and cum_t), so that at falcon-mamba-7b's width
// its 512 blocks run in two waves on 132 SMs.
template <int ST, typename In>
__global__ void __cluster_dims__(BWD_CLUSTER, 1, 1)
    __launch_bounds__(BwdGeo<ST, In>::THREADS, 2)
selective_scan_bwd_kernel(const __grid_constant__ BwdMaps maps,
                          const __grid_constant__ BwdArgs p) {
  using G = BwdGeo<ST, In>;
  constexpr int P = G::P, THREADS = G::THREADS, BC = G::BC, QF = G::QF;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem + G::OFF_Q);
  float* s_bc = reinterpret_cast<float*>(smem + G::OFF_BC);
  float* s_part = reinterpret_cast<float*>(smem + G::OFF_PART);
  float* s_red = reinterpret_cast<float*>(smem + G::OFF_RED);
  float* s_tile = reinterpret_cast<float*>(smem + G::OFF_TILE);
  In* s_out = reinterpret_cast<In*>(smem + G::OFF_OUT);
  float* s_fin = reinterpret_cast<float*>(smem + G::OFF_FIN);
  float* s_bias = reinterpret_cast<float*>(smem + G::OFF_BIAS);
  float* s_d = reinterpret_cast<float*>(smem + G::OFF_D);
  const uint32_t bar0 = smem_u32(smem + G::OFF_BAR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int run = lane >> RUN_SHIFT;
  const int q = lane & ((1 << RUN_SHIFT) - 1);
  const int part = q % P, cw = q / P;
  float* const s_a = reinterpret_cast<float*>(smem + G::OFF_A) + tid * SPT;
  float* const s_h = s_a + THREADS * SPT;
  const int ch = warp * G::CH_W + cw;
  const int b = blockIdx.y, c0 = blockIdx.x * CPB, c = c0 + ch;
  const int S = p.S, d_in = p.d_in;
  const bool live = c < d_in;
  const bool dead = c0 >= d_in;               // a block padding the cluster
  const uint32_t rank = cluster_rank();
  const int row0 = b * S;
  const int n_tiles = (S + T - 1) / T;
  const size_t hi = ((size_t)b * d_in + c) * ST + part * SPT;

  *reinterpret_cast<float4*>(s_a) =
      live ? ld4(p.A + (size_t)c * ST + part * SPT)
           : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < CPB) {
    const bool ok = c0 + tid < d_in;
    s_bias[tid] = ok ? to_f(static_cast<const In*>(p.dt_bias)[c0 + tid]) : 0.f;
    s_d[tid] = ok ? p.D[c0 + tid] : 0.f;
  }
  for (int i = tid; i < 2 * BWD_GROUP * T * BC; i += THREADS) s_tile[i] = 0.f;
  // the epilogue's dD and ddt_bias, by item (each item a thread's own)
  for (int i = tid; i < 2 * T * CPB; i += THREADS) s_fin[i] = 0.f;
  // the thread that drives the ring: in the last warp, which takes no
  // share of the stores and the dB | dC sums
  const bool issuer = tid == THREADS - 1;
  if (issuer && !dead) {
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < BWD_STAGES && j < n_tiles; ++j)
      issue_bwd<G>(maps, smem, bar0, j, n_tiles, c0, row0);
  }
  // the adjoint entering the tile (every lane holds its channel's), dA
  float carry[SPT], dA[SPT];
  {
    const float4 v = live && p.dh_last != nullptr
                         ? ld4(p.dh_last + hi)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    carry[0] = v.x, carry[1] = v.y, carry[2] = v.z, carry[3] = v.w;
#pragma unroll
    for (int j = 0; j < SPT; ++j) dA[j] = 0.f;
  }
  // the prologue's channel (THREADS is a multiple of CPB)
  const int pc = tid % CPB;
  __syncthreads();

  // ---- ddt, dx, dz of iteration j's tile: 16-byte row segments
  auto store_tile = [&](int j) {
    constexpr int EL = 16 / (int)sizeof(In);          // elements a segment
    constexpr int SEGS = CPB / EL;                    // segments a row
    const int t0 = (n_tiles - 1 - j) * T;
    const In* src = s_out + (j & 1) * 3 * G::OUT;
#pragma unroll 1
    for (int i = tid; i < 3 * T * SEGS; i += THREADS) {
      const int qn = i / (T * SEGS), r = i % (T * SEGS);
      const int t = r / SEGS, col = c0 + (r % SEGS) * EL;
      In* const dst = static_cast<In*>(qn == 0 ? p.ddt : qn == 1 ? p.dx
                                                                 : p.dz);
      if (t0 + t < S && col < d_in)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + t0 + t) * d_in +
                                  col) =
            *reinterpret_cast<const uint4*>(src + qn * G::OUT + t * OROW +
                                            (r % SEGS) * EL);
    }
  };
  // ---- the block's dB | dC of iteration j's tile, kept for the cluster:
  // by groups of BWD_GROUP tiles, two groups
  auto tile_sums = [&](int j) {
    return s_tile + ((j / BWD_GROUP) & 1) * BWD_GROUP * T * BC +
           (j % BWD_GROUP) * T * BC;
  };
  // ---- the cluster's dB | dC of iteration j's tile: each block reads a
  // quarter of the four blocks' tile sums (the first block also the
  // quarters of blocks past d_in; cluster_load says whether this thread
  // takes a value) and, later, sums them in rank order into the
  // cluster's partial row (cluster_sum), so that the loads' latency
  // hides behind the work between
  constexpr int QI = T * BC / 4 / BWD_CLUSTER;      // float4s a quarter
  const int n_live = (d_in + CPB - 1) / CPB -
                     (int)(blockIdx.x / BWD_CLUSTER) * BWD_CLUSTER;
  const int quarter = tid / QI;
  const bool mine = tid < T * BC / 4 &&
                    (quarter < n_live ? quarter : 0) == (int)rank;
  float4 cl4[BWD_CLUSTER];
  auto cluster_load = [&](int j) -> bool {
    const int t = tid / (BC / 4), col = (tid % (BC / 4)) * 4;
    if (!mine || (n_tiles - 1 - j) * T + t >= S)
      return false;
    const uint32_t a = smem_u32(tile_sums(j) + t * BC + col);
#pragma unroll
    for (int r = 0; r < BWD_CLUSTER; ++r) cl4[r] = ld_cluster4(a, r);
    return true;
  };
  auto cluster_sum = [&](int j) {
    const int t = tid / (BC / 4), col = (tid % (BC / 4)) * 4;
    float4 acc = cl4[0];
#pragma unroll
    for (int r = 1; r < BWD_CLUSTER; ++r)
      acc.x += cl4[r].x, acc.y += cl4[r].y, acc.z += cl4[r].z,
          acc.w += cl4[r].w;
    const size_t cl = blockIdx.x / BWD_CLUSTER;
    *reinterpret_cast<float4*>(
        p.dbc_part +
        ((cl * p.B + b) * S + (n_tiles - 1 - j) * T + t) * BC + col) = acc;
  };

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int k = n_tiles - 1 - it, t0 = k * T;
    float* const qb = s_q;                           // dtf, dtf x, g rows
    float* const bcb = s_bc;
    const unsigned char* stg = smem + (it % BWD_STAGES) * G::STAGE_BYTES;
    const In* g_dt = reinterpret_cast<const In*>(stg);
    const In* g_x = reinterpret_cast<const In*>(stg + G::RAW);
    const In* g_z = reinterpret_cast<const In*>(stg + 2 * G::RAW);
    const In* g_do = reinterpret_cast<const In*>(stg + 3 * G::RAW);
    const In* g_bc = reinterpret_cast<const In*>(stg + 4 * G::RAW);
    // the state the tile starts from (run 0's), read early
    const float4 hst =
        live && run == 0
            ? ld4(p.states + (((size_t)b * n_tiles + k) * d_in + c) * ST +
                  part * SPT)
            : make_float4(0.f, 0.f, 0.f, 0.f);

    // ---- prologue: two steps of one channel a thread
    if (!dead) {
      bwd_wait(bar0 + 8 * (it % BWD_STAGES), (it / BWD_STAGES) & 1);
#pragma unroll 1
      for (int i = tid; i < CPB * T / 2; i += THREADS) {
        const int t2 = (i / CPB) * 2;
        float dv[2], gv[2], dxv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = t2 + u;
          const bool ok = t0 + t < S && c0 + pc < d_in;
          const float v =
              round_as(to_f(g_dt[t * CPB + pc]) + s_bias[pc], In());
          const float d =
              v > SOFTPLUS_THRESHOLD ? v : LN2 * lg2(1.f + ex2(v * LOG2E));
          const float x = to_f(g_x[t * CPB + pc]);
          const float z = to_f(g_z[t * CPB + pc]);
          const float sg = rcp(1.f + ex2(-z * LOG2E));
          dv[u] = ok ? d : 0.f;
          dxv[u] = ok ? d * x : 0.f;
          gv[u] = ok ? to_f(g_do[t * CPB + pc]) * (z * sg) : 0.f;
        }
        float* r = qb + pc * ROW + t2;
        *reinterpret_cast<float2*>(r) = make_float2(dv[0], dv[1]);
        *reinterpret_cast<float2*>(r + QF) = make_float2(dxv[0], dxv[1]);
        *reinterpret_cast<float2*>(r + 2 * QF) = make_float2(gv[0], gv[1]);
      }
      // Bm | Cm, two values a thread (BC is even)
#pragma unroll 1
      for (int i = 2 * tid; i < T * BC; i += 2 * THREADS) {
        const bool ok = t0 + i / BC < S;
        *reinterpret_cast<float2*>(bcb + i) =
            ok ? make_float2(to_f(g_bc[i]), to_f(g_bc[i + 1]))
               : make_float2(0.f, 0.f);
      }
    }
    // tile it's prologue written; iteration it - 1's epilogue done (its
    // stage free, its staged outputs written)
    __syncthreads();
    if (!dead && it > 0) {
      if (issuer && it - 1 + BWD_STAGES < n_tiles)
        issue_bwd<G>(maps, smem, bar0, it - 1 + BWD_STAGES, n_tiles, c0,
                     row0);
      store_tile(it - 1);
    }

    if (!dead) {
      const float* qd = qb + ch * ROW + run * L;      // this run's steps
      const float* pb = bcb + run * L * BC + part * SPT;
      const float4 av = ld4(s_a);
      const float a2[SPT] = {av.x * LOG2E, av.y * LOG2E, av.z * LOG2E,
                             av.w * LOG2E};
      // ---- pass 1: the run's states (run 0 from the tile's saved
      // state, run 1 from zero), its a_t, decay product cum and local
      // adjoint sum lc = sum cum_t C_t g_t
      const float hs0[SPT] = {hst.x, hst.y, hst.z, hst.w};
      float cm[L][SPT], h[L][SPT], lc[SPT];
      float2 dq2, xq2, gq2;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if ((i & 1) == 0) {
          dq2 = *reinterpret_cast<const float2*>(qd + i);
          xq2 = *reinterpret_cast<const float2*>(qd + QF + i);
          gq2 = *reinterpret_cast<const float2*>(qd + 2 * QF + i);
        }
        const float d = (i & 1) ? dq2.y : dq2.x, dx = (i & 1) ? xq2.y : xq2.x;
        const float g = (i & 1) ? gq2.y : gq2.x;
        const float4 bv = ld4(pb + i * BC), cv = ld4(pb + i * BC + ST);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float at = ex2(d * a2[j]);
          h[i][j] = fmaf(at, i == 0 ? hs0[j] : h[i - 1][j], dx * get(bv, j));
          cm[i][j] = i == 0 ? at : cm[i - 1][j] * at;
          lc[j] = fmaf(cm[i][j], get(cv, j) * g, i == 0 ? 0.f : lc[j]);
        }
      }
      // ---- run 1 starts where run 0 ends; pass 2 adds cum_t h_start
      float hs1[SPT], hp0[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float e = __shfl_sync(FULL, h[L - 1][j], q);
        hs1[j] = run ? e : 0.f;
        hp0[j] = run ? e : hs0[j];                    // h before step 0
      }
      // kept out of the registers pass 3 needs until its last step
      *reinterpret_cast<float4*>(s_h) =
          make_float4(hp0[0], hp0[1], hp0[2], hp0[3]);
#pragma unroll
      for (int i = 0; i < L; ++i) {
#pragma unroll
        for (int j = 0; j < SPT; ++j) h[i][j] = fmaf(cm[i][j], hs1[j], h[i][j]);
      }
      // ---- the adjoint across runs: run 1's carry out (cum, its decay
      // product, times its carry in, plus lc) enters run 0
      float rc[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float out1 = fmaf(cm[L - 1][j], carry[j], lc[j]);
        const float in0 = __shfl_sync(FULL, out1, q | (1 << RUN_SHIFT));
        rc[j] = run ? carry[j] : in0;
      }
      // ---- pass 3: the run's steps backwards from its carry
      const float A[SPT] = {av.x, av.y, av.z, av.w};
      float* py = s_part + part * G::PSTRIDE + ch * ROW + run * L;
      float2 yq, sq, tq;
      // the lane's reduce-scatter bits (a channel's bits of the lane)
      const int b1 = (lane >> G::LOG_P) & 1, b2 = (lane >> (G::LOG_P + 1)) & 1,
                b3 = (lane >> (G::LOG_P + 2)) & 1;
      const int idx0 = (G::LEVELS >= 1 ? b1 * 4 : 0) +
                       (G::LEVELS >= 2 ? b2 * 2 : 0) +
                       (G::LEVELS >= 3 ? b3 : 0);
      const int gi = (idx0 >> 2) * ST + part * SPT + (idx0 & 3);
      const int slot = warp * G::DUP + (cw >> G::LEVELS);
#pragma unroll
      for (int i = L - 1; i >= 0; --i) {
        if ((i & 1) == 1) {
          dq2 = *reinterpret_cast<const float2*>(qd + i - 1);
          xq2 = *reinterpret_cast<const float2*>(qd + QF + i - 1);
          gq2 = *reinterpret_cast<const float2*>(qd + 2 * QF + i - 1);
        }
        const float d = (i & 1) ? dq2.y : dq2.x, dx = (i & 1) ? xq2.y : xq2.x;
        const float g = (i & 1) ? gq2.y : gq2.x;
        const float4 bv = ld4(pb + i * BC), cv = ld4(pb + i * BC + ST);
        if (i == 0) {
          const float4 v = ld4(s_h);
          hp0[0] = v.x, hp0[1] = v.y, hp0[2] = v.z, hp0[3] = v.w;
        }
        float yp = 0.f, sp = 0.f, tp = 0.f, v[8];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float dh = fmaf(get(cv, j), g, rc[j]);
          yp = fmaf(h[i][j], get(cv, j), yp);
          v[j] = dh * dx;                             // dB
          v[SPT + j] = g * h[i][j];                   // dC
          sp = fmaf(dh, get(bv, j), sp);
          const float ar = ex2(d * a2[j]);             // recomputed
          const float w = dh * (ar * (i == 0 ? hp0[j] : h[i - 1][j]));
          dA[j] = fmaf(d, w, dA[j]);
          tp = fmaf(A[j], w, tp);
          rc[j] = ar * dh;
        }
        if (i & 1) {
          yq.y = yp, sq.y = sp, tq.y = tp;
        } else {
          yq.x = yp, sq.x = sp, tq.x = tp;
          *reinterpret_cast<float2*>(py + i) = yq;
          *reinterpret_cast<float2*>(py + G::PART + i) = sq;
          *reinterpret_cast<float2*>(py + 2 * G::PART + i) = tq;
        }
        // dB | dC over the half-warp's channels: each level halves the
        // values a lane keeps (the lower half where its bit is 0)
        if constexpr (G::LEVELS >= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float send = b1 ? v[j] : v[4 + j];
            const float keep = b1 ? v[4 + j] : v[j];
            v[j] = keep + __shfl_xor_sync(FULL, send, 1 << G::LOG_P);
          }
        }
        if constexpr (G::LEVELS >= 2) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float send = b2 ? v[j] : v[2 + j];
            const float keep = b2 ? v[2 + j] : v[j];
            v[j] = keep + __shfl_xor_sync(FULL, send, 2 << G::LOG_P);
          }
        }
        if constexpr (G::LEVELS >= 3) {
          const float send = b3 ? v[0] : v[1];
          const float keep = b3 ? v[1] : v[0];
          v[0] = keep + __shfl_xor_sync(FULL, send, 4 << G::LOG_P);
        }
        float* r = s_red + ((run * L + i) * G::NSLOT + slot) * BC + gi;
        if constexpr (G::NV == 2) *reinterpret_cast<float2*>(r) =
            make_float2(v[0], v[1]);
        else *r = v[0];
      }
      // run 0's carry out leaves the tile: the earlier tile's carry in
#pragma unroll
      for (int j = 0; j < SPT; ++j) carry[j] = __shfl_sync(FULL, rc[j], q);
    }

    // the cluster's dB | dC of the tile BWD_GROUP before, read now and
    // summed after the epilogue (a group's first iteration waits for the
    // cluster barrier's arrive that closed the group before)
    bool cl_take = false;
    if (it >= BWD_GROUP) {
      if (it % BWD_GROUP == 0) cluster_wait();
      cl_take = cluster_load(it - BWD_GROUP);
    }
    // tile it's partials written
    __syncthreads();

    if (!dead) {
      // ---- the block's dB | dC: the partials over warps, in slot order
      if (tid < T * BC / 4) {
        const int t = tid / (BC / 4), col = (tid % (BC / 4)) * 4;
        const float* r = s_red + t * G::NSLOT * BC + col;
        float4 acc = ld4(r);
#pragma unroll
        for (int s = 1; s < G::NSLOT; ++s) {
          const float4 v = ld4(r + s * BC);
          acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
        }
        *reinterpret_cast<float4*>(tile_sums(it) + t * BC + col) = acc;
      }
      // ---- epilogue, a (t, channel) an item
      In* o = s_out + (it & 1) * 3 * G::OUT;
#pragma unroll
      for (int n = 0; n < G::NITEM; ++n) {
        const int i = tid + n * THREADS, w = i >> 5, l = i & 31;
        const int ec = (w % 4) * 8 + (l >> 2), et = (w / 4) * 4 + (l & 3);
        const int e = ec * ROW + et;
        float y = s_part[e], s = s_part[G::PART + e],
              tt = s_part[2 * G::PART + e];
#pragma unroll
        for (int pp = 1; pp < P; ++pp) {
          const float* r = s_part + pp * G::PSTRIDE + e;
          y += r[0];
          s += r[G::PART];
          tt += r[2 * G::PART];
        }
        // dtf and g as the prologue computes them (the same bits), from
        // the tile's raw rows: the prologue's rows belong to the passes
        const float v =
            round_as(to_f(g_dt[et * CPB + ec]) + s_bias[ec], In());
        const bool lin = v > SOFTPLUS_THRESHOLD;
        const float ev = ex2(v * LOG2E);
        const float d = lin ? v : LN2 * lg2(1.f + ev);
        const float dsp = lin ? 1.f : ev * rcp(1.f + ev);
        const float xv = to_f(g_x[et * CPB + ec]);
        const float zv = to_f(g_z[et * CPB + ec]);
        const float sg = rcp(1.f + ex2(-zv * LOG2E));
        const float dov = to_f(g_do[et * CPB + ec]);
        const float g = dov * (zv * sg);
        const float gz = dov * (sg * (1.f + zv * (1.f - sg)));
        const float ddtf = fmaf(xv, s, tt);
        const float gv = ddtf * dsp;
        // y + D x as two roundings, as the forward and the plain version
        const float yt = __fadd_rn(y, __fmul_rn(s_d[ec], xv));
        if (t0 + et < S && c0 + ec < d_in) {
          s_fin[i] = fmaf(g, xv, s_fin[i]);
          s_fin[T * CPB + i] += gv;
        }
        store1(o + et * OROW + ec, gv);
        store1(o + G::OUT + et * OROW + ec, fmaf(g, s_d[ec], s * d));
        store1(o + 2 * G::OUT + et * OROW + ec, gz * yt);
      }
    }
    // the group's dB | dC ready for the cluster; the group before's read
    // (its values are in registers: the store after the arrive, so that
    // the arrive's release does not wait for it)
    if (it % BWD_GROUP == BWD_GROUP - 1 || it == n_tiles - 1)
      cluster_arrive();
    if (cl_take) cluster_sum(it - BWD_GROUP);
  }

  // ---- the last tile's outputs and the cluster's last dB | dC
  __syncthreads();
  if (!dead) store_tile(n_tiles - 1);
  cluster_wait();
#pragma unroll 1
  for (int j = n_tiles > BWD_GROUP ? n_tiles - BWD_GROUP : 0; j < n_tiles; ++j)
    if (cluster_load(j)) cluster_sum(j);
  cluster_arrive();

  // ---- per-sequence partials: dA (runs summed), dh0 = the adjoint
  // leaving the first tile; dD, ddt_bias over a channel's items
  float* red = p.red_part + (size_t)b * d_in * (ST + 2);
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    dA[j] += __shfl_xor_sync(FULL, dA[j], 1 << RUN_SHIFT);
  if (live && run == 0) {
    *reinterpret_cast<float4*>(red + (size_t)c * ST + part * SPT) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (p.dh0 != nullptr)
      *reinterpret_cast<float4*>(p.dh0 + hi) =
          make_float4(carry[0], carry[1], carry[2], carry[3]);
  }
  __syncthreads();
  if (tid < CPB && c0 + tid < d_in) {
    // the items of channel tid: warp-items w = tid / 8 + 4 m, lanes
    // (tid % 8) * 4 + u
    float sd = 0.f, sb = 0.f;
#pragma unroll 1
    for (int m = 0; m < T / 4; ++m)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ((tid / 8) + 4 * m) * 32 + (tid % 8) * 4 + u;
        sd += s_fin[i];
        sb += s_fin[T * CPB + i];
      }
    red[(size_t)d_in * ST + c0 + tid] = sd;
    red[(size_t)d_in * (ST + 1) + c0 + tid] = sb;
  }
  // no block leaves while another block of the cluster reads its tiles
  cluster_wait();
}

// ---- host ------------------------------------------------------------- //
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the CUDA driver library the runtime loaded
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

// A (rows, cols) matrix whose rows sit `stride` elements apart as a 2-D
// map, boxes of box_rows x box_cols, unswizzled; reads past either edge
// give zeros.  False where TMA cannot take it (a base off 16 bytes, a
// stride not a multiple of 16 bytes).
bool encode(CUtensorMap* map, const void* ptr, bool bf16, long long rows,
            long long cols, long long stride, int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  const long long elt = bf16 ? 2 : 4;
  if (fn == nullptr || reinterpret_cast<u64>(ptr) % 16 ||
      (stride * elt) % 16 || rows < 1 || cols < 1)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(stride * elt)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {
  const void *dt, *x, *z, *bc, *A, *h0, *D, *dt_bias;
  void *out, *h_last, *states;
  int B, S, d_in, st;
  long long bc_stride, z_stride;
  bool bf16;
  cudaStream_t stream;
};

template <int ST, typename In, bool FUSED, bool STATES>
int launch_kernel(const Call& a) {
  using G = Geo<ST, In, FUSED>;
  const bool bf16 = std::is_same_v<In, __nv_bfloat16>;
  const long long rows = (long long)a.B * a.S;
  ScanMaps maps = {};
  bool ok = encode(&maps.dt, a.dt, FUSED && bf16, rows, a.d_in, a.d_in, T,
                   CPB) &&
            encode(&maps.x, a.x, bf16, rows, a.d_in, a.d_in, T, CPB) &&
            encode(&maps.bc, a.bc, bf16, rows, 2 * ST, a.bc_stride, T,
                   2 * ST);
  if (FUSED)
    ok = ok && encode(&maps.z, a.z, bf16, rows, a.d_in, a.z_stride, T, CPB);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = selective_scan_kernel<ST, In, FUSED, STATES>;
  // on every launch: the attributes hold per device, and setting them
  // costs less than a launch
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.d_in + CPB - 1) / CPB, a.B);
  kern<<<grid, G::THREADS, G::SMEM, a.stream>>>(
      maps, static_cast<const float*>(a.A), static_cast<const float*>(a.h0),
      static_cast<const float*>(a.D), static_cast<const In*>(a.dt_bias),
      static_cast<typename G::Out*>(a.out), static_cast<float*>(a.h_last),
      static_cast<float*>(a.states), a.S, a.d_in);
  return (int)cudaGetLastError();
}

template <int ST, typename In, bool FUSED>
int launch(const Call& a) {
  if constexpr (FUSED) {
    if (a.states != nullptr) return launch_kernel<ST, In, true, true>(a);
  }
  return launch_kernel<ST, In, FUSED, false>(a);
}

template <typename In, bool FUSED>
int launch_st(const Call& a) {
  switch (a.st) {
    case 4: return launch<4, In, FUSED>(a);
    case 8: return launch<8, In, FUSED>(a);
    case 16: return launch<16, In, FUSED>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool FUSED>
int dispatch(const Call& a) {
  if (a.B < 1 || a.S < 1 || a.d_in < 1 || a.B > 65535 ||
      (long long)a.B * a.S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return a.bf16 ? launch_st<__nv_bfloat16, FUSED>(a)
                : launch_st<float, FUSED>(a);
}

// The backward's inputs as the entry point takes them: the rows its
// tensor maps read, and what the kernel reads itself.
struct BwdCall {
  const void *dt, *x, *z, *bc, *dout;
  long long bc_stride, z_stride;
  BwdArgs args;
};

template <int ST, typename In>
int launch_bwd(const BwdCall& a, cudaStream_t stream) {
  using G = BwdGeo<ST, In>;
  const bool bf16 = std::is_same_v<In, __nv_bfloat16>;
  const int d_in = a.args.d_in;
  const long long rows = (long long)a.args.B * a.args.S;
  BwdMaps maps = {};
  if (!encode(&maps.dt, a.dt, bf16, rows, d_in, d_in, T, CPB) ||
      !encode(&maps.x, a.x, bf16, rows, d_in, d_in, T, CPB) ||
      !encode(&maps.z, a.z, bf16, rows, d_in, a.z_stride, T, CPB) ||
      !encode(&maps.dout, a.dout, bf16, rows, d_in, d_in, T, CPB) ||
      !encode(&maps.bc, a.bc, bf16, rows, 2 * ST, a.bc_stride, T, 2 * ST))
    return (int)cudaErrorInvalidValue;
  auto kern = selective_scan_bwd_kernel<ST, In>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  // whole clusters along the channels; the blocks past d_in pad them
  const int n_blk = (d_in + CPB - 1) / CPB;
  const int grid_x = (n_blk + BWD_CLUSTER - 1) / BWD_CLUSTER * BWD_CLUSTER;
  kern<<<dim3(grid_x, a.args.B), G::THREADS, G::SMEM, stream>>>(maps,
                                                                 a.args);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_bwd_st(int st, const BwdCall& a, cudaStream_t stream) {
  switch (st) {
    case 4: return launch_bwd<4, In>(a, stream);
    case 8: return launch_bwd<8, In>(a, stream);
    case 16: return launch_bwd<16, In>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: dt, x, bc, A, h0, y, h_last (device pointers: dt (B, S, d_in) fp32,
// softplus'd; x (B, S, d_in) in the input dtype; bc the (b, t) rows of
// Bm | Cm, 2 st values side by side, bc_stride elements apart; A (d_in,
// st), h0 and h_last (B, d_in, st), y (B, S, d_in) fp32; all contiguous
// but bc), B, S, d_in, st, bc_stride, is_bf16, stream.
extern "C" int selective_scan_forward(const long long* a) {
  Call c = {};
  c.dt = (const void*)a[0];
  c.x = (const void*)a[1];
  c.bc = (const void*)a[2];
  c.A = (const void*)a[3];
  c.h0 = (const void*)a[4];
  c.out = (void*)a[5];
  c.h_last = (void*)a[6];
  c.B = (int)a[7];
  c.S = (int)a[8];
  c.d_in = (int)a[9];
  c.st = (int)a[10];
  c.bc_stride = a[11];
  c.bf16 = a[12] != 0;
  c.stream = (cudaStream_t)a[13];
  if (c.h0 == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<false>(c);
}

// a: dt, x, z, bc, A, h0, D, dt_bias, out, h_last, states (device
// pointers: dt (B, S, d_in) before its bias and softplus, x, out (B, S,
// d_in) and z (B, S, d_in) with rows z_stride elements apart, in the
// model's dtype; bc as above; A (d_in, st), D (d_in,) fp32; dt_bias
// (d_in,) in the model's dtype; h0 (B, d_in, st) fp32 or 0 for zeros;
// h_last fp32; states (B, ceil(S / 16), d_in, st) fp32, each tile's
// starting state, or 0 to write none), B, S, d_in, st, bc_stride,
// z_stride, is_bf16, stream.
extern "C" int selective_scan_fused(const long long* a) {
  Call c = {};
  c.dt = (const void*)a[0];
  c.x = (const void*)a[1];
  c.z = (const void*)a[2];
  c.bc = (const void*)a[3];
  c.A = (const void*)a[4];
  c.h0 = (const void*)a[5];
  c.D = (const void*)a[6];
  c.dt_bias = (const void*)a[7];
  c.out = (void*)a[8];
  c.h_last = (void*)a[9];
  c.states = (void*)a[10];
  c.B = (int)a[11];
  c.S = (int)a[12];
  c.d_in = (int)a[13];
  c.st = (int)a[14];
  c.bc_stride = a[15];
  c.z_stride = a[16];
  c.bf16 = a[17] != 0;
  c.stream = (cudaStream_t)a[18];
  if (c.D == nullptr || c.dt_bias == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(c);
}

// a: dt, x, z, bc, A, D, dt_bias, dout, dh_last, states, ddt, dx, dz,
// dbc_part, red_part, dh0 (device pointers: the fused entry point's
// inputs as it takes them, h0 aside; dout (B, S, d_in) in the model's
// dtype; dh_last (B, d_in, st) fp32 or 0 for zeros; states the forward's
// (B, ceil(S / 16), d_in, st) fp32; out: ddt, dx, dz (B, S, d_in) in the
// model's dtype; dbc_part (ceil(d_in / 128), B, S, 2 st) fp32, each
// cluster's dB | dC over its channels; red_part (B, d_in (st + 2)) fp32,
// each sequence's dA (d_in, st), dD, ddt_bias; dh0 (B, d_in, st) fp32 or
// 0 to write none), B, S, d_in, st, bc_stride, z_stride, is_bf16,
// stream.  The caller sums the partials over their leading axis.
extern "C" int selective_scan_fused_backward(const long long* a) {
  BwdCall c = {};
  BwdArgs& p = c.args;
  c.dt = (const void*)a[0];
  c.x = (const void*)a[1];
  c.z = (const void*)a[2];
  c.bc = (const void*)a[3];
  p.A = (const float*)a[4];
  p.D = (const float*)a[5];
  p.dt_bias = (const void*)a[6];
  c.dout = (const void*)a[7];
  p.dh_last = (const float*)a[8];
  p.states = (const float*)a[9];
  p.ddt = (void*)a[10];
  p.dx = (void*)a[11];
  p.dz = (void*)a[12];
  p.dbc_part = (float*)a[13];
  p.red_part = (float*)a[14];
  p.dh0 = (float*)a[15];
  p.B = (int)a[16];
  p.S = (int)a[17];
  p.d_in = (int)a[18];
  const int st = (int)a[19];
  c.bc_stride = a[20];
  c.z_stride = a[21];
  const bool bf16 = a[22] != 0;
  const cudaStream_t stream = (cudaStream_t)a[23];
  if (p.B < 1 || p.S < 1 || p.d_in < 1 || p.B > 65535 ||
      (long long)p.B * p.S >= (1ll << 31) || p.states == nullptr ||
      p.D == nullptr || p.dt_bias == nullptr)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_bwd_st<__nv_bfloat16>(st, c, stream)
              : launch_bwd_st<float>(st, c, stream);
}
