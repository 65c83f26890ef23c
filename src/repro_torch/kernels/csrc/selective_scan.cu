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
// Design (a simple one: the forward's grid, time sequential in a tile).
// A block owns CPB = 32 channels of one sequence, a thread one (channel,
// state), so a channel's states sit on st neighbouring lanes.  It walks
// the tiles from the last to the first; for each:
//   * prologue, once a (t, channel): v = dt + bias rounded as the
//     forward rounds it, dtf = softplus(v) as the forward computes it,
//     softplus'(v), dtf x, silu(z) and silu'(z) against dout, into shared
//     memory; Bm | Cm to fp32;
//   * recompute: each thread runs the tile's 16 steps from the saved
//     state, keeping h_t and a_t in registers; y_t by a shuffle sum over
//     the channel's lanes;
//   * reverse: the 16 steps backwards, the adjoint dh in a register
//     carried across tiles with dA; the sums over states by shuffles,
//     those over channels by shuffles within a warp and then over the
//     warps in shared memory;
//   * epilogue: ddt, dx, dz (model dtype) as coalesced rows, and the
//     block's partial dB | dC over its 32 channels into `dbc_part`.
// dA, dD and ddt_bias go to per-sequence partials; the caller sums the
// partials (over blocks, over sequences) afterwards: no float atomics,
// so two launches give the same bits.
//
// What bounds it: like the forward, its MUFU work (the recomputed state
// exps; softplus, sigmoid and silu once a (t, channel)), its fp32 work
// and the bytes it moves (inputs, the saved states, the outputs); the
// shuffles of the reductions, 14 a (t, channel, state) at d_state 16,
// are what this design spends most on.
template <int ST>
struct BwdGeo {
  static constexpr int THREADS = CPB * ST;        // a thread a (channel, state)
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TC = T * CPB;               // floats a (t, channel) buffer
  // shared memory, in floats: nine (t, channel) buffers (dtf, dtf x, x,
  // g, gz = dout silu'(z), softplus'(v), y, dx over states, ddtf), B | C,
  // the per-warp dB | dC, dt's bias and D, the per-thread dD and dbias
  static constexpr int OFF_BC = 9 * TC;
  static constexpr int OFF_RED = OFF_BC + T * 2 * ST;
  static constexpr int OFF_BIAS = OFF_RED + T * WARPS * 2 * ST;
  static constexpr int OFF_D = OFF_BIAS + CPB;
  static constexpr int OFF_FIN = OFF_D + CPB;
  static constexpr int SMEM = (OFF_FIN + 2 * THREADS) * 4;
  static_assert(32 % ST == 0, "a channel's states within a warp");
};

struct BwdArgs {
  const void *dt, *x, *z, *bc, *dt_bias, *dout;
  const float *A, *D, *dh_last, *states;
  void *ddt, *dx, *dz;
  float *dbc_part, *red_part, *dh0;
  long long bc_stride, z_stride;
  int B, S, d_in;
};

template <int ST, typename In>
__global__ void __launch_bounds__(BwdGeo<ST>::THREADS)
selective_scan_bwd_kernel(const __grid_constant__ BwdArgs p) {
  using G = BwdGeo<ST>;
  constexpr int THREADS = G::THREADS, WARPS = G::WARPS, TC = G::TC;
  extern __shared__ __align__(16) float sm[];
  float* s_dtf = sm;
  float* s_dtx = sm + TC;
  float* s_x = sm + 2 * TC;
  float* s_g = sm + 3 * TC;
  float* s_gz = sm + 4 * TC;
  float* s_dsp = sm + 5 * TC;
  float* s_y = sm + 6 * TC;
  float* s_dxs = sm + 7 * TC;
  float* s_ddtf = sm + 8 * TC;
  float* s_bc = sm + G::OFF_BC;
  float* s_red = sm + G::OFF_RED;
  float* s_bias = sm + G::OFF_BIAS;
  float* s_d = sm + G::OFF_D;
  float* s_fin = sm + G::OFF_FIN;

  const In* dt = static_cast<const In*>(p.dt);
  const In* xg = static_cast<const In*>(p.x);
  const In* zg = static_cast<const In*>(p.z);
  const In* bcg = static_cast<const In*>(p.bc);
  const In* dog = static_cast<const In*>(p.dout);
  const In* bias = static_cast<const In*>(p.dt_bias);
  In* ddt = static_cast<In*>(p.ddt);
  In* dxg = static_cast<In*>(p.dx);
  In* dzg = static_cast<In*>(p.dz);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = tid % ST, ch = tid / ST;         // this thread's (state, channel)
  const int b = blockIdx.y, c0 = blockIdx.x * CPB, c = c0 + ch;
  const int S = p.S, d_in = p.d_in;
  const bool live = c < d_in;
  const int n_tiles = (S + T - 1) / T;
  const size_t hi = ((size_t)b * d_in + c) * ST + s;   // (b, c, s) of h

  if (tid < CPB) {
    const bool ok = c0 + tid < d_in;
    s_bias[tid] = ok ? to_f(bias[c0 + tid]) : 0.f;
    s_d[tid] = ok ? p.D[c0 + tid] : 0.f;
  }
  const float A = live ? p.A[(size_t)c * ST + s] : 0.f;
  const float A2 = A * LOG2E;
  float carry = live && p.dh_last != nullptr ? p.dh_last[hi] : 0.f;
  float dA = 0.f;
  // the epilogue's channel is fixed a thread (THREADS a multiple of CPB):
  // its dD and ddt_bias over the (t, channel) items it takes
  const int ec = tid % CPB;
  float dD = 0.f, dbias = 0.f;
  __syncthreads();

#pragma unroll 1
  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * T;
    // ---- prologue, a (t, channel) at a time
#pragma unroll 1
    for (int i = tid; i < TC; i += THREADS) {
      const int t = i / CPB, col = c0 + ec;
      float dtf = 0.f, dtx = 0.f, xv = 0.f, g = 0.f, gz = 0.f, dsp = 0.f;
      if (t0 + t < S && col < d_in) {
        const size_t o = (size_t)(b * S + t0 + t) * d_in + col;
        const float v = round_as(to_f(dt[o]) + s_bias[ec], In());
        const bool lin = v > SOFTPLUS_THRESHOLD;
        dtf = lin ? v : LN2 * lg2(1.f + ex2(v * LOG2E));
        dsp = lin ? 1.f : rcp(1.f + ex2(-v * LOG2E));
        xv = to_f(xg[o]);
        dtx = dtf * xv;
        const float zv = to_f(zg[(size_t)(b * S + t0 + t) * p.z_stride + col]);
        const float sg = rcp(1.f + ex2(-zv * LOG2E));
        const float dov = to_f(dog[o]);
        g = dov * (zv * sg);
        gz = dov * (sg * (1.f + zv * (1.f - sg)));
      }
      s_dtf[i] = dtf;
      s_dtx[i] = dtx;
      s_x[i] = xv;
      s_g[i] = g;
      s_gz[i] = gz;
      s_dsp[i] = dsp;
    }
#pragma unroll 1
    for (int i = tid; i < T * 2 * ST; i += THREADS) {
      const int t = i / (2 * ST);
      s_bc[i] = t0 + t < S ? to_f(bcg[(size_t)(b * S + t0 + t) * p.bc_stride +
                                     i % (2 * ST)])
                           : 0.f;
    }
    __syncthreads();

    // ---- recompute the tile's states from the one it starts from
    const float h_start =
        live ? p.states[(((size_t)b * n_tiles + k) * d_in + c) * ST + s]
             : 0.f;
    float hs[T], as[T];
    {
      float h = h_start;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float a = ex2(s_dtf[t * CPB + ch] * A2);
        h = fmaf(a, h, s_dtx[t * CPB + ch] * s_bc[t * 2 * ST + s]);
        hs[t] = h;
        as[t] = a;
        float yp = h * s_bc[t * 2 * ST + ST + s];
#pragma unroll
        for (int off = ST / 2; off > 0; off >>= 1)
          yp += __shfl_xor_sync(FULL, yp, off);
        if (s == 0) s_y[t * CPB + ch] = yp;
      }
    }

    // ---- the tile's steps backwards
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      if (t0 + t >= S) continue;                   // the same for the block
      const float d = s_dtf[t * CPB + ch], g = s_g[t * CPB + ch];
      const float Bv = s_bc[t * 2 * ST + s], Cv = s_bc[t * 2 * ST + ST + s];
      const float hp = t > 0 ? hs[t - 1] : h_start;
      const float dh = fmaf(Cv, g, carry);
      const float ahp = as[t] * hp;
      float dC = g * hs[t];
      float dB = dh * s_dtx[t * CPB + ch];
      float dxp = dh * Bv;
      float ddp = dh * fmaf(A, ahp, Bv * s_x[t * CPB + ch]);
      dA = fmaf(dh * d, ahp, dA);
      carry = as[t] * dh;
#pragma unroll
      for (int off = ST / 2; off > 0; off >>= 1) {     // over states
        dxp += __shfl_xor_sync(FULL, dxp, off);
        ddp += __shfl_xor_sync(FULL, ddp, off);
      }
      if (s == 0) {
        s_dxs[t * CPB + ch] = dxp * d;
        s_ddtf[t * CPB + ch] = ddp;
      }
#pragma unroll
      for (int off = ST; off < 32; off <<= 1) {        // over the warp's channels
        dB += __shfl_xor_sync(FULL, dB, off);
        dC += __shfl_xor_sync(FULL, dC, off);
      }
      if (lane < ST) {
        float* r = s_red + (t * WARPS + warp) * 2 * ST;
        r[lane] = dB;
        r[ST + lane] = dC;
      }
    }
    __syncthreads();

    // ---- epilogue: ddt, dx, dz rows; the block's dB | dC
#pragma unroll 1
    for (int i = tid; i < TC; i += THREADS) {
      const int t = i / CPB, col = c0 + ec;
      if (t0 + t >= S) break;                     // t grows with i
      if (col < d_in) {
        const size_t o = (size_t)(b * S + t0 + t) * d_in + col;
        const float xv = s_x[i], g = s_g[i];
        const float gv = s_ddtf[i] * s_dsp[i];
        // y + D x as two roundings, as the forward and the plain version
        const float yt = __fadd_rn(s_y[i], __fmul_rn(s_d[ec], xv));
        store1(ddt + o, gv);
        store1(dxg + o, fmaf(g, s_d[ec], s_dxs[i]));
        store1(dzg + o, s_gz[i] * yt);
        dD = fmaf(g, xv, dD);
        dbias += gv;
      }
    }
#pragma unroll 1
    for (int i = tid; i < T * 2 * ST; i += THREADS) {
      const int t = i / (2 * ST), j = i % (2 * ST);
      if (t0 + t >= S) break;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += s_red[(t * WARPS + w) * 2 * ST + j];
      p.dbc_part[(((size_t)blockIdx.x * p.B + b) * S + t0 + t) * 2 * ST + j] =
          acc;
    }
    // the next tile's prologue overwrites what the epilogue reads
    __syncthreads();
  }

  // ---- per-sequence partials: dA, dD, ddt_bias; dh0 = a_0 dh_0
  float* red = p.red_part + (size_t)b * d_in * (ST + 2);
  if (live) {
    red[(size_t)c * ST + s] = dA;
    if (p.dh0 != nullptr) p.dh0[hi] = carry;
  }
  s_fin[tid] = dD;
  s_fin[THREADS + tid] = dbias;
  __syncthreads();
  if (tid < CPB && c0 + tid < d_in) {
    float sd = 0.f, sb = 0.f;
#pragma unroll 1
    for (int r = tid; r < THREADS; r += CPB) {
      sd += s_fin[r];
      sb += s_fin[THREADS + r];
    }
    red[(size_t)d_in * ST + c0 + tid] = sd;
    red[(size_t)d_in * (ST + 1) + c0 + tid] = sb;
  }
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

template <int ST, typename In>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using G = BwdGeo<ST>;
  auto kern = selective_scan_bwd_kernel<ST, In>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.d_in + CPB - 1) / CPB, a.B), G::THREADS, G::SMEM,
         stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_bwd_st(int st, const BwdArgs& a, cudaStream_t stream) {
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
// model's dtype; dbc_part (ceil(d_in / 32), B, S, 2 st) fp32, each
// block's dB | dC over its channels; red_part (B, d_in (st + 2)) fp32,
// each sequence's dA (d_in, st), dD, ddt_bias; dh0 (B, d_in, st) fp32 or
// 0 to write none), B, S, d_in, st, bc_stride, z_stride, is_bf16,
// stream.  The caller sums the partials over their leading axis.
extern "C" int selective_scan_fused_backward(const long long* a) {
  BwdArgs p = {};
  p.dt = (const void*)a[0];
  p.x = (const void*)a[1];
  p.z = (const void*)a[2];
  p.bc = (const void*)a[3];
  p.A = (const float*)a[4];
  p.D = (const float*)a[5];
  p.dt_bias = (const void*)a[6];
  p.dout = (const void*)a[7];
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
  p.bc_stride = a[20];
  p.z_stride = a[21];
  const bool bf16 = a[22] != 0;
  const cudaStream_t stream = (cudaStream_t)a[23];
  if (p.B < 1 || p.S < 1 || p.d_in < 1 || p.B > 65535 ||
      (long long)p.B * p.S >= (1ll << 31) || p.states == nullptr ||
      p.D == nullptr || p.dt_bias == nullptr)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_bwd_st<__nv_bfloat16>(st, p, stream)
              : launch_bwd_st<float>(st, p, stream);
}
