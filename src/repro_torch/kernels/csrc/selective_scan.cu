// Mamba's selective scan (mamba1), forward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the scan in jnp
// (repro/models/blocks.py:605 _selective_scan_chunk, a log-depth
// associative scan over 256-step chunks under lax.scan).  Its plain
// version is repro_torch/kernels/ref.py::selective_scan.  For one layer:
//
//   h_t[b, c, s] = exp(dt[b, t, c] * A[c, s]) * h_{t-1}[b, c, s]
//                  + dt[b, t, c] * x[b, t, c] * Bm[b, t, s]
//   y[b, t, c]   = sum_s h_t[b, c, s] * Cm[b, t, s]
//
// from h_{-1} = h0, in fp32, over the whole sequence in one launch;
// h_last = h_{S-1}.  dt, A, h0, y and h_last are fp32; x, Bm and Cm are
// in the model's dtype (fp32 or bf16).  The D skip and the silu(z) gate
// stay outside, where the reference applies them.
//
// What bounds it: one exp per (b, t, c, s), on the SFUs (16 a clock an
// SM: 537 M of them at falcon-mamba-7b's B 2, S 2048, d_in 8192, st 16,
// ~0.13 ms), against ~340 MB read and written once (~0.10 ms at 3.35
// TB/s).  The design keeps the state in registers and reads each input
// once from device memory: a block owns CPB channels of one sequence; each
// channel's st states split over P = st / 4 neighbouring lanes (4 states a
// thread, so falcon-mamba runs 65,536 threads, ~16 warps an SM).  Time runs
// in tiles of T steps: the block loads tile k + 1's dt, x, Bm and Cm into
// registers (coalesced rows of CPB channels) while it computes tile k from
// shared memory.  A step's only dependence on the last is the state's
// FMA: each thread stores its partial y to shared memory, and the P
// partials of a (step, channel) are summed when the tile's y is written
// out, coalesced (no shuffle in the step loop).  exp is one MUFU.EX2
// (ex2.approx.ftz) of the argument times log2(e), folded into A.  Steps
// past S (the last tile) are never computed; channels past d_in load
// zeros and store nothing.
//
// Entry point: plain C, arguments packed in one int64 array, launches on
// the given stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SPT = 4;                // states a thread holds
constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one SFU instruction (relative error < 2^-22; results below
// 2^-126 flush to 0, which leaves a decayed state's last bits)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// 4 blocks an SM (128 registers a thread): falcon-mamba-7b's 512 blocks
// are then all resident at once on 132 SMs, with no second wave
template <int ST, typename In>
__global__ void __launch_bounds__(THREADS, 4)
selective_scan_kernel(const float* __restrict__ dt, const In* __restrict__ x,
                      const In* __restrict__ bm, const In* __restrict__ cm,
                      long long bc_stride, const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int d_in) {
  constexpr int P = ST / SPT;             // lanes a channel
  constexpr int CPB = THREADS / P;        // channels a block
  // time steps of one tile: 32, or 16 at 128 channels a block, which
  // keeps the tiles inside 48 KB of static shared memory
  constexpr int T = CPB >= 128 ? 16 : 32;
  constexpr int DX_PER = T * CPB / THREADS;   // dt (and x) loads a thread
  constexpr int BC_PER = (T * ST + THREADS - 1) / THREADS;
  __shared__ float s_dt[T][CPB];
  __shared__ float s_x[T][CPB];
  __shared__ __align__(16) float s_b[T][ST];
  __shared__ __align__(16) float s_c[T][ST];
  __shared__ __align__(16) float s_y[T][CPB * P];   // partial y a lane

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int ch = tid / P, part = tid % P;
  const int c = c0 + ch;
  const bool live = c < d_in;

  float a2[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const size_t i = (size_t)c * ST + part * SPT + j;
    a2[j] = live ? A[i] * LOG2E : 0.f;
    h[j] = live ? h0[((size_t)b * d_in) * ST + i] : 0.f;
  }

  const size_t row0 = (size_t)b * S;      // (b, t) row index of t = 0
  float r_dt[DX_PER], r_x[DX_PER], r_b[BC_PER], r_c[BC_PER];

  // tile t0's inputs into registers: rows past S and channels past d_in
  // read as 0 (dt = 0 leaves the state unchanged)
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < DX_PER; ++i) {
      const int e = i * THREADS + tid, r = e / CPB, col = e % CPB;
      const bool ok = t0 + r < S && c0 + col < d_in;
      const size_t off = (row0 + t0 + r) * d_in + c0 + col;
      r_dt[i] = ok ? dt[off] : 0.f;
      r_x[i] = ok ? to_f(x[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BC_PER; ++i) {
      const int e = i * THREADS + tid, r = e / ST, s = e % ST;
      const bool ok = e < T * ST && t0 + r < S;
      const size_t off = (row0 + t0 + r) * bc_stride + s;
      r_b[i] = ok ? to_f(bm[off]) : 0.f;
      r_c[i] = ok ? to_f(cm[off]) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < DX_PER; ++i) {
      const int e = i * THREADS + tid;
      s_dt[e / CPB][e % CPB] = r_dt[i];
      s_x[e / CPB][e % CPB] = r_x[i];
    }
#pragma unroll
    for (int i = 0; i < BC_PER; ++i) {
      const int e = i * THREADS + tid;
      if (e < T * ST) {
        s_b[e / ST][e % ST] = r_b[i];
        s_c[e / ST][e % ST] = r_c[i];
      }
    }
  };

  load(0);
  stage();
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += T) {
    const bool more = t0 + T < S;
    if (more) load(t0 + T);               // in flight during the tile
    const int steps = min(T, S - t0);
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {
      const float d = s_dt[t][ch];
      const float dx = d * s_x[t][ch];
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[t][part * SPT]);
      const float4 cv = *reinterpret_cast<const float4*>(&s_c[t][part * SPT]);
      const float bb[SPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[SPT] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = ex2(d * a2[j]) * h[j] + dx * bb[j];
        acc += h[j] * cc[j];
      }
      s_y[t][tid] = acc;                  // tid = ch * P + part
    }
    __syncthreads();                      // s_y written, s_dt.. read
#pragma unroll
    for (int i = 0; i < DX_PER; ++i) {
      const int e = i * THREADS + tid, r = e / CPB, col = e % CPB;
      if (r < steps && c0 + col < d_in)
        y[(row0 + t0 + r) * d_in + c0 + col] =
            sum_parts<P>(&s_y[r][col * P]);
    }
    if (more) stage();
    __syncthreads();
  }
  if (live) {
    float4* out = reinterpret_cast<float4*>(
        h_last + ((size_t)b * d_in + c) * ST + part * SPT);
    *out = make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <int ST, typename In>
int launch(const void* dt, const void* x, const void* bm, const void* cm,
           long long bc_stride, const void* A, const void* h0, void* y,
           void* h_last, int B, int S, int d_in, cudaStream_t stream) {
  constexpr int CPB = THREADS / (ST / SPT);
  const dim3 grid((d_in + CPB - 1) / CPB, B);
  selective_scan_kernel<ST, In><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const In*>(x),
      static_cast<const In*>(bm), static_cast<const In*>(cm), bc_stride,
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), S, d_in);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_st(int st, const void* dt, const void* x, const void* bm,
              const void* cm, long long bc_stride, const void* A,
              const void* h0, void* y, void* h_last, int B, int S, int d_in,
              cudaStream_t s) {
  switch (st) {
    case 4: return launch<4, In>(dt, x, bm, cm, bc_stride, A, h0, y, h_last, B, S, d_in, s);
    case 8: return launch<8, In>(dt, x, bm, cm, bc_stride, A, h0, y, h_last, B, S, d_in, s);
    case 16: return launch<16, In>(dt, x, bm, cm, bc_stride, A, h0, y, h_last, B, S, d_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: dt, x, bm, cm, A, h0, y, h_last (device pointers: dt (B, S, d_in)
// fp32; x (B, S, d_in), bm and cm (B, S, st) with row stride bc_stride in
// the input dtype; A (d_in, st), h0 and h_last (B, d_in, st), y (B, S,
// d_in) fp32; all contiguous but bm / cm, whose (b, t) row starts at
// (b * S + t) * bc_stride), B, S, d_in, st, bc_stride, is_bf16, stream.
extern "C" int selective_scan_forward(const long long* a) {
  const void *dt = (const void*)a[0], *x = (const void*)a[1],
             *bm = (const void*)a[2], *cm = (const void*)a[3],
             *A = (const void*)a[4], *h0 = (const void*)a[5];
  void *y = (void*)a[6], *h_last = (void*)a[7];
  const int B = (int)a[8], S = (int)a[9], d_in = (int)a[10], st = (int)a[11];
  const long long bc_stride = a[12];
  const bool bf16 = a[13] != 0;
  cudaStream_t s = (cudaStream_t)a[14];
  if (B < 1 || S < 1 || d_in < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_st<__nv_bfloat16>(st, dt, x, bm, cm, bc_stride, A, h0,
                                         y, h_last, B, S, d_in, s)
              : launch_st<float>(st, dt, x, bm, cm, bc_stride, A, h0, y,
                                 h_last, B, S, d_in, s);
}
