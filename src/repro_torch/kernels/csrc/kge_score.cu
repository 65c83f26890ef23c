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
// HBM bytes bound them.  Design:
//   * one block per positive b, so B need not be padded (the Pallas kernel
//     pads B to block_b) and no two blocks write the same row;
//   * forward: h + r and r (or h * r and r * t) and t of the row go to
//     shared memory once; one warp per candidate (the positive, then each
//     negative), lanes over d with coalesced loads, a shuffle reduction;
//   * backward: thread c owns coordinate c of the row and loops over the K
//     negatives, reading neg[b, k, c] and writing grad_neg[b, k, c] once
//     (coalesced across threads), and sums grad h, r, t in registers: no
//     atomics.  TransE-L2 first needs each candidate's norm, one warp per
//     candidate as in the forward, so it reads the negatives twice.
// Simple and right first; fusing the row gather of the caller into the
// kernel would save the (B, K, d) round trip through HBM.
//
// Every entry point launches exactly one kernel on the given stream,
// allocates nothing, never synchronises, and returns cudaGetLastError().
// Its arguments come packed in one array of 64-bit integers (see the
// end of this file).

#include <cuda_runtime.h>

namespace {

enum Model { TRANSE_L1 = 0, TRANSE_L2 = 1, DISTMULT = 2 };

constexpr int FWD_THREADS = 256;
constexpr int BWD_MAX_THREADS = 256;

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

template <int MODEL>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
kge_backward_kernel(const float* __restrict__ h, const float* __restrict__ r,
                    const float* __restrict__ t,
                    const float* __restrict__ neg,
                    const unsigned char* __restrict__ ch,
                    const float* __restrict__ g_pos,
                    const float* __restrict__ g_negs, int K, int d,
                    float* __restrict__ gh, float* __restrict__ gr,
                    float* __restrict__ gt, float* __restrict__ gneg) {
  extern __shared__ float sh[];
  float* coef = sh;                                      // K + 1
  unsigned char* s_ch = (unsigned char*)(sh + K + 1);    // K
  const int b = blockIdx.x;
  const size_t row = (size_t)b * d;
  const size_t nb = (size_t)b * K;
  for (int j = threadIdx.x; j <= K; j += blockDim.x) {
    const float g = j == 0 ? g_pos[b] : g_negs[nb + j - 1];
    if (j > 0) s_ch[j - 1] = ch[nb + j - 1] != 0;
    coef[j] = MODEL == TRANSE_L1 ? -g : g;
  }
  __syncthreads();
  if (MODEL == TRANSE_L2) {
    // coef[j + 1] = -g / sqrt(sum x^2 + 1e-12), one warp per candidate
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int j = (int)(threadIdx.x >> 5) - 1; j < K; j += n_warps) {
      float acc = 0.0f;
      if (j < 0) {
        for (int c = lane; c < d; c += 32) {
          const float x = (h[row + c] + r[row + c]) - t[row + c];
          acc += x * x;
        }
      } else {
        const float* nrow = neg + (nb + j) * d;
        const bool head = s_ch[j] != 0;
        for (int c = lane; c < d; c += 32) {
          const float n = nrow[c];
          const float x = head ? (n + r[row + c]) - t[row + c]
                               : (h[row + c] + r[row + c]) - n;
          acc += x * x;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) coef[j + 1] = -coef[j + 1] / sqrtf(acc + 1e-12f);
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float hv = h[row + c], rv = r[row + c], tv = t[row + c];
    float a_h, a_r, a_t;
    if (MODEL == DISTMULT) {
      const float g0 = coef[0];
      const float hr = hv * rv, rt = rv * tv;
      a_h = g0 * rt;
      a_r = g0 * (hv * tv);
      a_t = g0 * hr;
      for (int k = 0; k < K; ++k) {
        const float gk = coef[k + 1];
        const size_t o = (nb + k) * d + c;
        const float n = neg[o];
        if (s_ch[k]) {          // score = sum n * (r * t)
          gneg[o] = gk * rt;
          a_r += gk * (n * tv);
          a_t += gk * (n * rv);
        } else {                // score = sum (h * r) * n
          gneg[o] = gk * hr;
          a_h += gk * (rv * n);
          a_r += gk * (hv * n);
        }
      }
    } else {
      const float hr = hv + rv;
      const float gx0 = grad_x<MODEL>(coef[0], hr - tv);
      a_h = gx0;
      a_r = gx0;
      a_t = -gx0;
      for (int k = 0; k < K; ++k) {
        const size_t o = (nb + k) * d + c;
        const float n = neg[o];
        if (s_ch[k]) {          // x = (n + r) - t
          const float gx = grad_x<MODEL>(coef[k + 1], (n + rv) - tv);
          gneg[o] = gx;
          a_r += gx;
          a_t -= gx;
        } else {                // x = (h + r) - n
          const float gx = grad_x<MODEL>(coef[k + 1], hr - n);
          gneg[o] = -gx;
          a_h += gx;
          a_r += gx;
        }
      }
    }
    gh[row + c] = a_h;
    gr[row + c] = a_r;
    gt[row + c] = a_t;
  }
}

inline int bwd_threads(int d) {
  int n = (d + 31) / 32 * 32;
  return n < 64 ? 64 : (n > BWD_MAX_THREADS ? BWD_MAX_THREADS : n);
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

int backward_launch(const float* h, const float* r, const float* t,
                    const float* neg, const unsigned char* ch,
                    const float* g_pos, const float* g_negs, int B, int K,
                    int d, int model, float* gh, float* gr, float* gt,
                    float* gneg, void* stream) {
  const size_t smem = ((size_t)(K + 1) * sizeof(float) + K + 15) / 16 * 16;
  const int threads = bwd_threads(d);
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case TRANSE_L1:
      kge_backward_kernel<TRANSE_L1><<<B, threads, smem, s>>>(
          h, r, t, neg, ch, g_pos, g_negs, K, d, gh, gr, gt, gneg);
      break;
    case TRANSE_L2:
      kge_backward_kernel<TRANSE_L2><<<B, threads, smem, s>>>(
          h, r, t, neg, ch, g_pos, g_negs, K, d, gh, gr, gt, gneg);
      break;
    case DISTMULT:
      kge_backward_kernel<DISTMULT><<<B, threads, smem, s>>>(
          h, r, t, neg, ch, g_pos, g_negs, K, d, gh, gr, gt, gneg);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
