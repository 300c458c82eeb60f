// Weighted gathered kernel values of the hashed KDE estimator (Section 3.1's
// NEAR + Horvitz-Thompson FAR decomposition).
//
// kde_weighted_kv_launch replaces
//     src/repro/kernels/kde_hash/kernel.py:weighted_kv_pallas
//   out[i, j] = wgt[i, j] * k(q_i, x[cols[i, j]])            -> (m, t)
// kde_weighted_kv_sum_launch replaces
//     src/repro/kernels/kde_hash/kernel.py:weighted_kv_sum_pallas
//   out[i] = sum_j wgt[i, j] * k(q_i, x[cols[i, j]])         -> (m,)
//
// The TPU kernel took the gathered rows xr = x[cols] as an (m, t, d) operand,
// formed by an XLA gather, because a Pallas TPU block cannot gather rows.
// Here every thread loads its own row of x, so the kernel takes x (n, d) and
// cols (m, t) and the (m, t, d) tensor never exists: at the sampler's frontier
// shape (m = 1024, t = 1152, d = 16) that tensor is 75 MB written and read
// again per edge batch.  Columns outside [0, n) are clamped to [0, n - 1], as
// a JAX gather clamps; the corruption flag is raised outside the kernel.
//
// Bound on the H100: bytes, not operations.  At d = 16 a (row, column) pair
// costs 2d + 6 = 38 FP32 operations (d FMAs of the cross term, d of the
// column norm, the distance assembly, exp, the weight) against at least 76
// bytes (the 64-byte row of x, the column index, the weight and, for the
// (m, t) entry point, the output).  The design answers with the fused gather
// above and 16-byte row loads where d % 4 == 0 and x is 16-byte aligned.
//
// Layout: one CTA of 128 threads per query row.  The query row sits in shared
// memory; thread tid takes columns tid, tid + 128, ...  The L2 kinds
// accumulate qq, xx and the cross term over d and assemble
// d2 = max(qq + xx - 2 cross, 0) through kde::finish (the reference's
// rowwise_kv formula, not sum (q - x)^2); the laplacian sums |q - x|.  IEEE
// f32 throughout: expf/sqrtf/powf, no fast-math, no tensor cores.  The (m,)
// sum reduces each thread's columns in index order, then warp xor-shuffles,
// then the four warp totals in warp order: a fixed order, so the result is
// the same from run to run.  No atomics.
#include "kde_tile.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int KIND, bool SUM, bool VEC4>
__global__ void __launch_bounds__(THREADS)
weighted_kv_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   const int* __restrict__ cols, const float* __restrict__ wgt,
                   float* __restrict__ out, int n, int d, int t, kde::Params p) {
  extern __shared__ float qs[];              // d floats: this CTA's query row
  __shared__ float warp_sum[WARPS];
  constexpr bool L2 = KIND != kde::LAPLACIAN;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < d; k += THREADS) qs[k] = q[(size_t)row * d + k];
  __syncthreads();
  float qq = 0.0f;
  if (L2) {
    for (int k = 0; k < d; ++k) qq = fmaf(qs[k], qs[k], qq);
  }
  const int* c_row = cols + (size_t)row * t;
  const float* w_row = wgt + (size_t)row * t;
  float total = 0.0f;
  for (int j = tid; j < t; j += THREADS) {
    const int c = min(max(c_row[j], 0), n - 1);
    const float* xr = x + (size_t)c * d;
    float acc = 0.0f, xx = 0.0f;
    if (VEC4) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      for (int k4 = 0; k4 < d / 4; ++k4) {
        const float4 v = __ldg(xr4 + k4);
        const float* qk = qs + 4 * k4;
        if (L2) {
          acc = fmaf(qk[0], v.x, acc); xx = fmaf(v.x, v.x, xx);
          acc = fmaf(qk[1], v.y, acc); xx = fmaf(v.y, v.y, xx);
          acc = fmaf(qk[2], v.z, acc); xx = fmaf(v.z, v.z, xx);
          acc = fmaf(qk[3], v.w, acc); xx = fmaf(v.w, v.w, xx);
        } else {
          acc += fabsf(qk[0] - v.x);
          acc += fabsf(qk[1] - v.y);
          acc += fabsf(qk[2] - v.z);
          acc += fabsf(qk[3] - v.w);
        }
      }
    } else {
      for (int k = 0; k < d; ++k) {
        const float v = __ldg(xr + k);
        if (L2) {
          acc = fmaf(qs[k], v, acc);
          xx = fmaf(v, v, xx);
        } else {
          acc += fabsf(qs[k] - v);
        }
      }
    }
    const float val = kde::finish<KIND>(acc, qq, xx, p) * w_row[j];
    if (SUM) total += val;
    else out[(size_t)row * t + j] = val;
  }
  if (SUM) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = total;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
      out[row] = s;
    }
  }
}

template <int KIND, bool SUM>
void launch_kind(int m, bool vec4, cudaStream_t st, const float* q, const float* x,
                 const int* cols, const float* wgt, float* out, int n, int d, int t,
                 const kde::Params& p) {
  const size_t smem = sizeof(float) * (size_t)d;
  if (vec4)
    weighted_kv_kernel<KIND, SUM, true><<<m, THREADS, smem, st>>>(q, x, cols, wgt, out,
                                                                   n, d, t, p);
  else
    weighted_kv_kernel<KIND, SUM, false><<<m, THREADS, smem, st>>>(q, x, cols, wgt, out,
                                                                    n, d, t, p);
}

template <bool SUM>
int launch(const float* q, const float* x, const int* cols, const float* wgt,
           float* out, int m, int n, int d, int t, int vec4, int kind, float inv_bw,
           float inv_bw2, float beta, cudaStream_t st) {
  const kde::Params p{inv_bw, inv_bw2, beta};
  const bool v4 = vec4 != 0;
  switch (kind) {
    case kde::GAUSSIAN:
      launch_kind<kde::GAUSSIAN, SUM>(m, v4, st, q, x, cols, wgt, out, n, d, t, p);
      break;
    case kde::EXPONENTIAL:
      launch_kind<kde::EXPONENTIAL, SUM>(m, v4, st, q, x, cols, wgt, out, n, d, t, p);
      break;
    case kde::RATIONAL_QUADRATIC:
      launch_kind<kde::RATIONAL_QUADRATIC, SUM>(m, v4, st, q, x, cols, wgt, out, n, d,
                                                t, p);
      break;
    case kde::LAPLACIAN:
      launch_kind<kde::LAPLACIAN, SUM>(m, v4, st, q, x, cols, wgt, out, n, d, t, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec4 != 0 promises d % 4 == 0 and a 16-byte aligned x (the wrapper checks).
int kde_weighted_kv_launch(const float* q, const float* x, const int* cols,
                           const float* wgt, float* out, int m, int n, int d, int t,
                           int vec4, int kind, float inv_bw, float inv_bw2, float beta,
                           void* stream) {
  return launch<false>(q, x, cols, wgt, out, m, n, d, t, vec4, kind, inv_bw, inv_bw2,
                       beta, static_cast<cudaStream_t>(stream));
}

int kde_weighted_kv_sum_launch(const float* q, const float* x, const int* cols,
                               const float* wgt, float* out, int m, int n, int d,
                               int t, int vec4, int kind, float inv_bw, float inv_bw2,
                               float beta, void* stream) {
  return launch<true>(q, x, cols, wgt, out, m, n, d, t, vec4, kind, inv_bw, inv_bw2,
                      beta, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
