// Shared tile math of the level-1 KDE kernels (kde_rowsum.cu, kde_sampler.cu).
//
// Replaces: src/repro/kernels/kde_rowsum/kernel.py:_tile_kernel_values, the
// (bm, bn) kernel-value tile that every TPU level-1 kernel of the repo reduces.
//
// One CTA owns BM query rows and sweeps a contiguous column range [jlo, jhi)
// of the dataset in chunks of BN columns.  Each chunk is staged through shared
// memory DK coordinates at a time; every thread keeps a TM x TN register
// micro-tile of partial distances and, once the chunk's distances are complete,
// turns them into kernel values and adds them to TM per-row sums.  Kernel
// values never leave registers, so the (m, n) matrix is never formed.
//
// Bound on the H100: for the L2 kinds at d = 16 the work per pair is d FMAs of
// the cross term plus one expf/sqrtf/powf, so the tile is bound by FP32 FMA
// issue and the MUFU transcendental rate, not by bytes (every staged value is
// reused BM or BN times).  For the laplacian at d = 784 every coordinate costs
// a subtract and an add with |.|, so it is bound by FP32 issue.  The design
// answers both the same way: a 4 x 4 register micro-tile gives 16 FMAs (or
// 16 sub+abs-add pairs) for 8 shared-memory loads, the norms of the L2
// factorization are computed once per staged chunk by one thread per row
// instead of per pair, and no tensor cores or TF32 are used (IEEE f32, as the
// reference's f32 path).
//
// Cost per CTA: shared memory DK x (BM + 1) + DK x (BN + 1) + BM + BN floats
// = 16 x 65 x 2 + 128 floats = 8.8 KB; registers: 16 accumulators + 8 operands
// + 4 row sums per thread.  256 threads, so up to 8 CTAs per SM by threads.
//
// Masking: query rows >= m are staged as zeros and never written; dataset
// columns >= jhi contribute nothing (jhi <= n), so callers pass the dataset
// unpadded.  Coordinates >= d are staged as zeros on both sides, which adds 0
// to both the L2 cross term and the L1 sum, so d needs no tile multiple.
//
// The bf16 policy (DESIGN.md §14; replaces the precision="bf16" branch of
// _tile_kernel_values and its _finish_l2_bf16): three more kind ids, the L2
// kinds with bf16 operands.  Their tiles round every staged coordinate to
// bf16 (round to nearest even) once, where it lands in shared memory or in
// a register, so the norms and the cross term are f32 sums of exact
// products of the rounded values; finish() rounds the gaussian and
// exponential argument to bf16 and reads exp from the 65,536-entry table
// (kde_sampler/ref.py bf16_exp_table, 256 KB in global memory, gathered
// through the read-only path: L1 and L2 keep the few KB a sweep touches),
// carried in TableParams.  The rational quadratic finishes in
// f32 as before.  The f32 kinds never read the table: the kde_hash kernels
// take their f32 instances' arguments as the 12-byte Params, unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace kde {

enum Kind : int {
  GAUSSIAN = 0, EXPONENTIAL = 1, RATIONAL_QUADRATIC = 2, LAPLACIAN = 3,
  GAUSSIAN_BF16 = 4, EXPONENTIAL_BF16 = 5, RATIONAL_QUADRATIC_BF16 = 6,
};

// The kind's operands are rounded to bf16.
__host__ __device__ constexpr bool is_bf16(int kind) { return kind >= GAUSSIAN_BF16; }

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 64;          // dataset columns per staged chunk
constexpr int DK = 16;          // coordinates per staged step
constexpr int TX = 16;          // threads along the column axis
constexpr int TY = 16;          // threads along the row axis
constexpr int TM = BM / TY;     // rows per thread (4)
constexpr int TN = BN / TX;     // columns per thread (4)
constexpr int THREADS = TX * TY;

struct Params {
  float inv_bw;    // 1 / bandwidth
  float inv_bw2;   // (1 / bandwidth)^2, rounded once on the host
  float beta;      // rational quadratic exponent
};

// Params and the bf16 exp table (the bf16 gaussian and exponential kinds;
// null elsewhere).
struct TableParams {
  float inv_bw, inv_bw2, beta;
  const float* table;
};

// v rounded to bf16 (nearest even) and back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A staged coordinate of a KIND tile: rounded to bf16 for the bf16 kinds.
template <int KIND>
__device__ __forceinline__ float operand(float v) {
  return is_bf16(KIND) ? round_bf16(v) : v;
}

// Four coordinates at once (the same value for the f32 kinds).
template <int KIND>
__device__ __forceinline__ float4 operand4(float4 v) {
  if constexpr (is_bf16(KIND)) {
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
    v.z = round_bf16(v.z);
    v.w = round_bf16(v.w);
  }
  return v;
}

// exp(y) for y rounded to bf16: the table entry of its bit pattern.
__device__ __forceinline__ float exp_table(float y, const float* table) {
  return __ldg(table + __bfloat16_as_ushort(__float2bfloat16_rn(y)));
}

struct TileSmem {
  float qs[DK][BM + 1];   // +1 column: conflict-light transposed stores
  float xs[DK][BN + 1];
  float qn[BM];           // ||q||^2 of the CTA's query rows (L2 kinds)
  float xn[BN];           // ||x||^2 of the chunk's columns (L2 kinds)
};

// P: Params or TableParams (the bf16 gaussian and exponential kinds read
// its table).
template <int KIND, class P>
__device__ __forceinline__ float finish(float acc, float qn, float xn, const P& p) {
  if (KIND == LAPLACIAN) return expf(-acc * p.inv_bw);
  const float d2 = fmaxf(qn + xn - 2.0f * acc, 0.0f);
  if (KIND == GAUSSIAN) return expf(-d2 * p.inv_bw2);
  if (KIND == EXPONENTIAL) return expf(-sqrtf(d2) * p.inv_bw);
  if constexpr (KIND == GAUSSIAN_BF16) return exp_table(-d2 * p.inv_bw2, p.table);
  if constexpr (KIND == EXPONENTIAL_BF16) return exp_table(-sqrtf(d2) * p.inv_bw, p.table);
  return powf(1.0f + d2 * p.inv_bw2, -p.beta);
}

// Adds sum_{j in [jlo, jhi)} k(q_i, x_j) to rs[r] for this thread's rows
// i = i0 + ty + TY * r; each thread covers columns tx + TX * c of every chunk,
// so the caller must still reduce rs across the TX threads of a row
// (row_reduce).  Must be called by all THREADS threads of the CTA.
template <int KIND>
__device__ void tile_row_sums(const float* __restrict__ q, const float* __restrict__ x,
                              int m, int d, int i0, int jlo, int jhi,
                              const TableParams& p, float (&rs)[TM], TileSmem& sm) {
  constexpr bool L2 = KIND != LAPLACIAN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int j0 = jlo; j0 < jhi; j0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
    if (L2) {
      if (tid < BM) sm.qn[tid] = 0.0f;
      else if (tid < BM + BN) sm.xn[tid - BM] = 0.0f;
    }
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int e = tid; e < BM * DK; e += THREADS) {
        const int kk = e % DK, ii = e / DK;
        const int gi = i0 + ii, gk = k0 + kk;
        sm.qs[kk][ii] = (gi < m && gk < d) ? operand<KIND>(q[(size_t)gi * d + gk]) : 0.0f;
      }
      for (int e = tid; e < BN * DK; e += THREADS) {
        const int kk = e % DK, jj = e / DK;
        const int gj = j0 + jj, gk = k0 + kk;
        sm.xs[kk][jj] = (gj < jhi && gk < d) ? operand<KIND>(x[(size_t)gj * d + gk]) : 0.0f;
      }
      __syncthreads();
      if (L2) {
        // one thread per row / column accumulates the staged chunk's norm
        if (tid < BM) {
          float s = 0.0f;
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) s = fmaf(sm.qs[kk][tid], sm.qs[kk][tid], s);
          sm.qn[tid] += s;
        } else if (tid < BM + BN) {
          const int jj = tid - BM;
          float s = 0.0f;
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) s = fmaf(sm.xs[kk][jj], sm.xs[kk][jj], s);
          sm.xn[jj] += s;
        }
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = sm.qs[kk][ty + TY * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) b[c] = sm.xs[kk][tx + TX * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            if (L2) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
            else acc[r][c] += fabsf(a[r] - b[c]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float qn = L2 ? sm.qn[ty + TY * r] : 0.0f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int jj = tx + TX * c;
        if (j0 + jj < jhi) {
          const float xn = L2 ? sm.xn[jj] : 0.0f;
          rs[r] += finish<KIND>(acc[r][c], qn, xn, p);
        }
      }
    }
    __syncthreads();   // norms are reset by the next chunk
  }
}

// Sums rs[r] over the TX threads that share a row.  Those threads are TX
// consecutive lanes of one warp (TX divides 32), so xor-shuffles within the
// group reduce in a fixed order: the result is deterministic.  Lane tx == 0
// of each group holds the row total afterwards.
__device__ __forceinline__ void row_reduce(float (&rs)[TM]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off, TX);
}

}  // namespace kde
