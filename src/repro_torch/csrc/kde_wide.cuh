// The 128-row tiles of the level-1 KDE kernels (kde_sampler.cu,
// kde_rowsum.cu): the wide register tile for d <= 32, the deep one for
// d > 32, and the bf16 kinds' tensor-core tile for d <= 32.
//
// Replaces, with kde_tile.cuh's generic tile:
// src/repro/kernels/kde_rowsum/kernel.py:_tile_kernel_values, the (bm, bn)
// kernel-value tile that every TPU level-1 kernel reduces.
//
// All three are block-sum sweeps: a CTA of 256 threads owns a 128-row query
// tile and a group of `group` consecutive level-1 blocks of `bn` columns, and
// hands each finished (row, block) sum to the caller's Store::put(a, s, gi,
// b) -- the masked, floored store of the sampler kernels or the raw store of
// blocksum / rowsum's partial pass.  `a` is the caller's launch-argument
// struct; the sweeps read its fields q, x, m, n, d, bn, nb, group and p.
// On the wide and deep tiles each thread keeps an 8 x 8 register tile
// (the mma tile: C fragments); rows past the valid range and
// coordinates past d are staged as zeros, which adds 0 to the L2 cross term,
// the norms and the L1 sum; columns past a block's end are masked in the
// epilogue.
//
// Bound on the H100: FP32 issue.  The L2 kinds cost one FMA a coordinate
// plus ~15 instructions a pair for the distance, the IEEE transcendental and
// the sum; the laplacian costs a subtract and an add with the |.| modifier a
// coordinate (Hopper has no packed f32 add), so at d = 784 it issues at
// least 2 d instructions a pair.
//
// - wide (d <= DK = 16 or 32; d % 4 == 0 and q, x 16-byte aligned, which the
//   host-side plans check): rows stay row-major in shared memory, padded by
//   4 floats, staged by 16-byte cp.async; the thread's rows and columns are
//   t + 16 r, fed by 16-byte loads along the coordinate axis (16 LDS.128 per
//   4 coordinates x 64 pairs).  The query tile is staged once per CTA; the
//   columns stream through two 128-column buffers, the next chunk's copies
//   overlapping the current chunk's math.  Two barriers a chunk.
// - deep (the plans take it for d > 32): DK = 16 coordinates of the 128
//   query rows and of 128 columns a step, staged k-major (t[k][row], stride
//   132) by 4-byte cp.async into two buffers; every step waits for its
//   coordinates, issues the next step's (the next 16 coordinates, else the
//   next 128 columns' first ones) and runs an outer product a coordinate:
//   the thread's rows and columns are 4 t + (0..3) and 64 + 4 t + (0..3),
//   four LDS.128 per 64 pairs, so 8 + 8 operand registers beside the 64
//   accumulators.  (Streamed row-major, the wide tile's 32 operand registers
//   left no room under the 128-register cap of 2 CTAs an SM: ptxas spilled
//   and serialised the subtract-add pairs; PERF.md's kernel findings have
//   the times.)
//   One barrier a step; the L2 kinds sum the norms of every step in
//   registers (two threads a row) and publish them once a column chunk.
//   Shared memory (4 DK 132 + 256) floats: 34,816 B.
// - mma (the bf16 kinds at d <= 32, same conditions as wide; every plan
//   takes it there, instance MMA + DK): the wide tile's staging, with the
//   cross term on the tensor cores.  See mma_block_sums below.
//
// The wide tile is built for the f32 kinds only.  The deep tile's bf16 kinds
// (kde_tile.cuh): cp.async copies raw bytes, so nothing is rounded in
// flight.  After its cp_async_wait_all() each thread rounds, in place,
// exactly the coordinates it copied itself (round_staged_kmajor walks the
// staging loop's own index pattern), before the barrier that already
// precedes the norms and the FMAs: a thread's own cp.async writes are
// visible to it after its wait, and the barrier publishes the rounded
// values.  So the bf16 deep tile adds no barrier and no instruction to the
// inner loop; the f32 kinds compile none of it.
#pragma once

#include <stdint.h>

#include "kde_tile.cuh"

// Static arguments of a launch of the 128-row tiles or the generic tile
// (kernels/build.py ``KdeTileShape``).
struct KdeTileShape {
  int m, n, d, bn, nb;
  int own64;      // own is int64 (else int32); sampler kernels only
  int instance;   // 0 generic, 16 or 32 the wide tile with that padded d, DEEP,
                  // MMA + 16 or MMA + 32 the bf16 tensor-core tile
  int group;      // consecutive level-1 blocks a CTA sums
  int kind;
  float inv_bw, inv_bw2, beta;
};

namespace kde {

constexpr int WIDE_THREADS = 256;
constexpr int DEEP = 1;        // KdeTileShape::instance of the deep tile
constexpr int DEEP_DK = 16;    // coordinates a deep step stages

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int DK>
struct Wide {
  static constexpr int BM = 128;          // query rows per CTA
  static constexpr int BN = 128;          // dataset columns per chunk
  static constexpr int TX = 16, TY = 16;  // threads along columns / rows
  static constexpr int TM = BM / TY, TN = BN / TX;   // 8 x 8 register tile
  static constexpr int RS = DK + 4;       // padded row stride in floats
  static constexpr int QS = 0;                       // [BM][RS]
  static constexpr int XS = QS + BM * RS;            // [2][BN][RS]
  static constexpr int QN = XS + 2 * BN * RS;        // [BM]
  static constexpr int XN = QN + BM;                 // [BN]
  static constexpr int BYTES = (XN + BN) * 4;
  static_assert(TX * TY == WIDE_THREADS && BM == BN && 2 * BM == WIDE_THREADS,
                "norms take two threads per row");
};

template <int DK>
struct Deep {
  static constexpr int BM = 128, BN = 128;
  static constexpr int LD = 132;          // k-major row stride: 16-byte rows, 4 banks apart
  static constexpr int QT = 0;                       // [2][DK][LD] query coordinates
  static constexpr int XT = QT + 2 * DK * LD;        // [2][DK][LD] column coordinates
  static constexpr int QN = XT + 2 * DK * LD;        // [BM]
  static constexpr int XN = QN + BM;                 // [BN]
  static constexpr int BYTES = (XN + BN) * 4;
  static_assert(WIDE_THREADS % DK == 0, "a thread stages one coordinate");
};

// Stage rows [0, ROWS) of src (row stride d floats) into dst (row stride RS)
// with 16-byte copies; rows >= valid and coordinates >= d are zero (d % 4 ==
// 0, so a 16-byte piece is all in or all out).
template <int DK, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int valid, int d) {
  constexpr int V = DK / 4;
  for (int e = threadIdx.x; e < ROWS * V; e += WIDE_THREADS) {
    const int r = e / V, k = 4 * (e % V);
    const bool ok = r < valid && k < d;
    cp_async16(dst + r * Wide<DK>::RS + k, ok ? src + (size_t)r * d + k : src, ok ? 16 : 0);
  }
}

// Stage coordinates [k0, k0 + DK) of rows [0, ROWS) of src (row stride d)
// k-major into dst[k][row] (stride Deep::LD) with 4-byte copies: a thread
// copies one coordinate of every (256 / DK)-th row.  Rows >= valid and
// coordinates >= d are zero.
template <int DK, int ROWS>
__device__ __forceinline__ void stage_kmajor(float* dst, const float* src, int valid, int d,
                                             int k0) {
  constexpr int STEP = WIDE_THREADS / DK;   // rows one pass of the CTA covers
  const int k = threadIdx.x % DK, r0 = threadIdx.x / DK;
  const bool kin = k0 + k < d;
  const float* s = src + (size_t)r0 * d + k0 + k;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int r = r0 + i * STEP;
    const bool ok = kin && r < valid;
    cp_async4(dst + k * Deep<DK>::LD + r, ok ? s + (size_t)i * STEP * d : src, ok ? 4 : 0);
  }
}

// Round to bf16, in place, the coordinates this thread staged with
// stage_kmajor<DK, ROWS>(dst, ...) (the same index pattern).
template <int DK, int ROWS>
__device__ __forceinline__ void round_staged_kmajor(float* dst) {
  constexpr int STEP = WIDE_THREADS / DK;
  float* p = dst + (threadIdx.x % DK) * Deep<DK>::LD + threadIdx.x / DK;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) p[i * STEP] = round_bf16(p[i * STEP]);
}

// Squared norm over the DK staged coordinates of k-major row `row`, by two
// threads (thread pairs tid, tid ^ 1).
template <int DK>
__device__ __forceinline__ float half_norm_kmajor(const float* t, int row, int half) {
  float s = 0.0f;
#pragma unroll
  for (int k = half * (DK / 2); k < (half + 1) * (DK / 2); ++k) {
    const float v = t[k * Deep<DK>::LD + row];
    s = fmaf(v, v, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// Squared norm of staged row `row`, by two threads (thread pairs tid, tid ^ 1).
template <int DK>
__device__ __forceinline__ float half_norm(const float* rows, int row, int half) {
  const float* p = rows + row * Wide<DK>::RS + half * (DK / 2);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < DK / 2; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// acc[r][c] += the DK coordinates of staged query rows qs and columns xs
// (row-major, stride RS): the cross term (L2 kinds) or the L1 distance
// (laplacian).
template <bool L2, int DK>
__device__ __forceinline__ void tile_chunk(float (&acc)[8][8], const float* qs,
                                           const float* xs, int tx, int ty) {
  using W = Wide<DK>;
#pragma unroll
  for (int k = 0; k < DK; k += 4) {
    float4 qa[W::TM];
#pragma unroll
    for (int r = 0; r < W::TM; ++r)
      qa[r] = *reinterpret_cast<const float4*>(qs + (ty + W::TY * r) * W::RS + k);
#pragma unroll
    for (int cc = 0; cc < W::TN; ++cc) {
      const float4 xb = *reinterpret_cast<const float4*>(xs + (tx + W::TX * cc) * W::RS + k);
#pragma unroll
      for (int r = 0; r < W::TM; ++r) {
        float v = acc[r][cc];
        if (L2) {
          v = fmaf(qa[r].x, xb.x, v);
          v = fmaf(qa[r].y, xb.y, v);
          v = fmaf(qa[r].z, xb.z, v);
          v = fmaf(qa[r].w, xb.w, v);
        } else {
          v += fabsf(qa[r].x - xb.x);
          v += fabsf(qa[r].y - xb.y);
          v += fabsf(qa[r].z - xb.z);
          v += fabsf(qa[r].w - xb.w);
        }
        acc[r][cc] = v;
      }
    }
  }
}

// acc[i][j] += the DK coordinates of staged query rows and columns held
// k-major (qt[k][row], xt[k][col], stride Deep::LD), the thread's rows and
// columns 4 t + (0..3) and 64 + 4 t + (0..3): an outer product a coordinate,
// fed by four 16-byte loads per 64 pairs.
template <bool L2, int DK, int LD>
__device__ __forceinline__ void tile_chunk_kmajor(float (&acc)[8][8], const float* qt,
                                                  const float* xt, int tx, int ty) {
#pragma unroll
  for (int k = 0; k < DK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(qt + k * LD + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(qt + k * LD + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(xt + k * LD + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(xt + k * LD + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = L2 ? fmaf(a[i], b[j], acc[i][j]) : acc[i][j] + fabsf(a[i] - b[j]);
  }
}

// Row (of thread row index t) or column (of t = tx) of register r: t + 16 r
// on the wide tile, 4 t + (r & 3) + 64 (r >> 2) on the deep tile.
template <bool DEEPMAP>
__device__ __forceinline__ int tile_line(int t, int r) {
  return DEEPMAP ? 4 * t + (r & 3) + 64 * (r >> 2) : t + 16 * r;
}

// rs[r] += the kernel values of a finished 128-column chunk (columns past
// the block's end, j0 + col >= jend, masked).
template <int KIND, bool DEEPMAP = false>
__device__ __forceinline__ void tile_finish(float (&rs)[8], float (&acc)[8][8],
                                            const float* qn, const float* xn, int tx, int ty,
                                            int j0, int jend, const TableParams& p) {
  using W = Wide<16>;
  constexpr bool L2 = KIND != LAPLACIAN;
  const bool full = j0 + W::BN <= jend;
#pragma unroll
  for (int cc = 0; cc < W::TN; ++cc) {
    const int col = tile_line<DEEPMAP>(tx, cc);
    const float xv = L2 ? xn[col] : 0.0f;
    const bool ok = full || j0 + col < jend;
#pragma unroll
    for (int r = 0; r < W::TM; ++r) {
      const float qv = L2 ? qn[tile_line<DEEPMAP>(ty, r)] : 0.0f;
      const float v = finish<KIND>(acc[r][cc], qv, xv, p);
      if (ok) rs[r] += v;
    }
  }
}

// Block b is complete: sum rs over the TX threads of a row (16 consecutive
// lanes: fixed-order xor sums, deterministic), hand the sums to Store, and
// reset rs.
template <class Store, bool DEEPMAP = false, class A>
__device__ __forceinline__ void tile_store(const A& a, float (&rs)[8], int tx, int ty, int i0,
                                           int b) {
  using W = Wide<16>;
#pragma unroll
  for (int r = 0; r < W::TM; ++r)
#pragma unroll
    for (int off = W::TX / 2; off > 0; off >>= 1)
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off, W::TX);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < W::TM; ++r) {
      const int gi = i0 + tile_line<DEEPMAP>(ty, r);
      if (gi < a.m) Store::put(a, rs[r], gi, b);
    }
  }
#pragma unroll
  for (int r = 0; r < W::TM; ++r) rs[r] = 0.0f;
}

// The wide sweep (d <= DK): blocks [blockIdx.x group, + group) of query tile
// blockIdx.y.  smem holds Wide<DK>::BYTES.
template <int KIND, int DK, class Store, class A>
__device__ __forceinline__ void wide_block_sums(float* smem, const A& a) {
  using W = Wide<DK>;
  static_assert(!is_bf16(KIND), "the bf16 kinds take the mma tile");
  constexpr bool L2 = KIND != LAPLACIAN;
  float* qs = smem + W::QS;
  float* qn = smem + W::QN;
  float* xn = smem + W::XN;
  const int tid = threadIdx.x;
  const int tx = tid % W::TX, ty = tid / W::TX;
  const int i0 = blockIdx.y * W::BM;
  // this CTA's blocks [b, b1), streamed as one sequence of chunks: chunk
  // (b, c) covers columns [b bn + c BN, min(b bn + (c + 1) BN, end of b))
  int b = blockIdx.x * a.group;
  const int b1 = min(a.nb, b + a.group);
  int c = 0;

  stage<DK, W::BM>(qs, a.q + (size_t)i0 * a.d, a.m - i0, a.d);
  stage<DK, W::BN>(smem + W::XS, a.x + (size_t)b * a.bn * a.d,
                   min(a.n - b * a.bn, a.bn), a.d);
  cp_async_commit();

  float rs[W::TM];
#pragma unroll
  for (int r = 0; r < W::TM; ++r) rs[r] = 0.0f;

  for (int step = 0;; ++step) {
    const int jend = min(a.n, (b + 1) * a.bn);          // end of block b
    const int j0 = b * a.bn + c * W::BN;
    // the chunk after this one: the next of block b, else block b + 1's first
    int nb_ = b, nc = c + 1;
    if (j0 + W::BN >= jend) { nb_ = b + 1; nc = 0; }
    const bool more = nb_ < b1;
    const float* xs = smem + W::XS + (step & 1) * W::BN * W::RS;
    cp_async_wait_all();
    __syncthreads();          // this chunk (and q) landed; the last one is done
    if (more) {
      const int nj0 = nb_ * a.bn + nc * W::BN;
      stage<DK, W::BN>(smem + W::XS + ((step + 1) & 1) * W::BN * W::RS,
                       a.x + (size_t)nj0 * a.d, min(a.n, (nb_ + 1) * a.bn) - nj0, a.d);
      cp_async_commit();
    }
    if (L2) {
      const float s = half_norm<DK>(xs, tid >> 1, tid & 1);
      if (!(tid & 1)) xn[tid >> 1] = s;
      if (step == 0) {
        const float t = half_norm<DK>(qs, tid >> 1, tid & 1);
        if (!(tid & 1)) qn[tid >> 1] = t;
      }
    }
    __syncthreads();          // norms visible

    float acc[W::TM][W::TN];
#pragma unroll
    for (int r = 0; r < W::TM; ++r)
#pragma unroll
      for (int cc = 0; cc < W::TN; ++cc) acc[r][cc] = 0.0f;
    tile_chunk<L2, DK>(acc, qs, xs, tx, ty);
    tile_finish<KIND>(rs, acc, qn, xn, tx, ty, j0, jend, a.p);
    if (nc == 0) tile_store<Store>(a, rs, tx, ty, i0, b);   // block b is complete
    if (!more) break;
    b = nb_;
    c = nc;
  }
}

// The deep sweep (the plans take it for d > 32): blocks [blockIdx.x group,
// + group) of query tile blockIdx.y, coordinates streamed DK at a time
// k-major.  smem holds Deep<DK>::BYTES.
template <int KIND, int DK, class Store, class A>
__device__ __forceinline__ void deep_block_sums(float* smem, const A& a) {
  using D = Deep<DK>;
  constexpr bool L2 = KIND != LAPLACIAN;
  float* qn = smem + D::QN;
  float* xn = smem + D::XN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * D::BM;
  const int nk = (a.d + DK - 1) / DK;
  const float* qrows = a.q + (size_t)i0 * a.d;
  // step (b, c, k): coordinates [k DK, (k + 1) DK) of the query tile and of
  // columns [b bn + c BN, min(b bn + (c + 1) BN, end of b))
  int b = blockIdx.x * a.group;
  const int b1 = min(a.nb, b + a.group);
  int c = 0, k = 0;

  stage_kmajor<DK, D::BM>(smem + D::QT, qrows, a.m - i0, a.d, 0);
  stage_kmajor<DK, D::BN>(smem + D::XT, a.x + (size_t)b * a.bn * a.d,
                          min(a.n - b * a.bn, a.bn), a.d, 0);
  cp_async_commit();

  float rs[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rs[r] = 0.0f;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.0f;
  float qn_r = 0.0f, xn_r = 0.0f;   // this thread pair's row norms so far

  for (int step = 0;; ++step) {
    const int jend = min(a.n, (b + 1) * a.bn);          // end of block b
    const int j0 = b * a.bn + c * D::BN;
    // the step after this one: the next coordinates, else the next chunk of
    // block b, else block b + 1's first
    int nb_ = b, nc = c, nk_ = k + 1;
    if (nk_ == nk) {
      nk_ = 0;
      nc = c + 1;
      if (j0 + D::BN >= jend) { nb_ = b + 1; nc = 0; }
    }
    const bool more = nb_ < b1;
    const int buf = (step & 1) * DK * D::LD;
    cp_async_wait_all();
    if (is_bf16(KIND)) {      // each thread rounds what it staged
      round_staged_kmajor<DK, D::BM>(smem + D::QT + buf);
      round_staged_kmajor<DK, D::BN>(smem + D::XT + buf);
    }
    __syncthreads();          // this step landed; the last step's reads are done
    if (more) {
      const int nbuf = ((step + 1) & 1) * DK * D::LD;
      const int nj0 = nb_ * a.bn + nc * D::BN;
      stage_kmajor<DK, D::BM>(smem + D::QT + nbuf, qrows, a.m - i0, a.d, nk_ * DK);
      stage_kmajor<DK, D::BN>(smem + D::XT + nbuf, a.x + (size_t)nj0 * a.d,
                              min(a.n, (nb_ + 1) * a.bn) - nj0, a.d, nk_ * DK);
      cp_async_commit();
    }
    const float* qt = smem + D::QT + buf;
    const float* xt = smem + D::XT + buf;
    if (L2) {
      qn_r += half_norm_kmajor<DK>(qt, tid >> 1, tid & 1);
      xn_r += half_norm_kmajor<DK>(xt, tid >> 1, tid & 1);
    }
    tile_chunk_kmajor<L2, DK, D::LD>(acc, qt, xt, tx, ty);
    if (nk_ == 0) {           // the 128-column chunk is complete
      if (L2) {
        if (!(tid & 1)) { qn[tid >> 1] = qn_r; xn[tid >> 1] = xn_r; }
        qn_r = 0.0f;
        xn_r = 0.0f;
        __syncthreads();      // norms visible
      }
      tile_finish<KIND, true>(rs, acc, qn, xn, tx, ty, j0, jend, a.p);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.0f;
      if (nc == 0) tile_store<Store, true>(a, rs, tx, ty, i0, b);   // block b is complete
    }
    if (!more) break;
    b = nb_;
    c = nc;
    k = nk_;
  }
}

// ------------------------------------------------------------------ mma
// The bf16 kinds' tensor-core sweep (instance MMA + DK; the sampler's,
// blocksum's and rowsum's plans take it for the bf16 kinds where the wide
// tile's conditions hold).
// Replaces the cross term of _tile_kernel_values(precision="bf16")
// (kde_rowsum/kernel.py:62-77): dot_general of the rounded operands with
// preferred_element_type=f32.  Products of two bf16 values are exact in
// f32, so mma.sync.m16n8k16 bf16 with f32 accumulation computes that cross
// term, summed in another order (kde_sampler/ref.py _pair_slack says why
// the tensor cores' accumulation stays within the flip-slack model).
//
// Bound on the H100: operations, and not the tensor cores' (2d of the
// pair's 2d + 6 run there).  Per pair the CUDA cores run the epilogue:
// d2 = max(qn + xn - 2 c, 0), the bf16 argument, the table entry and the
// add, ~8 instructions against the wide tile's ~31 (16 FMAs of the cross
// term among them); the table read is one random 4-byte load a pair.
//
// Design.  The wide tile's CTA (256 threads, a 128-row query tile, the
// group's columns streamed in 128-column chunks through two cp.async f32
// buffers, a chunk never past its block's end).  Warp w owns query rows
// 16 w .. 16 w + 15 for the whole sweep: their A fragments (4 registers a
// k-step) and the two row norms a lane needs are loaded once, at the first
// chunk, and stay in registers.  After each chunk lands, thread pair
// (2 r, 2 r + 1) rounds row r of it to bf16 (cvt.rn.bf16x2.f32) into a
// padded bf16 tile (row stride DK + 8: ldmatrix rows hit distinct banks)
// and sums its norm from the rounded values in half_norm's order, so the
// norms are the wide tile's.  The warp then sweeps the chunk's 8-column
// tiles: B fragments by ldmatrix, one mma a k-step (d = 8 zero-padded to
// k = 16, d = 32 two k-steps), and the epilogue on the C fragment (rows
// gid, gid + 8; columns 2 tig, 2 tig + 1).  The epilogue keeps finish()'s
// arithmetic: qn + xn - 2 c as one fma (2 c is exact, so it rounds as the
// subtraction), and the arguments rounded to bf16 two at a time (one
// cvt.rn.bf16x2.f32: the scalar cvt runs at a quarter of its rate).  A
// full chunk runs without masks; in a ragged one the column tiles past the
// block's end are skipped (a warp-uniform test) and the columns of the
// last tile past it are masked, so every bn works (bn = 70: a 70-column
// chunk, 5 column pairs, the last half masked).  A row's block sum lives
// in the 4 lanes of a quad: two xor shuffles in a fixed order when the
// block is complete.
//
// A short query tile (at most 64 valid rows: the last tile of a ragged m,
// or the whole of the bench_kde sweep's m = 64) would leave warps 4-7 on
// zero rows.  There warps w and w + 4 share rows 16 w .. 16 w + 15 and
// split every chunk's 16-column pairs, w the even ones and w + 4 the odd
// ones; when a block is complete, warp w + 4 hands its quad sums over
// through shared memory (the query landing buffer, dead after the first
// chunk) and warp w adds them after its own, a fixed order, so two calls
// stay bitwise equal.  One barrier more a block; a full tile's sweep has
// neither the barrier nor the hand-over.  The exp table is read from global memory through
// the read-only path, as the other tiles read it: a copy of its reachable
// patterns in shared memory (68,416 B, 2 CTAs an SM) measured slower on
// the H100, its bank conflicts and the range test of the patterns it does
// not hold costing more than the L1 hits it replaced (PERF.md's findings).
// Shared memory at DK = 16: 44,032 B.
constexpr int MMA = 64;                // KdeTileShape::instance: MMA + DK

template <int DK>
struct Mma {
  static constexpr int BM = 128, BN = 128;
  static constexpr int RS = Wide<DK>::RS;              // f32 landing stride (stage())
  static constexpr int HS = DK + 8;                    // bf16 row stride
  static constexpr int QS = 0;                         // [BM][RS] f32 queries as landed
  static constexpr int XS = QS + BM * RS;              // [2][BN][RS] f32 columns as landed
  static constexpr int QN = XS + 2 * BN * RS;          // [BM]
  static constexpr int XN = QN + BM;                   // [BN]
  static constexpr int QB = XN + BN;                   // [BM][HS] bf16 queries
  static constexpr int XB = QB + BM * HS / 2;          // [BN][HS] bf16 columns
  static constexpr int BYTES = (XB + BN * HS / 2) * 4;
  static_assert(XB % 4 == 0 && (BM * HS / 2) % 4 == 0, "16-byte aligned regions");
};

// Round half `half` (DK / 2 coordinates) of f32 staged row `row` to bf16
// into `out` (row stride Mma::HS), and return the row's squared norm over
// the rounded values, by two threads (pairs tid, tid ^ 1): half_norm's sum.
template <int DK>
__device__ __forceinline__ float round_half(const float* rows, __nv_bfloat16* out, int row,
                                            int half) {
  const float* p = rows + row * Wide<DK>::RS + half * (DK / 2);
  __nv_bfloat162* o =
      reinterpret_cast<__nv_bfloat162*>(out + row * Mma<DK>::HS + half * (DK / 2));
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < DK / 2; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    s = fmaf(a.x, a.x, s);
    s = fmaf(a.y, a.y, s);
    s = fmaf(b.x, b.x, s);
    s = fmaf(b.y, b.y, s);
    o[k / 2] = lo;
    o[k / 2 + 1] = hi;
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// finish() of two pairs: d2 = max(qn + xn - 2 c, 0) as finish() rounds it,
// then the two bf16 arguments by one cvt and their table entries (the
// gaussian and exponential kinds; the rational quadratic's f32 power).
template <int KIND>
__device__ __forceinline__ float2 finish2(float c0, float s0, float c1, float s1,
                                          const TableParams& p) {
  const float d0 = fmaxf(fmaf(-2.0f, c0, s0), 0.0f);
  const float d1 = fmaxf(fmaf(-2.0f, c1, s1), 0.0f);
  if constexpr (KIND == RATIONAL_QUADRATIC_BF16) {
    return make_float2(powf(1.0f + d0 * p.inv_bw2, -p.beta), powf(1.0f + d1 * p.inv_bw2, -p.beta));
  } else {
    const float y0 = KIND == GAUSSIAN_BF16 ? -d0 * p.inv_bw2 : -sqrtf(d0) * p.inv_bw;
    const float y1 = KIND == GAUSSIAN_BF16 ? -d1 * p.inv_bw2 : -sqrtf(d1) * p.inv_bw;
    const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
    return make_float2(__ldg(p.table + __bfloat16_as_ushort(y.x)),
                       __ldg(p.table + __bfloat16_as_ushort(y.y)));
  }
}

// rs[r] += the kernel values of the chunk's columns for rows gid + 8 r of
// the warp: xb the chunk's bf16 columns, xn their norms; MASK: only the
// first `valid` columns count; SPLIT: only the 16-column pairs jp of
// parity `half` (a short tile's warp halves), else all eight.
template <int KIND, int KS, int HS, bool MASK, bool SPLIT>
__device__ __forceinline__ void mma_chunk(float (&rs)[2], const uint32_t (&af)[KS][4],
                                          const float (&qv)[2], const __nv_bfloat16* xb,
                                          const float* xn, int valid, int half,
                                          const TableParams& p) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < (SPLIT ? 4 : 8); ++t) {
    const int jp = SPLIT ? 2 * t + half : t;
    if (MASK && jp * 16 >= valid) break;   // warp-uniform
    // matrix i of a load: columns jp 16 + 8 (i >> 1), k 8 (i & 1) of the
    // k-step, so (r0, r1) and (r2, r3) are the b fragments of the two
    // 8-column tiles
    float cf[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[4];
      ldsm_x4(bf, xb + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * HS + ks * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(cf[0], af[ks], bf[0], bf[1]);
      mma_bf16(cf[1], af[ks], bf[2], bf[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = jp * 16 + h * 8 + 2 * tig;
      const float2 xv = *reinterpret_cast<const float2*>(xn + col);
      const float2 v0 = finish2<KIND>(cf[h][0], qv[0] + xv.x, cf[h][1], qv[0] + xv.y, p);
      const float2 v1 = finish2<KIND>(cf[h][2], qv[1] + xv.x, cf[h][3], qv[1] + xv.y, p);
      if (MASK) {
        const bool ok0 = col < valid, ok1 = col + 1 < valid;
        rs[0] += ok0 ? v0.x : 0.0f;
        rs[0] += ok1 ? v0.y : 0.0f;
        rs[1] += ok0 ? v1.x : 0.0f;
        rs[1] += ok1 ? v1.y : 0.0f;
      } else {
        rs[0] += v0.x;
        rs[0] += v0.y;
        rs[1] += v1.x;
        rs[1] += v1.y;
      }
    }
  }
}

// The mma sweep over a full (SPLIT false) or short (SPLIT true: at most 64
// valid rows) query tile.  smem holds Mma<DK>::BYTES.
template <int KIND, int DK, class Store, bool SPLIT, class A>
__device__ __forceinline__ void mma_sweep(float* smem, const A& a) {
  using M = Mma<DK>;
  constexpr int KS = DK / 16;                       // k-steps of the cross term
  float* qs = smem + M::QS;
  float* qn = smem + M::QN;
  float* xn = smem + M::XN;
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + M::QB);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + M::XB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (SPLIT ? warp & 3 : warp) * 16;    // the warp's first query row
  const int half = SPLIT ? warp >> 2 : 0;           // its column pairs' parity
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = blockIdx.y * M::BM;
  int b = blockIdx.x * a.group;
  const int b1 = min(a.nb, b + a.group);
  int c = 0;

  stage<DK, M::BM>(qs, a.q + (size_t)i0 * a.d, a.m - i0, a.d);
  stage<DK, M::BN>(smem + M::XS, a.x + (size_t)b * a.bn * a.d, min(a.n - b * a.bn, a.bn), a.d);
  cp_async_commit();

  uint32_t af[KS][4];          // A fragments of the warp's 16 rows
  float qv[2] = {0.0f, 0.0f};  // ||q||^2 of rows wr + gid and wr + gid + 8
  float rs[2] = {0.0f, 0.0f};  // their partial sums of block b

  for (int step = 0;; ++step) {
    const int jend = min(a.n, (b + 1) * a.bn);          // end of block b
    const int j0 = b * a.bn + c * M::BN;
    int nb_ = b, nc = c + 1;
    if (j0 + M::BN >= jend) { nb_ = b + 1; nc = 0; }
    const bool more = nb_ < b1;
    const float* xs = smem + M::XS + (step & 1) * M::BN * M::RS;
    cp_async_wait_all();
    __syncthreads();          // this chunk (and q) landed; xb's last reads are done
    if (more) {
      const int nj0 = nb_ * a.bn + nc * M::BN;
      stage<DK, M::BN>(smem + M::XS + ((step + 1) & 1) * M::BN * M::RS,
                       a.x + (size_t)nj0 * a.d, min(a.n, (nb_ + 1) * a.bn) - nj0, a.d);
      cp_async_commit();
    }
    {
      const float s = round_half<DK>(xs, xb, tid >> 1, tid & 1);
      if (!(tid & 1)) xn[tid >> 1] = s;
    }
    if (step == 0) {
      const float s = round_half<DK>(qs, qb, tid >> 1, tid & 1);
      if (!(tid & 1)) qn[tid >> 1] = s;
    }
    __syncthreads();          // the bf16 tiles and the norms visible
    if (step == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(af[ks], qb + (wr + (lane & 15)) * M::HS + ks * 16 + (lane >> 4) * 8);
      qv[0] = qn[wr + gid];
      qv[1] = qn[wr + gid + 8];
    }
    const int valid = min(M::BN, jend - j0);        // columns of block b in the chunk
    if (valid == M::BN)
      mma_chunk<KIND, KS, M::HS, false, SPLIT>(rs, af, qv, xb, xn, valid, half, a.p);
    else
      mma_chunk<KIND, KS, M::HS, true, SPLIT>(rs, af, qv, xb, xn, valid, half, a.p);
    if (nc == 0) {            // block b is complete: the quad's sums, fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      }
      if (SPLIT) {            // the odd pairs' sums (warp w + 4) after the even ones'
        float* odd = qs;      // 64 floats; q landed here, dead since step 0
        if (half && tig == 0) {
          odd[wr + gid] = rs[0];
          odd[wr + gid + 8] = rs[1];
        }
        __syncthreads();      // block completion is CTA-uniform
        if (!half) {
          rs[0] += odd[wr + gid];
          rs[1] += odd[wr + gid + 8];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gi = i0 + wr + gid + 8 * r;
        if (!half && tig == 0 && gi < a.m) Store::put(a, rs[r], gi, b);
        rs[r] = 0.0f;
      }
    }
    if (!more) break;
    b = nb_;
    c = nc;
  }
}

// The mma sweep: blocks [blockIdx.x group, + group) of query tile
// blockIdx.y, as wide_block_sums; a tile of at most 64 valid rows takes the
// split sweep (CTA-uniform).  smem holds Mma<DK>::BYTES.
template <int KIND, int DK, class Store, class A>
__device__ __forceinline__ void mma_block_sums(float* smem, const A& a) {
  static_assert(is_bf16(KIND) && DK % 16 == 0, "the mma tile takes the bf16 kinds");
  if (a.m - (int)blockIdx.y * Mma<DK>::BM <= Mma<DK>::BM / 2)
    mma_sweep<KIND, DK, Store, true>(smem, a);
  else
    mma_sweep<KIND, DK, Store, false>(smem, a);
}

}  // namespace kde
