// Exact KDE row sums and per-block sums (Definition 1.1 oracle and the
// level-1 read of the depth-2 sampler).
//
// kde_rowsum_launch   replaces src/repro/kernels/kde_rowsum/kernel.py:rowsum_pallas
//                     out[i] = sum_j k(q_i, x_j)
// kde_blocksum_launch replaces src/repro/kernels/kde_rowsum/kernel.py:blocksum_pallas
//                     out[i, b] = sum_{j in block b} k(q_i, x_j)
//
// Bound on the H100: both are bound by FP32 issue, not bytes -- each pair
// costs d FMAs (L2 kinds) or d sub+|.|-add (laplacian) plus one
// transcendental, against d * 8 bytes of operands that the tile reuses BM or
// BN times (see kde_tile.cuh).  The LRA call (m = 1024, n = 16384,
// d = 784, laplacian) is ~2.6e10 FP32 operations for 54 MB of operands.
//
// Design: the TPU rowsum carries a row accumulator across its sequential j
// grid axis.  Hopper runs blocks in no order, so the rowsum splits n over
// `splits` CTAs per query tile -- the blocksum kernel with `splits` blocks of
// `cols` columns -- into an (m, splits) partial buffer, and a second small
// kernel sums each row in split order: deterministic, no atomics.  `splits` is sized so the grid holds at least TARGET_CTAS CTAs
// (4 per SM on 132 SMs) -- with m = 1024 there are only 16 query tiles.  The
// blocksum has no carry: one CTA per (level-1 block, query tile) sweeps its
// block in BN-column chunks, so any semantic block size bn (not a power of
// two, e.g. 70) works and the ragged last block is masked in the kernel.
#include "kde_tile.cuh"

namespace {

constexpr int TARGET_CTAS = 4 * 132;

__global__ void rowsum_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int m, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)i * splits + s];
  out[i] = acc;
}

template <int KIND>
__global__ void __launch_bounds__(kde::THREADS)
blocksum_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int m, int n, int d, int bn, int nb,
                kde::Params p) {
  __shared__ kde::TileSmem sm;
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * kde::BM;
  const int jlo = b * bn;
  const int jhi = min(n, jlo + bn);
  float rs[kde::TM] = {0.0f, 0.0f, 0.0f, 0.0f};
  kde::tile_row_sums<KIND>(q, x, m, d, i0, jlo, jhi, p, rs, sm);
  kde::row_reduce(rs);
  const int tx = threadIdx.x % kde::TX, ty = threadIdx.x / kde::TX;
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < kde::TM; ++r) {
      const int gi = i0 + ty + kde::TY * r;
      if (gi < m) out[(size_t)gi * nb + b] = rs[r];
    }
  }
}

void split_plan(int m, int n, int* splits, int* cols_per_split) {
  const int mt = (m + kde::BM - 1) / kde::BM;
  const int chunks = (n + kde::BN - 1) / kde::BN;
  int want = (TARGET_CTAS + mt - 1) / mt;
  if (want > chunks) want = chunks;
  if (want < 1) want = 1;
  const int per = (chunks + want - 1) / want;       // chunks per split
  *cols_per_split = per * kde::BN;
  *splits = (n + *cols_per_split - 1) / *cols_per_split;
}

int blocksum(const float* q, const float* x, float* out, int m, int n, int d,
             int bn, int nb, int kind, float inv_bw, float inv_bw2, float beta,
             cudaStream_t st) {
  const kde::Params p{inv_bw, inv_bw2, beta};
  const dim3 grid(nb, (m + kde::BM - 1) / kde::BM);
  switch (kind) {
    case kde::GAUSSIAN:
      blocksum_kernel<kde::GAUSSIAN><<<grid, kde::THREADS, 0, st>>>(q, x, out, m, n, d, bn, nb, p);
      break;
    case kde::EXPONENTIAL:
      blocksum_kernel<kde::EXPONENTIAL><<<grid, kde::THREADS, 0, st>>>(q, x, out, m, n, d, bn, nb, p);
      break;
    case kde::RATIONAL_QUADRATIC:
      blocksum_kernel<kde::RATIONAL_QUADRATIC><<<grid, kde::THREADS, 0, st>>>(q, x, out, m, n, d, bn, nb, p);
      break;
    case kde::LAPLACIAN:
      blocksum_kernel<kde::LAPLACIAN><<<grid, kde::THREADS, 0, st>>>(q, x, out, m, n, d, bn, nb, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of partial columns the rowsum needs for (m, n): the caller
// allocates an (m, splits) float32 scratch buffer of this width.
int kde_rowsum_splits(int m, int n) {
  int splits, cols;
  split_plan(m, n, &splits, &cols);
  return splits;
}

int kde_rowsum_launch(const float* q, const float* x, float* partial, float* out,
                      int m, int n, int d, int kind, float inv_bw, float inv_bw2,
                      float beta, void* stream) {
  int splits, cols;
  split_plan(m, n, &splits, &cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the partial sums are block sums over blocks of `cols` columns
  const int err = blocksum(q, x, partial, m, n, d, cols, splits, kind, inv_bw,
                           inv_bw2, beta, st);
  if (err != 0) return err;
  rowsum_reduce_kernel<<<(m + 255) / 256, 256, 0, st>>>(partial, out, m, splits);
  return static_cast<int>(cudaGetLastError());
}

int kde_blocksum_launch(const float* q, const float* x, float* out, int m, int n,
                        int d, int bn, int nb, int kind, float inv_bw, float inv_bw2,
                        float beta, void* stream) {
  return blocksum(q, x, out, m, n, d, bn, nb, kind, inv_bw, inv_bw2, beta,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
