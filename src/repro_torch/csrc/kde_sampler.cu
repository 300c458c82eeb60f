// Level-1 read of the depth-2 neighbor sampler: masked per-block sums and the
// Gumbel-max block draw.
//
// kde_masked_blocksum_launch replaces
//     src/repro/kernels/kde_sampler/kernel.py:masked_blocksum_pallas
//   bs[i, b] = max(sum_{j in block b} k(q_i, x_j) - [own_i == b], 1e-12)
// kde_sample_block_launch replaces
//     src/repro/kernels/kde_sampler/kernel.py:sample_block_pallas
//   the same bs, plus blk_i = argmax_b log(bs[i, b]) + g[i, b] (lowest index on
//   ties), tot_i = sum_b bs[i, b] and p_blk_i = bs[i, blk_i] / tot_i.
//
// Bound on the H100: the masked sums are the blocksum of kde_rowsum.cu with a
// per-row epilogue, so they are bound by FP32 FMA issue and expf (d = 16 on
// the sparsifier path: 1024 x 65536 pairs per edge batch).  The draw reads
// (m, B) floats twice and is bound by bytes, ~1/100 of the sums' time.
//
// Design: the TPU kernel keeps a running Gumbel-max in VMEM scratch across its
// sequential block axis.  Hopper runs blocks in no order, so the port writes
// the masked (m, B) sums first -- one CTA per (level-1 block, query tile),
// self-kernel subtraction then floor in that order, exactly as the TPU kernel
// -- and then runs one warp per query row over the row's B sums.  Each lane
// keeps its first strict maximum, and the warp reduction prefers the lower
// index on equal scores, so the drawn block is the first maximum in block
// order, as the reference's strict-">" update.  Queries are not padded: rows
// >= m are masked; a negative own index marks a row with no own block.
#include "kde_tile.cuh"

namespace {

constexpr float FLOOR = 1e-12f;   // == ref.BLOCK_SUM_FLOOR

template <int KIND>
__global__ void __launch_bounds__(kde::THREADS)
masked_blocksum_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       const int* __restrict__ own, float* __restrict__ out,
                       int m, int n, int d, int bn, int nb, kde::Params p) {
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
      if (gi < m) {
        float s = rs[r];
        if (own[gi] == b) s -= 1.0f;          // k(x, x) = 1 self mask
        out[(size_t)gi * nb + b] = fmaxf(s, FLOOR);
      }
    }
  }
}

// One warp per query row: Gumbel-max over log(bs) + g, the row total and the
// realized block probability.
__global__ void block_argmax_kernel(const float* __restrict__ bs,
                                    const float* __restrict__ g,
                                    int* __restrict__ blk, float* __restrict__ pb,
                                    float* __restrict__ tot, int m, int nb) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;                          // whole warps exit together
  const float* s_row = bs + (size_t)row * nb;
  const float* g_row = g + (size_t)row * nb;
  float best = -INFINITY;
  int arg = 0x7fffffff;
  float sum = 0.0f;
  for (int b = lane; b < nb; b += 32) {
    const float s = s_row[b];
    const float score = logf(s) + g_row[b];
    sum += s;
    if (score > best) { best = score; arg = b; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
  }
  if (lane == 0) {
    if (arg >= nb) arg = 0;                      // no finite score: block 0
    blk[row] = arg;
    tot[row] = sum;
    pb[row] = s_row[arg] / sum;
  }
}

template <int KIND>
void launch_masked(dim3 grid, cudaStream_t st, const float* q, const float* x,
                   const int* own, float* out, int m, int n, int d, int bn, int nb,
                   const kde::Params& p) {
  masked_blocksum_kernel<KIND><<<grid, kde::THREADS, 0, st>>>(q, x, own, out, m, n, d,
                                                              bn, nb, p);
}

int masked(const float* q, const float* x, const int* own, float* out, int m, int n,
           int d, int bn, int nb, int kind, float inv_bw, float inv_bw2, float beta,
           cudaStream_t st) {
  const kde::Params p{inv_bw, inv_bw2, beta};
  const dim3 grid(nb, (m + kde::BM - 1) / kde::BM);
  switch (kind) {
    case kde::GAUSSIAN:
      launch_masked<kde::GAUSSIAN>(grid, st, q, x, own, out, m, n, d, bn, nb, p);
      break;
    case kde::EXPONENTIAL:
      launch_masked<kde::EXPONENTIAL>(grid, st, q, x, own, out, m, n, d, bn, nb, p);
      break;
    case kde::RATIONAL_QUADRATIC:
      launch_masked<kde::RATIONAL_QUADRATIC>(grid, st, q, x, own, out, m, n, d, bn, nb, p);
      break;
    case kde::LAPLACIAN:
      launch_masked<kde::LAPLACIAN>(grid, st, q, x, own, out, m, n, d, bn, nb, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int kde_masked_blocksum_launch(const float* q, const float* x, const int* own,
                               float* out, int m, int n, int d, int bn, int nb,
                               int kind, float inv_bw, float inv_bw2, float beta,
                               void* stream) {
  return masked(q, x, own, out, m, n, d, bn, nb, kind, inv_bw, inv_bw2, beta,
                static_cast<cudaStream_t>(stream));
}

int kde_sample_block_launch(const float* q, const float* x, const int* own,
                            const float* gumbel, float* bs, int* blk, float* pb,
                            float* tot, int m, int n, int d, int bn, int nb, int kind,
                            float inv_bw, float inv_bw2, float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = masked(q, x, own, bs, m, n, d, bn, nb, kind, inv_bw, inv_bw2, beta, st);
  if (err != 0) return err;
  constexpr int ROWS_PER_CTA = 8;                // 8 warps of 32 lanes
  block_argmax_kernel<<<(m + ROWS_PER_CTA - 1) / ROWS_PER_CTA, ROWS_PER_CTA * 32, 0, st>>>(
      bs, gumbel, blk, pb, tot, m, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
