// Exact KDE row sums and per-block sums (Definition 1.1 oracle and the
// level-1 read of the depth-2 sampler).
//
// kde_rowsum_launch   replaces src/repro/kernels/kde_rowsum/kernel.py:rowsum_pallas
//                     out[i] = sum_j k(q_i, x_j)
// kde_blocksum_launch replaces src/repro/kernels/kde_rowsum/kernel.py:blocksum_pallas
//                     out[i, b] = sum_{j in block b} k(q_i, x_j)
//
// Bound on the H100: both are bound by FP32 issue, not bytes -- each pair
// costs d FMAs (L2 kinds) or d subtracts and d adds with |.| (laplacian) plus
// one transcendental, against d * 8 bytes of operands that the tiles reuse
// 128 times.  The LRA call (m = 1024, n = 16384, d = 784, laplacian) issues
// at least 1024 * 16384 * 784 * 2 = 26.3 G lane instructions: ~0.79 ms at
// 132 SMs x 128 lanes x 1.98 GHz.
//
// Design: the TPU rowsum carries a row accumulator across its sequential j
// grid axis.  Hopper runs blocks in no order, so the rowsum is a blocksum
// over `splits` blocks of `cols` columns into an (m, splits) partial buffer,
// and a second small kernel sums each row in split order: deterministic, no
// atomics.  The blocksum has no carry.  Both run one of three tiles, chosen
// by the host-side plan (kernels/kde_rowsum/kernel.py ``blocksum_plan`` /
// ``rowsum_plan``; the shape struct's `instance`):
// - wide (d % 4 == 0, d <= 32, q and x 16-byte aligned) and deep (the same
//   for d > 32): kde_wide.cuh's 128-row tiles with a raw store, a CTA summing
//   `group` consecutive blocks (the plan sizes the group, or the rowsum's
//   split width, so the grid is one wave of 2 CTAs an SM);
// - generic (any other d or alignment): kde_tile.cuh's 64-row tile, one CTA
//   per (block, query tile).
// Any semantic block size bn works (not a power of two, e.g. 70); the
// ragged last block is masked in the kernels.
//
// precision="bf16" (the Pallas kernels' bf16 specialisation with its
// exp-table operand) is the same tiles at the bf16 kind ids of
// kde_tile.cuh: operands rounded where they are staged, the table passed in
// `table`.  Only the three L2 kinds have bf16 instances.
#include "kde_wide.cuh"

namespace {

constexpr int THREADS = kde::WIDE_THREADS;

struct SumArgs {
  const float* q;
  const float* x;
  float* out;           // (m, nb)
  int m, n, d, bn, nb, group;
  kde::TableParams p;
};

// The 128-row tiles' store: the raw block sum.
struct RawStore {
  __device__ __forceinline__ static void put(const SumArgs& a, float s, int gi, int b) {
    a.out[(size_t)gi * a.nb + b] = s;
  }
};

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
blocksum_kernel(SumArgs a) {
  __shared__ kde::TileSmem sm;
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * kde::BM;
  const int jlo = b * a.bn;
  const int jhi = min(a.n, jlo + a.bn);
  float rs[kde::TM] = {0.0f, 0.0f, 0.0f, 0.0f};
  kde::tile_row_sums<KIND>(a.q, a.x, a.m, a.d, i0, jlo, jhi, a.p, rs, sm);
  kde::row_reduce(rs);
  const int tx = threadIdx.x % kde::TX, ty = threadIdx.x / kde::TX;
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < kde::TM; ++r) {
      const int gi = i0 + ty + kde::TY * r;
      if (gi < a.m) a.out[(size_t)gi * a.nb + b] = rs[r];
    }
  }
}

template <int KIND, int DK>
__global__ void __launch_bounds__(THREADS, 2)
blocksum_wide_kernel(SumArgs a) {
  extern __shared__ __align__(16) float smem[];
  kde::wide_block_sums<KIND, DK, RawStore>(smem, a);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 2)
blocksum_deep_kernel(SumArgs a) {
  extern __shared__ __align__(16) float smem[];
  kde::deep_block_sums<KIND, kde::DEEP_DK, RawStore>(smem, a);
}

// Launch the wide tile padded to INST coordinates, or the deep tile (INST ==
// kde::DEEP), raising its dynamic shared memory once (above 48 KB).
template <int KIND, int INST>
int launch_tiled(const SumArgs& a, cudaStream_t st) {
  constexpr bool deep = INST == kde::DEEP;
  constexpr int smem =
      deep ? kde::Deep<kde::DEEP_DK>::BYTES : kde::Wide<deep ? 16 : INST>::BYTES;
  void (*kernel)(SumArgs);
  if constexpr (deep) kernel = blocksum_deep_kernel<KIND>;
  else kernel = blocksum_wide_kernel<KIND, INST>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + 127) / 128);
  kernel<<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int blocksum_kind(const SumArgs& a, int instance, cudaStream_t st) {
  if (instance == 16) return launch_tiled<KIND, 16>(a, st);
  if (instance == 32) return launch_tiled<KIND, 32>(a, st);
  if (instance == kde::DEEP) return launch_tiled<KIND, kde::DEEP>(a, st);
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.nb, (a.m + kde::BM - 1) / kde::BM);
  blocksum_kernel<KIND><<<grid, kde::THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int blocksum(const float* q, const float* x, float* out, const float* table,
             const KdeTileShape& s, cudaStream_t st) {
  const SumArgs a{q, x, out, s.m, s.n, s.d, s.bn, s.nb, s.group,
                  kde::TableParams{s.inv_bw, s.inv_bw2, s.beta, table}};
  switch (s.kind) {
    case kde::GAUSSIAN: return blocksum_kind<kde::GAUSSIAN>(a, s.instance, st);
    case kde::EXPONENTIAL: return blocksum_kind<kde::EXPONENTIAL>(a, s.instance, st);
    case kde::RATIONAL_QUADRATIC:
      return blocksum_kind<kde::RATIONAL_QUADRATIC>(a, s.instance, st);
    case kde::LAPLACIAN: return blocksum_kind<kde::LAPLACIAN>(a, s.instance, st);
    case kde::GAUSSIAN_BF16: return blocksum_kind<kde::GAUSSIAN_BF16>(a, s.instance, st);
    case kde::EXPONENTIAL_BF16:
      return blocksum_kind<kde::EXPONENTIAL_BF16>(a, s.instance, st);
    case kde::RATIONAL_QUADRATIC_BF16:
      return blocksum_kind<kde::RATIONAL_QUADRATIC_BF16>(a, s.instance, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// s: the plan's split as a blocksum (bn = columns a split, nb = splits);
// partial: an (m, nb) float32 scratch buffer; table: the (65536,) bf16 exp
// table for the bf16 gaussian and exponential kinds, else null.
int kde_rowsum_launch(const float* q, const float* x, float* partial, float* out,
                      const float* table, void* stream, const KdeTileShape* s) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = blocksum(q, x, partial, table, *s, st);
  if (err != 0) return err;
  rowsum_reduce_kernel<<<(s->m + 255) / 256, 256, 0, st>>>(partial, out, s->m, s->nb);
  return static_cast<int>(cudaGetLastError());
}

int kde_blocksum_launch(const float* q, const float* x, float* out, const float* table,
                        void* stream, const KdeTileShape* s) {
  return blocksum(q, x, out, table, *s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
