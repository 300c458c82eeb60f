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
// 132 SMs x 128 lanes x 1.98 GHz.  The bf16 kinds at d <= 32 move the
// cross term to the tensor cores, and the per-pair epilogue (~8
// instructions) sets the pace.
//
// Design: the TPU rowsum carries a row accumulator across its sequential j
// grid axis.  Hopper runs blocks in no order, so the rowsum is a blocksum
// over `splits` blocks of `cols` columns into an (m, splits) partial buffer,
// and a second small kernel sums each row, a warp a row in a fixed order:
// deterministic, no atomics.  The blocksum has no carry.  Both run one of
// four tiles, chosen by the host-side plan (kernels/kde_rowsum/kernel.py
// ``blocksum_plan`` / ``rowsum_plan``; the shape struct's `instance`):
// - wide (the f32 kinds; d % 4 == 0, d <= 32, q and x 16-byte aligned) and
//   deep (any kind; the same for d > 32): kde_wide.cuh's 128-row tiles with
//   a raw store, a CTA summing `group` consecutive blocks (the plan sizes
//   the group, or the rowsum's split width, so the grid is one wave of 2
//   CTAs an SM);
// - mma (the bf16 kinds under wide's conditions, instance MMA + 16 or MMA
//   + 32): kde_wide.cuh's tensor-core tile, mma.sync bf16 with f32
//   accumulation, with the same raw store and grid.  A query tile of at most
//   64 valid rows (the bench_kde sweep's m = 64) splits each chunk's columns
//   between two warps a row slice, so no warp runs on padding;
// - generic (any other d or alignment): kde_tile.cuh's 64-row tile, one CTA
//   per (block, query tile).
// Any semantic block size bn works (not a power of two, e.g. 70); the
// ragged last block is masked in the kernels.
//
// precision="bf16" (the Pallas kernels' bf16 specialisation with its
// exp-table operand) runs the mma, deep and generic tiles at the bf16 kind
// ids of kde_tile.cuh: operands rounded to bf16 where they are staged (the
// mma tile: into its bf16 tiles), the table passed in `table`.  Only the
// three L2 kinds have bf16 instances.  The wide tile is built for the f32
// kinds only: at a bf16 kind, instance 16 / 32 returns
// cudaErrorInvalidValue.
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

// out[i] = the sum of row i's split sums, a warp a row: lane l sums splits
// l, l + 32, ... in order, then a fixed xor tree (deterministic).  A few
// rows with many splits (the bench_kde sweep's 64 rows of 256) still
// spread over 32 lanes a row.
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
rowsum_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int m,
                     int splits) {
  const int i = blockIdx.x * (REDUCE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= m) return;                       // warp-uniform
  const float* row = partial + (size_t)i * splits;
  float acc = 0.0f;
  for (int s = lane; s < splits; s += 32) acc += row[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
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

template <int KIND, int DK>
__global__ void __launch_bounds__(THREADS, 2)
blocksum_mma_kernel(SumArgs a) {
  extern __shared__ __align__(16) float smem[];
  kde::mma_block_sums<KIND, DK, RawStore>(smem, a);
}

// A launch of a 128-row tile kernel with SMEM bytes of dynamic shared
// memory, raised once (above 48 KB) at its first launch.
template <void (*KERNEL)(SumArgs), int SMEM>
int launch_tiled(const SumArgs& a, cudaStream_t st) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + 127) / 128);
  KERNEL<<<grid, THREADS, SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int blocksum_kind(const SumArgs& a, int instance, cudaStream_t st) {
  using kde::Mma;
  using kde::Wide;
  if constexpr (kde::is_bf16(KIND)) {
    if (instance == kde::MMA + 16)
      return launch_tiled<blocksum_mma_kernel<KIND, 16>, Mma<16>::BYTES>(a, st);
    if (instance == kde::MMA + 32)
      return launch_tiled<blocksum_mma_kernel<KIND, 32>, Mma<32>::BYTES>(a, st);
  } else {
    if (instance == 16)
      return launch_tiled<blocksum_wide_kernel<KIND, 16>, Wide<16>::BYTES>(a, st);
    if (instance == 32)
      return launch_tiled<blocksum_wide_kernel<KIND, 32>, Wide<32>::BYTES>(a, st);
  }
  if (instance == kde::DEEP)
    return launch_tiled<blocksum_deep_kernel<KIND>, kde::Deep<kde::DEEP_DK>::BYTES>(a, st);
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
  constexpr int rows = REDUCE_THREADS / 32;
  rowsum_reduce_kernel<<<(s->m + rows - 1) / rows, REDUCE_THREADS, 0, st>>>(partial, out, s->m,
                                                                            s->nb);
  return static_cast<int>(cudaGetLastError());
}

int kde_blocksum_launch(const float* q, const float* x, float* out, const float* table,
                        void* stream, const KdeTileShape* s) {
  return blocksum(q, x, out, table, *s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
