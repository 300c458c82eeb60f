// Level-1 read of the depth-2 neighbor sampler: masked per-block sums and the
// Gumbel-max block draw, in one launch.
//
// kde_masked_blocksum_launch replaces
//     src/repro/kernels/kde_sampler/kernel.py:masked_blocksum_pallas
//   bs[i, b] = max(sum_{j in block b} k(q_i, x_j) - [own_i == b], 1e-12)
// kde_sample_block_launch replaces
//     src/repro/kernels/kde_sampler/kernel.py:sample_block_pallas
//   the same bs, plus blk_i = argmax_b log(bs[i, b]) + g[i, b] (lowest index on
//   ties), tot_i = sum_b bs[i, b] and p_blk_i = bs[i, blk_i] / tot_i.
//
// Bound on the H100: operations.  At the sparsifier's shape (m = 1024 frontier
// rows, n = 65536, d = 16, bn = 256) a call is 67.1 M (query, row) pairs of
// 2d + 6 FP32 operations (0.0381 ms at 67 TFLOP/s); bytes are ~4.5 MB.  What
// the card issues per pair is d FMAs of the cross term plus ~10 for the
// distance, the IEEE expf and the sum, so the FMA pipe's issue rate, not the
// operation count, sets the pace.
//
// Design.  The TPU kernel carries a running Gumbel-max in VMEM scratch across
// its sequential block axis.  Hopper runs CTAs in no order, so each CTA owns
// a query tile and a group of consecutive level-1 blocks (the plan sizes the
// group so the whole grid is one wave of resident CTAs) and writes those
// blocks' masked sums; the draw then needs every block of the tile.  A
// per-query-tile arrival counter gives it in the same launch: each CTA
// stores its sums, fences and bumps the counter, and the CTA that arrives
// last reads the tile's finished (BM, nb) sums back from L2 in block order
// (four rows a warp, 64 loads in flight a lane), draws (first strict maximum in
// block order, as the reference's strict ">" update; the warp reduction
// prefers the lower index on equal scores), writes blk as int64, p_blk and
// tot, and resets the counter to 0.  The draw always reads finished sums in
// block order, so the result does not depend on the CTAs' order.  The
// counters are one int per query tile in a buffer the wrapper allocates once
// per (device, stream) and reuses: launches on one stream never overlap, and
// launches on two streams use two buffers.
//
// Three instances, chosen by the host-side plan (kernels/kde_sampler/kernel.py
// ``sample_block_plan``):
// - wide (the f32 kinds where d % 4 == 0, d <= 32, q and x 16-byte aligned;
//   kde_wide.cuh's wide_block_sums with the masked store): 256 threads own
//   a 128-row query tile.  The tile is staged once per CTA with 16-byte
//   cp.async copies; the group's columns stream through two 128-column
//   buffers (the next chunk's copies overlap the current chunk's math).
//   Rows stay row-major in shared memory, padded by 4 floats, so a thread's
//   8 x 8 register tile is fed by 16-byte loads along the coordinate axis:
//   16 loads per 256 FMAs, 0.0625 loads per FMA (the generic tile issues
//   0.5).  Norms are computed by two threads per row while the next chunk is
//   in flight; two barriers per 128-column chunk.  At d = 16 a chunk is
//   ~31 instructions a pair (16 cross-term FMAs, the distance, the IEEE
//   expf, the sum); 128 registers leave 2 CTAs an SM.
// - generic (any d, any alignment; the ragged checks' d = 19 and d = 784):
//   the 64-row tile of kde_tile.cuh, unchanged, with the same epilogue.
// - mma (precision="bf16" where wide's conditions hold; kde_wide.cuh's
//   mma_block_sums with the masked store, instance MMA + 16 or MMA + 32):
//   the wide tile's CTA and staging with the cross term on the tensor
//   cores (mma.sync m16n8k16, bf16 operands, f32 accumulation), the query
//   fragments in registers for the whole sweep and a short per-pair
//   epilogue (~8 instructions a pair against the wide tile's ~31).  The
//   draw below is the same for every instance.
// All three keep the reference's arithmetic: d2 = max(qn + xn - 2 cross, 0)
// through kde::finish (mma: its twin finish2), IEEE expf/sqrtf/powf, no TF32,
// no fast-math.
// precision="bf16" runs the mma and generic tiles at the bf16 kind ids of
// kde_tile.cuh (the Pallas kernels' bf16 specialisation): operands rounded
// where they are staged, exp read from `table` (the L2 kinds only; the draw
// is f32).  The wide tile is built for the f32 kinds only: at a bf16 kind
// instance 16 / 32 returns cudaErrorInvalidValue.  Queries
// are not padded: rows >= m are masked; a negative own index marks a row with
// no own block; own is int32 or int64 (a flag in the shape struct).
#include <stdint.h>

#include "kde_wide.cuh"

namespace {

constexpr float FLOOR = 1e-12f;   // == ref.BLOCK_SUM_FLOOR
constexpr int THREADS = 256;

}  // namespace

namespace {

struct Args {
  const float* q;
  const float* x;
  const void* own;
  const float* g;       // (m, nb) Gumbel noise, sample_block only
  float* bs;            // (m, nb)
  long long* blk;       // (m,), sample_block only
  float* pb;
  float* tot;
  int* counter;         // one per query tile, 0 between launches
  int m, n, d, bn, nb, own64, group;
  kde::TableParams p;
};

__device__ __forceinline__ void store_sum(const Args& a, float s, int gi, int b) {
  const long long own = a.own64 ? static_cast<const long long*>(a.own)[gi]
                                : static_cast<const int*>(a.own)[gi];
  if (own == b) s -= 1.0f;                      // k(x, x) = 1 self mask
  a.bs[(size_t)gi * a.nb + b] = fmaxf(s, FLOOR);
}

// The 128-row tiles' store (kde_wide.cuh): the self mask and the floor.
struct MaskedStore {
  __device__ __forceinline__ static void put(const Args& a, float s, int gi, int b) {
    store_sum(a, s, gi, b);
  }
};

// Every thread of the CTA calls this after the CTA stored its sums of its
// blocks for rows [i0, i0 + BM).  The tile's last CTA to arrive draws the
// tile's rows; every other CTA returns at once.  A warp draws RG rows at a
// time, each lane loading KU of a row's blocks (b = lane + 32 u, coalesced)
// for all RG rows before it uses any, so 2 RG KU loads are in flight a lane
// and the 256 KB read-back of a 128-row tile at nb = 256 takes four round
// trips a warp.  Each lane keeps its first strict maximum in block order;
// the warp reduction prefers the lower index on equal scores.
template <int BM>
__device__ void draw_if_last(const Args& a, int i0) {
  constexpr int RPW = BM / (THREADS / 32);     // rows a warp draws
  constexpr int RG = 4, KU = 8;
  static_assert(RPW % RG == 0, "rows a warp draws come in groups of RG");
  __shared__ int last;
  __threadfence();                 // this CTA's sums before its arrival
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counter + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = i0 + warp * RPW; r0 < i0 + (warp + 1) * RPW; r0 += RG) {
    float best[RG], sum[RG];
    int arg[RG];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) { best[rr] = -INFINITY; sum[rr] = 0.0f; arg[rr] = 0x7fffffff; }
    for (int k0 = 0; k0 < a.nb; k0 += 32 * KU) {
      float sv[RG][KU], gv[RG][KU];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int b = k0 + lane + 32 * u;
          const bool ok = r0 + rr < a.m && b < a.nb;
          const size_t at = (size_t)(r0 + rr) * a.nb + b;
          sv[rr][u] = ok ? __ldcg(a.bs + at) : 1.0f;   // written by other CTAs: L2
          gv[rr][u] = ok ? __ldg(a.g + at) : 0.0f;
        }
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int b = k0 + lane + 32 * u;
          if (b < a.nb) {
            const float score = logf(sv[rr][u]) + gv[rr][u];
            sum[rr] += sv[rr][u];
            if (score > best[rr]) { best[rr] = score; arg[rr] = b; }
          }
        }
    }
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[rr], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[rr], off);
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], off);
        if (ob > best[rr] || (ob == best[rr] && oa < arg[rr])) { best[rr] = ob; arg[rr] = oa; }
      }
      const int row = r0 + rr;
      if (lane == 0 && row < a.m) {
        const int blk = arg[rr] < a.nb ? arg[rr] : 0;   // no finite score: block 0
        a.blk[row] = blk;
        a.tot[row] = sum[rr];
        a.pb[row] = __ldcg(a.bs + (size_t)row * a.nb + blk) / sum[rr];
      }
    }
  }
  if (threadIdx.x == 0) a.counter[blockIdx.y] = 0;   // ready for the next launch
}

// ---------------------------------------------------------------- generic
template <int KIND, bool DRAW>
__global__ void __launch_bounds__(kde::THREADS)
sampler_generic_kernel(Args a) {
  static_assert(kde::THREADS == THREADS, "draw_if_last assumes 256 threads");
  __shared__ kde::TileSmem sm;
  const int i0 = blockIdx.y * kde::BM;
  const int b1 = min(a.nb, (blockIdx.x + 1) * a.group);
  const int tx = threadIdx.x % kde::TX, ty = threadIdx.x / kde::TX;
  for (int b = blockIdx.x * a.group; b < b1; ++b) {
    const int jlo = b * a.bn;
    const int jhi = min(a.n, jlo + a.bn);
    float rs[kde::TM] = {0.0f, 0.0f, 0.0f, 0.0f};
    kde::tile_row_sums<KIND>(a.q, a.x, a.m, a.d, i0, jlo, jhi, a.p, rs, sm);
    kde::row_reduce(rs);
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < kde::TM; ++r) {
        const int gi = i0 + ty + kde::TY * r;
        if (gi < a.m) store_sum(a, rs[r], gi, b);
      }
    }
  }
  if (DRAW) draw_if_last<kde::BM>(a, i0);
}

// ------------------------------------------------------------------- wide
template <int KIND, int DK, bool DRAW>
__global__ void __launch_bounds__(THREADS, 2)
sampler_wide_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  kde::wide_block_sums<KIND, DK, MaskedStore>(smem, a);
  if (DRAW) draw_if_last<kde::Wide<DK>::BM>(a, blockIdx.y * kde::Wide<DK>::BM);
}

// ------------------------------------------------------------------- mma
template <int KIND, int DK, bool DRAW>
__global__ void __launch_bounds__(THREADS, 2)
sampler_mma_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  kde::mma_block_sums<KIND, DK, MaskedStore>(smem, a);
  if (DRAW) draw_if_last<kde::Mma<DK>::BM>(a, blockIdx.y * kde::Mma<DK>::BM);
}

// A launch of a 128-row tile kernel (wide or mma) with SMEM bytes of
// dynamic shared memory: above 48 KB (DK = 32) it needs the attribute,
// set at the kernel's first launch.
template <void (*KERNEL)(Args), int SMEM>
int launch_tile(const Args& a, cudaStream_t st) {
  constexpr int BM = kde::Wide<16>::BM;
  static_assert(kde::Mma<16>::BM == BM, "both tiles take 128 query rows");
  static bool raised = false;
  if (!raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + BM - 1) / BM);
  KERNEL<<<grid, THREADS, SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, bool DRAW>
int launch_kind(const Args& a, int instance, cudaStream_t st) {
  using kde::Mma;
  using kde::Wide;
  if constexpr (kde::is_bf16(KIND)) {
    if (instance == kde::MMA + 16)
      return launch_tile<sampler_mma_kernel<KIND, 16, DRAW>, Mma<16>::BYTES>(a, st);
    if (instance == kde::MMA + 32)
      return launch_tile<sampler_mma_kernel<KIND, 32, DRAW>, Mma<32>::BYTES>(a, st);
  } else {
    if (instance == 16)
      return launch_tile<sampler_wide_kernel<KIND, 16, DRAW>, Wide<16>::BYTES>(a, st);
    if (instance == 32)
      return launch_tile<sampler_wide_kernel<KIND, 32, DRAW>, Wide<32>::BYTES>(a, st);
  }
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + kde::BM - 1) / kde::BM);
  sampler_generic_kernel<KIND, DRAW><<<grid, kde::THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool DRAW>
int launch(Args a, const KdeTileShape& s, cudaStream_t st) {
  a.m = s.m; a.n = s.n; a.d = s.d; a.bn = s.bn; a.nb = s.nb; a.own64 = s.own64;
  a.group = s.group;
  a.p.inv_bw = s.inv_bw; a.p.inv_bw2 = s.inv_bw2; a.p.beta = s.beta;
  switch (s.kind) {
    case kde::GAUSSIAN: return launch_kind<kde::GAUSSIAN, DRAW>(a, s.instance, st);
    case kde::EXPONENTIAL: return launch_kind<kde::EXPONENTIAL, DRAW>(a, s.instance, st);
    case kde::RATIONAL_QUADRATIC:
      return launch_kind<kde::RATIONAL_QUADRATIC, DRAW>(a, s.instance, st);
    case kde::LAPLACIAN: return launch_kind<kde::LAPLACIAN, DRAW>(a, s.instance, st);
    case kde::GAUSSIAN_BF16:
      return launch_kind<kde::GAUSSIAN_BF16, DRAW>(a, s.instance, st);
    case kde::EXPONENTIAL_BF16:
      return launch_kind<kde::EXPONENTIAL_BF16, DRAW>(a, s.instance, st);
    case kde::RATIONAL_QUADRATIC_BF16:
      return launch_kind<kde::RATIONAL_QUADRATIC_BF16, DRAW>(a, s.instance, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// table: the (65536,) bf16 exp table for the bf16 gaussian and exponential
// kinds, else null.
int kde_masked_blocksum_launch(const float* q, const float* x, const void* own, float* out,
                               const float* table, void* stream, const KdeTileShape* s) {
  Args a{};
  a.q = q; a.x = x; a.own = own; a.bs = out; a.p.table = table;
  return launch<false>(a, *s, static_cast<cudaStream_t>(stream));
}

// counter: one int per query tile of the plan, all 0 (the kernel leaves them 0).
int kde_sample_block_launch(const float* q, const float* x, const void* own,
                            const float* gumbel, float* bs, long long* blk, float* pb,
                            float* tot, int* counter, const float* table, void* stream,
                            const KdeTileShape* s) {
  Args a{};
  a.q = q; a.x = x; a.own = own; a.g = gumbel; a.bs = bs; a.blk = blk; a.pb = pb;
  a.tot = tot; a.counter = counter; a.p.table = table;
  return launch<true>(a, *s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
