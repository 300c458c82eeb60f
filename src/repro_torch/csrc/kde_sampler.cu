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
// per device and reuses: launches on one stream never overlap, and the port
// runs every kernel on the current stream of its tensors' device (a second
// stream running this kernel concurrently would need its own buffer).
//
// Two instances, chosen by the host-side plan (kernels/kde_sampler/kernel.py
// ``sample_block_plan``):
// - wide (d % 4 == 0, d <= 32, q and x 16-byte aligned): 256 threads own a
//   128-row query tile.  The tile is staged once per CTA with 16-byte
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
// Both keep the reference's arithmetic: d2 = max(qn + xn - 2 cross, 0)
// through kde::finish, IEEE expf/sqrtf/powf, no TF32, no fast-math.  Queries
// are not padded: rows >= m are masked; a negative own index marks a row with
// no own block; own is int32 or int64 (a flag in the shape struct).
#include <stdint.h>

#include "kde_tile.cuh"

namespace {

constexpr float FLOOR = 1e-12f;   // == ref.BLOCK_SUM_FLOOR
constexpr int THREADS = 256;

}  // namespace

// Static arguments of a launch (kernels/build.py ``KdeTileShape``).
struct KdeTileShape {
  int m, n, d, bn, nb;
  int own64;      // own is int64 (else int32)
  int instance;   // 0 generic, 16 or 32: the wide tile with that padded d
  int group;      // consecutive level-1 blocks a CTA sums
  int kind;
  float inv_bw, inv_bw2, beta;
};

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
  kde::Params p;
};

__device__ __forceinline__ void store_sum(const Args& a, float s, int gi, int b) {
  const long long own = a.own64 ? static_cast<const long long*>(a.own)[gi]
                                : static_cast<const int*>(a.own)[gi];
  if (own == b) s -= 1.0f;                      // k(x, x) = 1 self mask
  a.bs[(size_t)gi * a.nb + b] = fmaxf(s, FLOOR);
}

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
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
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
  static_assert(TX * TY == THREADS && BM == BN && 2 * BM == THREADS,
                "norms take two threads per row");
};

// Stage rows [0, ROWS) of src (row stride d floats) into dst (row stride RS)
// with 16-byte copies; rows >= valid and coordinates >= d are zero (d % 4 ==
// 0, so a 16-byte piece is all in or all out).
template <int DK, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int valid, int d) {
  constexpr int V = DK / 4;
  for (int e = threadIdx.x; e < ROWS * V; e += THREADS) {
    const int r = e / V, k = 4 * (e % V);
    const bool ok = r < valid && k < d;
    cp_async16(dst + r * Wide<DK>::RS + k, ok ? src + (size_t)r * d + k : src, ok ? 16 : 0);
  }
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

template <int KIND, int DK, bool DRAW>
__global__ void __launch_bounds__(THREADS, 2)
sampler_wide_kernel(Args a) {
  using W = Wide<DK>;
  constexpr bool L2 = KIND != kde::LAPLACIAN;
  extern __shared__ __align__(16) float smem[];
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
    const bool full = j0 + W::BN <= jend;
#pragma unroll
    for (int cc = 0; cc < W::TN; ++cc) {
      const int col = tx + W::TX * cc;
      const float xv = L2 ? xn[col] : 0.0f;
      const bool ok = full || j0 + col < jend;
#pragma unroll
      for (int r = 0; r < W::TM; ++r) {
        const float qv = L2 ? qn[ty + W::TY * r] : 0.0f;
        const float v = kde::finish<KIND>(acc[r][cc], qv, xv, a.p);
        if (ok) rs[r] += v;
      }
    }
    if (nc == 0) {            // block b is complete: its sums, then restart
      // the TX threads of a row are 16 consecutive lanes: fixed-order xor sums
#pragma unroll
      for (int r = 0; r < W::TM; ++r)
#pragma unroll
        for (int off = W::TX / 2; off > 0; off >>= 1)
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off, W::TX);
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < W::TM; ++r) {
          const int gi = i0 + ty + W::TY * r;
          if (gi < a.m) store_sum(a, rs[r], gi, b);
        }
      }
#pragma unroll
      for (int r = 0; r < W::TM; ++r) rs[r] = 0.0f;
    }
    if (!more) break;
    b = nb_;
    c = nc;
  }
  if (DRAW) draw_if_last<W::BM>(a, i0);
}

template <int KIND, int DK, bool DRAW>
int launch_wide(const Args& a, cudaStream_t st) {
  constexpr int smem = Wide<DK>::BYTES;
  static bool raised = false;             // above 48 KB at DK = 32
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        sampler_wide_kernel<KIND, DK, DRAW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + Wide<DK>::BM - 1) / Wide<DK>::BM);
  sampler_wide_kernel<KIND, DK, DRAW><<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, bool DRAW>
int launch_kind(const Args& a, int instance, cudaStream_t st) {
  if (instance == 16) return launch_wide<KIND, 16, DRAW>(a, st);
  if (instance == 32) return launch_wide<KIND, 32, DRAW>(a, st);
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.nb + a.group - 1) / a.group, (a.m + kde::BM - 1) / kde::BM);
  sampler_generic_kernel<KIND, DRAW><<<grid, kde::THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool DRAW>
int launch(Args a, const KdeTileShape& s, cudaStream_t st) {
  a.m = s.m; a.n = s.n; a.d = s.d; a.bn = s.bn; a.nb = s.nb; a.own64 = s.own64;
  a.group = s.group;
  a.p = kde::Params{s.inv_bw, s.inv_bw2, s.beta};
  switch (s.kind) {
    case kde::GAUSSIAN: return launch_kind<kde::GAUSSIAN, DRAW>(a, s.instance, st);
    case kde::EXPONENTIAL: return launch_kind<kde::EXPONENTIAL, DRAW>(a, s.instance, st);
    case kde::RATIONAL_QUADRATIC:
      return launch_kind<kde::RATIONAL_QUADRATIC, DRAW>(a, s.instance, st);
    case kde::LAPLACIAN: return launch_kind<kde::LAPLACIAN, DRAW>(a, s.instance, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int kde_masked_blocksum_launch(const float* q, const float* x, const void* own, float* out,
                               void* stream, const KdeTileShape* s) {
  Args a{};
  a.q = q; a.x = x; a.own = own; a.bs = out;
  return launch<false>(a, *s, static_cast<cudaStream_t>(stream));
}

// counter: one int per query tile of the plan, all 0 (the kernel leaves them 0).
int kde_sample_block_launch(const float* q, const float* x, const void* own,
                            const float* gumbel, float* bs, long long* blk, float* pb,
                            float* tot, int* counter, void* stream, const KdeTileShape* s) {
  Args a{};
  a.q = q; a.x = x; a.own = own; a.g = gumbel; a.bs = bs; a.blk = blk; a.pb = pb;
  a.tot = tot; a.counter = counter;
  return launch<true>(a, *s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
