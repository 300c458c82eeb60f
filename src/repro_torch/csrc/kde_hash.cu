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
// Here the kernel gathers x (n, d) by cols (m, t) itself, so the (m, t, d)
// tensor never exists: at the sampler's frontier shape (m = 1024, t = 1152,
// d = 16) that tensor is 75 MB written and read again per edge batch.
// Columns outside [0, n) are clamped to [0, n - 1], as a JAX gather clamps;
// the corruption flag is raised outside the kernel.
//
// Bound on the H100: bytes, not operations.  At d = 16 a (row, column) pair
// costs 2d + 7 FP32 operations against at least 76 bytes (the 64-byte row of
// x, the column index, the weight and, for the (m, t) entry point, the
// output).  Counting each distinct gathered row once from HBM, the frontier
// read's bound is 0.0092 ms; the gathers themselves move 1024 x 1152 x 64 B =
// 75.5 MB through L2 (each row ~4.5 times), and x (16.8 MB at n = 262144)
// fits in the 50 MB L2, so L2's rate, not HBM's, is the practical floor.
//
// Design.  One CTA of 128 threads per query row, taking the row's columns
// in index order across its lanes (each load of cols, wgt and out is
// coalesced across a warp).  Two instances, chosen by the host-side plan
// (kernels/kde_hash/kernel.py ``weighted_kv_plan``):
// - vector (d % 4 == 0, d <= 32, x 16-byte aligned): a gathered
//   row is read by L = 4 lanes (8 at d <= 32), lane l loading its 16-byte
//   piece l, so one warp instruction touches 8 rows -- one L1 wavefront
//   each -- where one lane per row costs 32 wavefronts an instruction: at
//   the frontier read's 4.7 M gathered pieces that alone is ~20 us of L1
//   time, so a lane-per-row gather stays near 25 us on the H100 however
//   many loads it keeps in flight.  The lanes add their partial dot
//   products and norms by xor shuffles in a fixed order.  q's piece and qq
//   sit in registers; a thread holds U = 8 columns' indices and weights, issues
//   their 8 gathers at once, and loads the next 8 indices and weights
//   before the math, so the index -> gather chain of one group overlaps
//   the previous group's.  x is read through the read-only path with an L2
//   evict-last policy, so the dataset stays resident in L2 across the edge
//   batch's other operations.
// - scalar (any d, any alignment; the ragged checks' d = 19 and d = 784): a
//   lane a column, a plain loop over the row's coordinates, q from shared
//   memory.
// Both assemble d2 = max(qq + xx - 2 cross, 0) through kde::finish (the
// reference's rowwise_kv formula, not sum (q - x)^2); the laplacian sums
// |q - x|.  IEEE f32 throughout: expf/sqrtf/powf, no fast-math, no tensor
// cores.  The (m,) sum adds each thread's columns in index order, then warp
// xor-shuffles, then the four warp totals in warp order: a fixed order, so
// the result is the same from run to run.  No atomics.
//
// precision="bf16" (the Pallas kernel's bf16 specialisation: rowwise_kv on
// rounded rows, finished through the exp-table operand) runs both
// instances at the bf16 kind ids of kde_tile.cuh: q's coordinates are
// rounded where they are loaded and exp is read from `table` (the L2 kinds
// only; the HT weights stay f32).  The gathered rows come one of two ways
// (the plan picks by x's dtype, kernels/kde_hash/kernel.py
// ``weighted_kv_plan``):
// - an f32 x: each gathered coordinate is rounded as it arrives in a
//   register (the f32 rows' 64 bytes at d = 16 cross L2 for 32 used);
// - a bf16 x, the dataset's bf16-resident copy (instance + BF16_ROWS,
//   made once per dataset by the hashed estimator): the rows are 32 bytes
//   at d = 16, 64 at d = 32, so the gathers move half the bytes and x
//   takes half the L2.  The vector instance keeps L = D4 lanes a row, each
//   loading its 4 coordinates as one 8-byte piece (evict-last, as the f32
//   rows) and unpacking the bf16 pairs by bit operations (exact), so every
//   lane adds the same values in the same order as on the f32 x: the
//   outputs are bitwise those of the f32-x instance on the same dataset.
#include <stdint.h>

#include <type_traits>

#include "kde_func.cuh"
#include "kde_tile.cuh"

// Static arguments of a launch (kernels/build.py ``KdeWeightedShape``).
struct KdeWeightedShape {
  int m, n, d, t;
  int instance;   // 0 scalar, 4 or 8: the vector instance with that many float4 per row;
                  // + BF16_ROWS: the same on a bf16 x
  int kind;
  float inv_bw, inv_bw2, beta;
};

namespace {

constexpr int THREADS = 128;      // threads a row
constexpr int BF16_ROWS = 16;     // KdeWeightedShape::instance flag: x is bf16

using bf16 = __nv_bfloat16;

// A gathered coordinate as f32: a KIND operand from an f32 x, exact from a
// bf16 x (its values are already rounded).
template <int KIND>
__device__ __forceinline__ float gathered(const float* p) {
  return kde::operand<KIND>(__ldg(p));
}
template <int KIND>
__device__ __forceinline__ float gathered(const bf16* p) {
  return __bfloat162float(*p);
}

// A KIND instance's kernel-value arguments: the f32 kinds' 12-byte Params,
// the bf16 kinds' TableParams (with the exp table).
template <int KIND>
using KindParams = std::conditional_t<kde::is_bf16(KIND), kde::TableParams, kde::Params>;
constexpr int WARPS = THREADS / 32;

// Sum of a thread's values in index order, then across the CTA in a fixed
// order; thread 0 writes it.
__device__ __forceinline__ void cta_sum(float total, float* out) {
  __shared__ float warp_sum[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sum[w];
    *out = s;
  }
}

// -------------------------------------------------------------- scalar
template <int KIND, bool SUM, class XT>
__global__ void __launch_bounds__(THREADS)
weighted_kv_scalar_kernel(const float* __restrict__ q, const XT* __restrict__ x,
                          const int* __restrict__ cols, const float* __restrict__ wgt,
                          float* __restrict__ out, int n, int d, int t, KindParams<KIND> p) {
  extern __shared__ float qs[];              // d floats: this CTA's query row
  constexpr bool L2 = KIND != kde::LAPLACIAN;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < d; k += THREADS) qs[k] = kde::operand<KIND>(q[(size_t)row * d + k]);
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
    const XT* xr = x + (size_t)c * d;
    float acc = 0.0f, xx = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float v = gathered<KIND>(xr + k);
      if (L2) {
        acc = fmaf(qs[k], v, acc);
        xx = fmaf(v, v, xx);
      } else {
        acc += fabsf(qs[k] - v);
      }
    }
    const float val = kde::finish<KIND>(acc, qq, xx, p) * w_row[j];
    if (SUM) total += val;
    else out[(size_t)row * t + j] = val;
  }
  if (SUM) cta_sum(total, out + row);
}

// -------------------------------------------------------------- vector
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 16-byte read-only load of x with the L2 evict-last policy.
__device__ __forceinline__ float4 ld_keep(const float4* ptr, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(ptr), "l"(pol));
  return v;
}

// 8-byte read-only load of a bf16 x with the L2 evict-last policy: four
// coordinates, unpacked to f32 (a bf16 value is the high half of its f32).
__device__ __forceinline__ float4 ld_keep(const uint2* ptr, uint64_t pol) {
  uint32_t lo, hi;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
      : "=r"(lo), "=r"(hi)
      : "l"(ptr), "l"(pol));
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
}

// Clamped column indices (-1 past the row's end) and weights of columns
// j0 + stride u, u < U.
template <int U>
__device__ __forceinline__ void load_group(int (&c)[U], float (&w)[U], const int* c_row,
                                           const float* w_row, int j0, int stride, int n,
                                           int t) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + stride * u;
    c[u] = j < t ? min(max(__ldg(c_row + j), 0), n - 1) : -1;
    w[u] = j < t ? __ldg(w_row + j) : 0.0f;
  }
}

// The vector instance: L = D4 lanes share a column, lane l loading float4 l
// of its row (or its 4 bf16 coordinates, 8 bytes, from a bf16 x), so a
// warp's gather instruction touches 32 / L rows (one L1 wavefront each)
// instead of 32.
template <int KIND, bool SUM, int D4, class XT>
__global__ void __launch_bounds__(THREADS)
weighted_kv_vec_kernel(const float* __restrict__ q, const XT* __restrict__ x,
                       const int* __restrict__ cols, const float* __restrict__ wgt,
                       float* __restrict__ out, int n, int d, int t, KindParams<KIND> p) {
  constexpr bool L2 = KIND != kde::LAPLACIAN;
  constexpr int L = D4;                       // lanes a column
  constexpr int SLOTS = THREADS / L;          // columns a CTA reads at once
  constexpr bool ROWS16 = std::is_same_v<XT, bf16>;
  // gathers in flight a thread: 4 for the 8-byte pieces of a bf16 x (8
  // measured slower there on the H100, PERF.md's findings; the order in which
  // a thread adds its columns does not depend on U)
  constexpr int U = ROWS16 ? 4 : 8;
  constexpr int STEP = SLOTS * U;             // columns a CTA covers a group
  const int row = blockIdx.x;
  const int lane_l = threadIdx.x % L;         // float4 of the row this lane reads
  const int slot = threadIdx.x / L;
  const int d4 = d >> 2;
  const bool mine = lane_l < d4;              // lanes past d read nothing
  const uint64_t pol = evict_last_policy();
  // this lane's float4 of q, and qq over the whole row (the L lanes' pieces
  // added like the dot products), in registers (q need not be 16-byte
  // aligned: scalar loads)
  const float* qr = q + (size_t)row * d;
  float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (mine)
    qv = kde::operand4<KIND>(make_float4(__ldg(qr + 4 * lane_l), __ldg(qr + 4 * lane_l + 1),
                                         __ldg(qr + 4 * lane_l + 2),
                                         __ldg(qr + 4 * lane_l + 3)));
  float qq = 0.0f;
  if (L2) {
    qq = qv.x * qv.x;
    qq = fmaf(qv.y, qv.y, qq);
    qq = fmaf(qv.z, qv.z, qq);
    qq = fmaf(qv.w, qv.w, qq);
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) qq += __shfl_xor_sync(0xffffffffu, qq, off, L);
  }
  const int* c_row = cols + (size_t)row * t;
  const float* w_row = wgt + (size_t)row * t;
  using Piece = std::conditional_t<ROWS16, uint2, float4>;   // 4 coordinates
  const Piece* x4 = reinterpret_cast<const Piece*>(x);
  float total = 0.0f;
  int c[U];
  float w[U];
  load_group<U>(c, w, c_row, w_row, slot, SLOTS, n, t);
  for (int base = 0; base < t; base += STEP) {
    float4 xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      xv[u] = (c[u] >= 0 && mine) ? ld_keep(x4 + (size_t)c[u] * d4 + lane_l, pol)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool live[U];
    float wu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) { live[u] = c[u] >= 0; wu[u] = w[u]; }
    // the next group's indices and weights while this group's rows are in flight
    load_group<U>(c, w, c_row, w_row, base + STEP + slot, SLOTS, n, t);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 v = ROWS16 ? xv[u] : kde::operand4<KIND>(xv[u]);
      float acc, xx = 0.0f;
      if (L2) {
        acc = qv.x * v.x;
        acc = fmaf(qv.y, v.y, acc);
        acc = fmaf(qv.z, v.z, acc);
        acc = fmaf(qv.w, v.w, acc);
        xx = v.x * v.x;
        xx = fmaf(v.y, v.y, xx);
        xx = fmaf(v.z, v.z, xx);
        xx = fmaf(v.w, v.w, xx);
      } else {                   // coordinates past d are 0 on both sides
        acc = fabsf(qv.x - v.x) + fabsf(qv.y - v.y);
        acc = acc + fabsf(qv.z - v.z);
        acc = acc + fabsf(qv.w - v.w);
      }
      // the L lanes of a column are consecutive: fixed-order xor sums
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off, L);
        if (L2) xx += __shfl_xor_sync(0xffffffffu, xx, off, L);
      }
      if (live[u] && lane_l == 0) {
        const int j = base + slot + SLOTS * u;
        const float val = kde::finish<KIND>(acc, qq, xx, p) * wu[u];
        if (SUM) total += val;
        else out[(size_t)row * t + j] = val;
      }
    }
  }
  if (SUM) cta_sum(total, out + row);
}

template <int KIND, bool SUM, class XT>
int launch_rows(const float* q, const XT* x, const int* cols, const float* wgt, float* out,
                const KindParams<KIND>& p, int instance, const KdeWeightedShape& s,
                cudaStream_t st) {
  if (instance == 4)
    weighted_kv_vec_kernel<KIND, SUM, 4, XT><<<s.m, THREADS, 0, st>>>(q, x, cols, wgt, out,
                                                                          s.n, s.d, s.t, p);
  else if (instance == 8)
    weighted_kv_vec_kernel<KIND, SUM, 8, XT><<<s.m, THREADS, 0, st>>>(q, x, cols, wgt, out,
                                                                          s.n, s.d, s.t, p);
  else if (instance == 0)
    weighted_kv_scalar_kernel<KIND, SUM, XT>
        <<<s.m, THREADS, sizeof(float) * (size_t)s.d, st>>>(q, x, cols, wgt, out, s.n, s.d,
                                                            s.t, p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x is f32, or bf16 (instance + BF16_ROWS) for the bf16 kinds
template <int KIND, bool SUM>
int launch_kind(const float* q, const void* x, const int* cols, const float* wgt,
                float* out, const float* table, const KdeWeightedShape& s, cudaStream_t st) {
  KindParams<KIND> p{s.inv_bw, s.inv_bw2, s.beta};
  if constexpr (kde::is_bf16(KIND)) {
    p.table = table;
    if (s.instance >= BF16_ROWS)
      return launch_rows<KIND, SUM>(q, static_cast<const bf16*>(x), cols, wgt, out, p,
                                    s.instance - BF16_ROWS, s, st);
  }
  return launch_rows<KIND, SUM>(q, static_cast<const float*>(x), cols, wgt, out, p,
                                s.instance, s, st);
}

template <bool SUM>
int launch(const float* q, const void* x, const int* cols, const float* wgt, float* out,
           const float* t, const KdeWeightedShape& s, cudaStream_t st) {
  switch (s.kind) {
    case kde::GAUSSIAN: return launch_kind<kde::GAUSSIAN, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::EXPONENTIAL:
      return launch_kind<kde::EXPONENTIAL, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::RATIONAL_QUADRATIC:
      return launch_kind<kde::RATIONAL_QUADRATIC, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::LAPLACIAN:
      return launch_kind<kde::LAPLACIAN, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::GAUSSIAN_BF16:
      return launch_kind<kde::GAUSSIAN_BF16, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::EXPONENTIAL_BF16:
      return launch_kind<kde::EXPONENTIAL_BF16, SUM>(q, x, cols, wgt, out, t, s, st);
    case kde::RATIONAL_QUADRATIC_BF16:
      return launch_kind<kde::RATIONAL_QUADRATIC_BF16, SUM>(q, x, cols, wgt, out, t, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// table: the (65536,) bf16 exp table for the bf16 gaussian and exponential
// kinds, else null.
// x: (n, d) f32, or bf16 where the shape's instance has BF16_ROWS.
int kde_weighted_kv_launch(const float* q, const void* x, const int* cols, const float* wgt,
                           float* out, const float* table, void* stream,
                           const KdeWeightedShape* s) {
  return launch<false>(q, x, cols, wgt, out, table, *s, static_cast<cudaStream_t>(stream));
}

int kde_weighted_kv_sum_launch(const float* q, const void* x, const int* cols,
                               const float* wgt, float* out, const float* table, void* stream,
                               const KdeWeightedShape* s) {
  return launch<true>(q, x, cols, wgt, out, table, *s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

namespace {

// The weighted instances of one kind and row type, as launch_rows launches
// them (the scalar instance's 4 d bytes of shared memory are the shape's:
// 0 here).
template <int KIND, class XT>
bool weighted_func(int id, bool sum, int d4, kde::FuncInfo* f) {
  using kde::info;
  if (id == kde::F_WEIGHTED_SCALAR) {
    *f = sum ? info(weighted_kv_scalar_kernel<KIND, true, XT>, THREADS, 0)
             : info(weighted_kv_scalar_kernel<KIND, false, XT>, THREADS, 0);
    return true;
  }
  if (id != kde::F_WEIGHTED_VEC || (d4 != 4 && d4 != 8)) return false;
  if (d4 == 4)
    *f = sum ? info(weighted_kv_vec_kernel<KIND, true, 4, XT>, THREADS, 0)
             : info(weighted_kv_vec_kernel<KIND, false, 4, XT>, THREADS, 0);
  else
    *f = sum ? info(weighted_kv_vec_kernel<KIND, true, 8, XT>, THREADS, 0)
             : info(weighted_kv_vec_kernel<KIND, false, 8, XT>, THREADS, 0);
  return true;
}

}  // namespace

// kde_func.cuh: an instance of this source (every kind on an f32 x, the bf16
// kinds on a bf16 x too).  1 when found, else 0.
extern "C" int kde_hash_func(int id, int instance, kde::FuncInfo* f) {
  const int kind = kde::targ(instance, 0);
  const bool sum = kde::targ(instance, 1) != 0;
  const int d4 = id == kde::F_WEIGHTED_VEC ? kde::targ(instance, 2) : 0;
  const bool rows16 = kde::targ(instance, id == kde::F_WEIGHTED_VEC ? 3 : 2) != 0;
  return kde::with_kind_tenant(kind, 0, [&](auto k, auto) {
    constexpr int KIND = decltype(k)::value;
    if constexpr (kde::is_bf16(KIND)) {
      if (rows16) return weighted_func<KIND, bf16>(id, sum, d4, f);
    }
    return !rows16 && weighted_func<KIND, float>(id, sum, d4, f);
  }) ? 1 : 0;
}
