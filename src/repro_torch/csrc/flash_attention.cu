// Causal online-softmax attention forward with GQA (flash attention).
//
// flash_attention_launch replaces
//     src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
//     (body _attn_kernel)
//   q (b, hq, sq, dh), k / v (b, hkv, skv, dh), f32 or bf16
//   -> out (b, hq, sq, dh) in q's type, lse (b, hq, sq) f32
// Query row r sits at position r + offset; key j is valid iff j < kv_valid
// and, when causal, j <= r + offset.  The caller (ops.flash_attention) pads
// k / v to the reference's block multiple and passes the reference's
// offset = padded skv - padded sq, so the function is the Pallas kernel's,
// quirks included (ROADMAP.md section 3).  Two bodies share the grid, the
// staging and the masks: flash_fwd_kernel (f32 operands, FP32 FMAs) and
// flash_mma_kernel (bf16 operands, tensor cores).
//
// Shared design:
// * One CTA of 256 threads per (q-head, batch, 128-row query tile); K / V
//   tiles of 64 keys double-buffered in dynamic shared memory, filled by
//   cp.async 16-byte copies (zero-filling rows past the end) while the
//   previous tile computes.  Rows are padded by 16 bytes, so 8 rows read
//   at one 16-byte column fall in 8 distinct bank groups.  Rows that are
//   not 16-byte aligned, or a dh that is not a multiple of 16 bytes, go
//   through the scalar-staged instance of the same template (the wrapper
//   picks it; ``VEC`` below).  The head dim is a compile-time bucket (32,
//   64, 128); columns past dh are zero in shared memory.
// * Masks only where they bite.  A key tile that lies wholly below the
//   diagonal of every row and before kv_valid and skv skips the
//   per-element masks; the diagonal tile and the tile holding kv_valid (or
//   the ragged end of skv) apply them.
// * Heavy tiles first.  The query tile is the slow part of the grid's x
//   index (x = tile * hq + head) and, when causal, runs in reverse, so the
//   tiles with the most keys start in the first wave.
// Sentinel semantics are the reference's: a masked score is -1e30 and a
// row with no valid key yet takes p = exp(0) = 1 per masked key, so a
// masked tile is skipped only once every row of the CTA has a finite max
// (then p = exp(-1e30 - m) = 0 and alpha = 1 exactly).  Keys past skv do
// not exist (p = 0).  IEEE f32 softmax (expf, logf, true division).  GQA:
// q-head h reads kv-head h / (hq / hkv); no head is replicated.  q, k, v
// may be strided over (batch, head, position); the head dimension must be
// contiguous.
//
// flash_fwd_kernel, f32 operands.  Bound on the H100: operations.  At the
// prefill shape (1, 32, 8192, 128) the causal half of QK^T and PV is
// 4 b hq dh s^2 / 2 = 5.5e11 FP32 operations (8.2 ms at 67 TFLOP/s)
// against ~0.3 GB of operands (0.09 ms).  TF32 is ruled out by the f32
// contract, so the design feeds the FMA units from registers: thread (ty,
// tx) = (tid / 16, tid % 16) owns query rows 8 ty .. 8 ty + 7, score
// columns tx + 16 j (j < 4) and, in PV, output columns in groups of 16
// bytes; per 16 bytes of head dim QK^T issues 12 shared loads for the 8 x
// 4 tile's 128 FMAs, PV 4 loads per 64 FMAs.  The probability tile is
// stored key-major in the current K buffer once the scores are formed.
//
// flash_mma_kernel, bf16 operands.  Bound on the H100: operations, 5.5e11
// at the bf16 tensor-core rate (989 TFLOP/s dense): 0.56 ms at the prefill
// shape.  The reference upcasts the bf16 tiles and computes scores, p, l
// and the accumulators in f32 (kernel.py:35-51); here
// * QK^T runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate): products of
//   bf16 values are exact in f32, so the scores are the reference's up to
//   the order of the sums.  Warp w owns query rows 16 w .. 16 w + 15; its
//   Q fragments are loaded once (ldmatrix) and stay in registers, K
//   fragments come by ldmatrix from the padded tile.  The scale and the
//   masks apply to the f32 accumulators; the online softmax runs per row
//   on the C fragments (a row's 64 scores lie in one quad of lanes).
// * PV keeps p in f32 as the reference does: p = p_hi + p_lo with p_hi =
//   bf16(p) and p_lo = bf16(p - p_hi) (the difference is exact in f32),
//   and two MMAs against the same V fragment (ldmatrix.trans) add both
//   into the f32 accumulators.  p_hi + p_lo is p to about 2^-17 relative,
//   where a single rounding of p would leave 2^-9; the price is 1.5x the
//   tensor work of a plain bf16 PV.  l sums the f32 p.  The C fragments of
//   the scores are the A fragments of PV, so p never leaves registers.
// On the card the per-tile chain (scores, softmax, PV, one barrier a tile,
// 8 warps an SM) sets the pace rather than the tensor rate: a warpgroup-
// MMA body of the same structure measured no faster (PERF.md section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;          // query rows per CTA
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int RM = 8;            // rows per thread (8 ty .. 8 ty + 7)
constexpr int CM = 4;            // score columns per thread (tx + 16 j)
constexpr int PS = BQ + 4;       // key-major probability tile row stride (floats)
constexpr int DMAX = 128;
constexpr float NEG = -1.0e30f;  // the reference's sentinel

struct Shape {
  int hq, hkv, sq, skv, dh, causal, offset, kv_valid;
  float scale;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
};

// elements of T in 16 bytes, and the padded row stride of the Q / K / V tiles
template <typename T> struct Tile {
  static constexpr int VE = 16 / (int)sizeof(T);
};
template <typename T, int DB> struct Layout {
  static constexpr int VE = Tile<T>::VE;
  static constexpr int RS = DB + VE;                    // elements per row
  static constexpr int KBYTES = BKV * RS * (int)sizeof(T);
  static constexpr int PBYTES = BKV * PS * (int)sizeof(float);
  static constexpr int SLOT = KBYTES > PBYTES ? KBYTES : PBYTES;  // K or P
  static constexpr int QBYTES = BQ * RS * (int)sizeof(T);
  static constexpr int BYTES = QBYTES + 2 * SLOT + 2 * KBYTES;
  // output columns per thread, in NG groups of G contiguous elements
  static constexpr int OC = DB / 16;
  static constexpr int G = OC < VE ? OC : VE;
  static constexpr int NG = OC / G;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// N contiguous floats from shared memory (N * 4 in {4, 8, 16} bytes, aligned)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    static_assert(N == 1, "float loads of 1, 2 or 4");
    o[0] = *p;
  }
}

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

// Stage rows [0, BR) of a tile: row r comes from src + r * rs when r < n,
// columns past dh are zero, rows at or past n are zero.  VEC: 16-byte
// cp.async copies (asynchronous until cp_async_wait_all; src, rs and dh
// must keep every copy 16-byte aligned).  Otherwise plain element loads.
// No runtime division: a thread's (row, column) step is a compile-time
// power of two.
template <typename T, int DB, bool VEC, int BR>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long long rs, int n,
                                      int dh, int tid) {
  using L = Layout<T, DB>;
  if constexpr (VEC) {
    constexpr int CH = DB / L::VE;              // 16-byte chunks per row
    constexpr int RPP = THREADS / CH;           // rows per pass
    const int c = tid % CH, r0 = tid / CH;      // compile-time shifts
    const int d = c * L::VE;
#pragma unroll
    for (int r = r0; r < BR; r += RPP) {
      const bool ok = r < n && d < dh;
      const T* g = ok ? src + r * rs + d : src;
      cp_async16(dst + r * L::RS + d, g, ok ? 16 : 0);
    }
  } else {
    constexpr int RPP = THREADS / DB;
    const int d = tid % DB, r0 = tid / DB;
#pragma unroll 4
    for (int r = r0; r < BR; r += RPP) {
      const bool ok = r < n && d < dh;
      dst[r * L::RS + d] = ok ? src[r * rs + d] : zero<T>();
    }
  }
}

template <typename T, int DB, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Shape s) {
  using L = Layout<T, DB>;
  constexpr int VE = L::VE, RS = L::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  unsigned char* slots = smem + L::QBYTES;                      // K / P, 2 slots
  unsigned char* vbufs = slots + 2 * L::SLOT;                   // V, 2 buffers

  // blockIdx.x = (query tile) * hq + head: the tile is the slow index
  const int h = blockIdx.x % s.hq;
  const int bi = blockIdx.y;
  const int nqt = gridDim.x / s.hq;
  const int z = blockIdx.x / s.hq;
  const int qt = s.causal ? nqt - 1 - z : z;
  const int q0 = qt * BQ;
  const int kvh = h / (s.hq / s.hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * RM;

  const T* qb = q + bi * s.qsb + h * s.qsh;
  const T* kb = k + bi * s.ksb + kvh * s.ksh;
  const T* vb = v + bi * s.vsb + kvh * s.vsh;

  // rows past sq are never stored; they count as finite for the skip test
  const int last_row = min(q0 + BQ, s.sq) - 1;
  const int qpos_min = q0 + s.offset;
  const int qpos_max = last_row + s.offset;
  const int nt = (s.skv + BKV - 1) / BKV;
  // tiles from first_masked on are masked for every row (masks are monotone
  // in the key position); only they may be skipped, so only earlier tiles
  // are prefetched
  int lim = min(s.kv_valid, s.skv);
  if (s.causal) lim = min(lim, qpos_max + 1);
  const int first_masked = lim <= 0 ? 0 : min(nt, (lim + BKV - 1) / BKV);

  auto issue = [&](int t) {
    const int kt = t * BKV;
    T* kd = reinterpret_cast<T*>(slots + (t & 1) * L::SLOT);
    T* vd = reinterpret_cast<T*>(vbufs + (t & 1) * L::KBYTES);
    stage<T, DB, VEC, BKV>(kd, kb + kt * s.kss, s.kss, s.skv - kt, s.dh, tid);
    stage<T, DB, VEC, BKV>(vd, vb + kt * s.vss, s.vss, s.skv - kt, s.dh, tid);
    if constexpr (VEC) cp_async_commit();
  };

  stage<T, DB, VEC, BQ>(Qs, qb + q0 * s.qss, s.qss, s.sq - q0, s.dh, tid);
  if (first_masked > 0) issue(0);
  else if constexpr (VEC) cp_async_commit();

  float m[RM], l[RM], acc[RM][L::OC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int o = 0; o < L::OC; ++o) acc[i][o] = 0.0f;
  }

  for (int t = 0; t < nt; ++t) {
    const int kt = t * BKV;
    if (t >= first_masked) {
      // with a finite max every later tile adds exactly nothing
      int finite = 1;
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (q0 + r0 + i < s.sq && m[i] == NEG) finite = 0;
      if (__syncthreads_and(finite)) break;
      issue(t);   // not prefetched: its buffers were last read two tiles ago
    }
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();   // tile t has landed; every thread is done with tile t - 1
    if (t + 1 < first_masked) issue(t + 1);

    const T* Ks = reinterpret_cast<const T*>(slots + (t & 1) * L::SLOT);
    const T* Vs = reinterpret_cast<const T*>(vbufs + (t & 1) * L::KBYTES);
    float* Ps = reinterpret_cast<float*>(slots + (t & 1) * L::SLOT);

    float sc[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d0 = 0; d0 < DB; d0 += VE) {
      float kf[CM][VE];
#pragma unroll
      for (int j = 0; j < CM; ++j) lds<VE>(Ks + (tx + 16 * j) * RS + d0, kf[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float qf[VE];
        lds<VE>(Qs + (r0 + i) * RS + d0, qf);
#pragma unroll
        for (int j = 0; j < CM; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) sc[i][j] = fmaf(qf[e], kf[j][e], sc[i][j]);
      }
    }

    // a tile needs masks only if some key of it is at or past kv_valid or
    // skv, or (causal) past the smallest query position of the CTA
    const bool interior = kt + BKV <= s.kv_valid && kt + BKV <= s.skv &&
                          (!s.causal || kt + BKV - 1 <= qpos_min);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG;
      if (interior) {
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          sc[i][j] *= s.scale;
          mx = fmaxf(mx, sc[i][j]);
        }
      } else {
        const int qpos = q0 + r0 + i + s.offset;
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          const int key = kt + tx + 16 * j;
          bool valid = key < s.kv_valid;
          if (s.causal) valid = valid && key <= qpos;
          sc[i][j] = valid ? sc[i][j] * s.scale : NEG;
          mx = fmaxf(mx, sc[i][j]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        // keys past skv do not exist (the last tile's ragged end): p = 0
        const float p = (interior || kt + tx + 16 * j < s.skv) ? expf(sc[i][j] - m_new) : 0.0f;
        sc[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int o = 0; o < L::OC; ++o) acc[i][o] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done reading this K tile: P takes its place
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      float* pr = Ps + (tx + 16 * j) * PS + r0;
      *reinterpret_cast<float4*>(pr) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(pr + 4) = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }
    __syncthreads();

    // keys past skv have p = 0 and zero rows in Vs, so every tile runs all
    // BKV keys
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float p[RM];
      lds<4>(Ps + c * PS + r0, p);
      lds<4>(Ps + c * PS + r0 + 4, p + 4);
      float vv[L::OC];
#pragma unroll
      for (int g = 0; g < L::NG; ++g)
        lds<L::G>(Vs + c * RS + (tx + 16 * g) * L::G, vv + g * L::G);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int o = 0; o < L::OC; ++o) acc[i][o] = fmaf(p[i], vv[o], acc[i][o]);
    }
  }
  if constexpr (VEC) cp_async_wait_all();   // nothing in flight at exit

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + r0 + i;
    if (row >= s.sq) continue;
    const float safe = fmaxf(l[i], 1e-30f);
    const size_t o = ((size_t)(bi * s.hq + h) * s.sq + row);
#pragma unroll
    for (int g = 0; g < L::NG; ++g)
#pragma unroll
      for (int e = 0; e < L::G; ++e) {
        const int d = (tx + 16 * g) * L::G + e;
        if (d < s.dh) put(out + o * s.dh + d, acc[i][g * L::G + e] / safe);
      }
    if (tx == 0) lse[o] = l[i] > 0.0f ? m[i] + logf(safe) : NEG;
  }
}

// ---------------------------------------------------------------------------
// flash_mma_kernel: the bf16 body on the tensor cores (see the note at the
// top).  Fragment layouts are those of mma.m16n8k16 (PTX ISA, "Matrix
// Fragments for mma.m16n8k16"): lane = 4 gid + tig; a C fragment holds rows
// gid and gid + 8 at columns 2 tig and 2 tig + 1 of an 8-column tile.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// the 4 accumulators of 8-column tile j in a flat fragment array
template <int N>
__device__ __forceinline__ float (&frag(float (&a)[N], int j))[4] {
  return *reinterpret_cast<float (*)[4]>(a + 4 * j);
}

// two f32 as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = hi + lo, both bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// The online softmax of one key tile on a warp's C fragments (rows wr +
// gid and wr + gid + 8, score columns 8 j + 2 tig + e of tile j): scale
// and masks, the row max over the quad, p = exp(x - m_new), l and m
// updated and the accumulators o rescaled by alpha = exp(m - m_new).
template <int NT, int NO>
__device__ __forceinline__ void tile_softmax(float (&sc)[NT * 4], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], const Shape& s, int kt, int row0,
                                             int tig, bool interior) {
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r + s.offset;
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * r + e] * s.scale;
        if (!interior) {
          const int key = kt + 8 * j + 2 * tig + e;
          bool valid = key < s.kv_valid;
          if (s.causal) valid = valid && key <= qpos;
          x = valid ? x : NEG;
        }
        sc[4 * j + 2 * r + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // keys past skv do not exist (the last tile's ragged end): p = 0
        const bool live = interior || kt + 8 * j + 2 * tig + e < s.skv;
        const float p = live ? expf(sc[4 * j + 2 * r + e] - m_new) : 0.0f;
        sc[4 * j + 2 * r + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    alpha[r] = expf(m[r] - m_new);
    l[r] = l[r] * alpha[r] + rs;
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int DB> struct MmaLayout {
  using L = Layout<bf16, DB>;
  static constexpr int RS = L::RS;                          // DB + 8
  static constexpr int BYTES = L::QBYTES + 4 * L::KBYTES;  // Q, K x 2, V x 2
};

template <int DB, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, Shape s) {
  constexpr int RS = MmaLayout<DB>::RS;
  constexpr int KS = DB / 16;    // k-steps of QK^T
  constexpr int NT = BKV / 8;    // 8-key score tiles of a warp
  constexpr int OT = DB / 8;     // 8-column output tiles of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + BQ * RS;       // two K tiles
  bf16* Vb = Kb + 2 * BKV * RS;  // two V tiles

  const int h = blockIdx.x % s.hq;
  const int bi = blockIdx.y;
  const int nqt = gridDim.x / s.hq;
  const int z = blockIdx.x / s.hq;
  const int qt = s.causal ? nqt - 1 - z : z;
  const int q0 = qt * BQ;
  const int kvh = h / (s.hq / s.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;      // the warp's first row in the tile

  const bf16* qb = q + bi * s.qsb + h * s.qsh;
  const bf16* kb = k + bi * s.ksb + kvh * s.ksh;
  const bf16* vb = v + bi * s.vsb + kvh * s.vsh;

  const int last_row = min(q0 + BQ, s.sq) - 1;
  const int qpos_min = q0 + s.offset;
  const int qpos_max = last_row + s.offset;
  const int nt = (s.skv + BKV - 1) / BKV;
  int lim = min(s.kv_valid, s.skv);
  if (s.causal) lim = min(lim, qpos_max + 1);
  const int first_masked = lim <= 0 ? 0 : min(nt, (lim + BKV - 1) / BKV);

  auto issue = [&](int t) {
    const int kt = t * BKV;
    stage<bf16, DB, VEC, BKV>(Kb + (t & 1) * BKV * RS, kb + kt * s.kss, s.kss, s.skv - kt,
                              s.dh, tid);
    stage<bf16, DB, VEC, BKV>(Vb + (t & 1) * BKV * RS, vb + kt * s.vss, s.vss, s.skv - kt,
                              s.dh, tid);
    if constexpr (VEC) cp_async_commit();
  };

  stage<bf16, DB, VEC, BQ>(Qs, qb + q0 * s.qss, s.qss, s.sq - q0, s.dh, tid);
  if constexpr (VEC) cp_async_commit();
  if (first_masked > 0) issue(0);
  else if constexpr (VEC) cp_async_commit();
  if constexpr (VEC) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();   // Q has landed
  // the warp's Q fragments: matrix i of k-step ks is rows wr + 8 (i & 1),
  // columns 16 ks + 8 (i >> 1)
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], Qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + ks * 16 +
                        (lane >> 4) * 8);

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float o[OT * 4];
#pragma unroll
  for (int j = 0; j < OT * 4; ++j) o[j] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    const int kt = t * BKV;
    if (t >= first_masked) {
      int finite = 1;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (q0 + wr + gid + 8 * r < s.sq && m[r] == NEG) finite = 0;
      if (__syncthreads_and(finite)) break;
      issue(t);   // not prefetched: its buffers were last read two tiles ago
    }
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();   // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < first_masked) issue(t + 1);
    const bf16* Ks = Kb + (t & 1) * BKV * RS;
    const bf16* Vs = Vb + (t & 1) * BKV * RS;

    // S = Q K^T: matrix i of a 16-key pair is keys 8 (i >> 1), columns
    // 8 (i & 1) of the k-step, so (r0, r1) and (r2, r3) are the b
    // fragments of the pair's two 8-key tiles
    float sc[NT * 4];
#pragma unroll
    for (int j = 0; j < NT * 4; ++j) sc[j] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * RS + ks * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(frag(sc, 2 * jp), qf[ks], b[0], b[1]);
        mma_bf16(frag(sc, 2 * jp + 1), qf[ks], b[2], b[3]);
      }

    const bool interior = kt + BKV <= s.kv_valid && kt + BKV <= s.skv &&
                          (!s.causal || kt + BKV - 1 <= qpos_min);
    tile_softmax<NT>(sc, o, m, l, s, kt, q0 + wr + gid, tig, interior);

    // O += P V, P = P_hi + P_lo: the C fragments of score tiles 2 kk and
    // 2 kk + 1 are the A fragment of keys 16 kk .. 16 kk + 15; matrix i of
    // a V load is keys 8 (i & 1), columns 8 (i >> 1) of a 16-column pair,
    // transposed into b fragments
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[8 * kk], sc[8 * kk + 1], hi[0], lo[0]);
      split_bf16(sc[8 * kk + 2], sc[8 * kk + 3], hi[1], lo[1]);
      split_bf16(sc[8 * kk + 4], sc[8 * kk + 5], hi[2], lo[2]);
      split_bf16(sc[8 * kk + 6], sc[8 * kk + 7], hi[3], lo[3]);
#pragma unroll
      for (int jp = 0; jp < OT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + jp * 16 +
                             (lane >> 4) * 8);
        mma_bf16(frag(o, 2 * jp), hi, b[0], b[1]);
        mma_bf16(frag(o, 2 * jp + 1), hi, b[2], b[3]);
        mma_bf16(frag(o, 2 * jp), lo, b[0], b[1]);
        mma_bf16(frag(o, 2 * jp + 1), lo, b[2], b[3]);
      }
    }
  }
  if constexpr (VEC) cp_async_wait_all();   // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gid + 8 * r;
    if (row >= s.sq) continue;
    const float safe = fmaxf(l[r], 1e-30f);
    const size_t at = ((size_t)(bi * s.hq + h) * s.sq + row);
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * tig + e;
        if (d < s.dh) put(out + at * s.dh + d, o[4 * j + 2 * r + e] / safe);
      }
    if (tig == 0) lse[at] = l[r] > 0.0f ? m[r] + logf(safe) : NEG;
  }
}

// the body of an instance: FP32 FMAs for f32 operands, tensor cores for bf16
template <typename T, int DB, bool VEC>
auto body() {
  if constexpr (std::is_same_v<T, float>) return flash_fwd_kernel<float, DB, VEC>;
  else return flash_mma_kernel<DB, VEC>;
}

template <typename T, int DB, bool VEC>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           const Shape& s, cudaStream_t st) {
  constexpr int smem = std::is_same_v<T, float> ? Layout<T, DB>::BYTES : MmaLayout<DB>::BYTES;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        body<T, DB, VEC>(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid(s.hq * ((s.sq + BQ - 1) / BQ), b);
  const auto kernel = body<T, DB, VEC>();
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_bucket(const void* q, const void* k, const void* v, void* out, float* lse,
                  int b, const Shape& s, cudaStream_t st) {
  if (s.dh <= 32) return launch<T, 32, VEC>(q, k, v, out, lse, b, s, st);
  if (s.dh <= 64) return launch<T, 64, VEC>(q, k, v, out, lse, b, s, st);
  return launch<T, 128, VEC>(q, k, v, out, lse, b, s, st);
}

template <typename T>
bool aligned16(const void* p, long long a, long long b, long long c, int dh) {
  constexpr int ve = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && a % ve == 0 && b % ve == 0 &&
         c % ve == 0 && dh % ve == 0;
}

}  // namespace

extern "C" {

// dtype 0: float32 operands and output; 1: bfloat16.  Strides in elements,
// head dimension contiguous; out and lse contiguous.  dh <= 128, hq % hkv
// == 0, b <= 65535 (the wrapper checks).  vec 1 asks for
// the cp.async instantiation: every operand's base and (batch, head,
// position) strides and dh must then keep rows 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, int b, int hq, int hkv, int sq, int skv, int dh,
                           int causal, int offset, int kv_valid, float scale,
                           long long qsb, long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb, long long vsh,
                           long long vss, int dtype, int vec, void* stream) {
  if (dh < 1 || dh > DMAX || hkv < 1 || hq % hkv != 0 || b > 65535 ||
      (long long)hq * ((sq + BQ - 1) / BQ) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{hq, hkv, sq, skv, dh, causal, offset, kv_valid, scale,
                qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!vec) return launch_bucket<float, false>(q, k, v, out, lse, b, s, st);
    if (!aligned16<float>(q, qsb, qsh, qss, dh) || !aligned16<float>(k, ksb, ksh, kss, dh) ||
        !aligned16<float>(v, vsb, vsh, vss, dh))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_bucket<float, true>(q, k, v, out, lse, b, s, st);
  }
  if (dtype == 1) {
    if (!vec) return launch_bucket<__nv_bfloat16, false>(q, k, v, out, lse, b, s, st);
    if (!aligned16<__nv_bfloat16>(q, qsb, qsh, qss, dh) ||
        !aligned16<__nv_bfloat16>(k, ksb, ksh, kss, dh) ||
        !aligned16<__nv_bfloat16>(v, vsb, vsh, vss, dh))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_bucket<__nv_bfloat16, true>(q, k, v, out, lse, b, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
