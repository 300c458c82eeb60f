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
// quirks included (ROADMAP.md section 3).
//
// Bound on the H100: operations.  At the prefill shape (1, 32, 8192, 128)
// the causal half of QK^T and PV is 4 b hq dh s^2 / 2 = 5.5e11 FP32
// operations (8.2 ms at 67 TFLOP/s) against ~0.3 GB of operands (0.09 ms).
// The design keeps the score tile out of device memory (online softmax, as
// the TPU kernel does) and feeds the FMA units from shared memory through
// register micro-tiles: per k-step a thread reads 4 query and 4 key values
// for 16 FMAs (QK^T), per key 4 probabilities and 8 values for 32 FMAs (PV).
// Key tiles wholly above the diagonal or past kv_valid are skipped once
// every row of the CTA has a finite running max: there p = exp(-1e30 - m)
// = 0 and alpha = 1 exactly, so skipping changes nothing.  A row with no
// valid key yet takes p = exp(0) = 1 per masked key, as the Pallas body
// does, so such tiles are never skipped.  IEEE f32 throughout (expf, logf,
// true division), no tensor cores: wgmma / TMA / bf16 MMA are a later step.
//
// Layout: one CTA of 256 threads per (64-row query tile, q-head, batch).
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4),
// score columns tx + 16 j (j < 4) and output columns tx + 16 j (j < 8), so
// a row's 16 owners are one half-warp and its max / sum reduce by xor
// shuffles.  Shared memory (dynamic, 99,840 bytes at dh = 128, so two CTAs
// fit on an SM): the query tile (row stride dh + 4), the key tile
// transposed (dh x 65; the probability tile reuses it once the scores are
// formed) and the value tile (64 x dh).  Operands are converted to f32 as
// they are staged.  GQA: q-head h reads kv-head h / (hq / hkv); no head is
// replicated.  q, k, v may be strided over (batch, head, position); the
// head dimension must be contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BKV = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int RM = 4;            // rows per thread
constexpr int CM = 4;            // score columns per thread
constexpr int DMAX = 128;
constexpr int DJ = DMAX / 16;    // output columns per thread
constexpr int KT_STRIDE = BKV + 1;
constexpr float NEG = -1.0e30f;  // the reference's sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Shape {
  int hq, hkv, sq, skv, dh, causal, offset, kv_valid;
  float scale;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
};

__host__ __device__ inline int q_stride(int dh) { return dh + 4; }
__host__ __device__ inline int kt_rows(int dh) { return dh > BQ ? dh : BQ; }

size_t smem_bytes(int dh) {
  return sizeof(float) *
         ((size_t)BQ * q_stride(dh) + (size_t)kt_rows(dh) * KT_STRIDE + (size_t)BKV * dh);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Shape s) {
  extern __shared__ float smem[];
  const int dh = s.dh;
  const int qs = q_stride(dh);
  float* Qs = smem;                              // BQ x qs
  float* Kt = Qs + BQ * qs;                      // dh x KT_STRIDE
  float* Ps = Kt;                                // BQ x KT_STRIDE (aliases Kt)
  float* Vs = Kt + kt_rows(dh) * KT_STRIDE;      // BKV x dh

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (s.hq / s.hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  const T* qb = q + bi * s.qsb + h * s.qsh;
  const T* kb = k + bi * s.ksb + kvh * s.ksh;
  const T* vb = v + bi * s.vsb + kvh * s.vsh;

  for (int e = tid; e < BQ * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    const int row = q0 + r;
    Qs[r * qs + d] = row < s.sq ? to_f32(qb[row * s.qss + d]) : 0.0f;
  }

  float m[RM], l[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  // rows past sq are never stored; count them as finite for the skip test
  const int last_row = min(q0 + BQ, s.sq) - 1;
  const int qpos_max = last_row + s.offset;

  for (int kt = 0; kt < s.skv; kt += BKV) {
    const bool tile_masked = kt >= s.kv_valid || (s.causal && kt > qpos_max);
    if (tile_masked) {
      // masks are monotone in the key position: every later tile is masked
      // too, and with a finite max it adds exactly nothing
      int finite = 1;
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (q0 + ty + 16 * i < s.sq && m[i] == NEG) finite = 0;
      if (__syncthreads_and(finite)) break;
    }
    __syncthreads();   // the previous tile's Ps / Vs reads are done
    for (int e = tid; e < BKV * dh; e += THREADS) {
      const int c = e / dh, d = e - c * dh;
      const int key = kt + c;
      float kv = 0.0f, vv = 0.0f;
      if (key < s.skv) {
        kv = to_f32(kb[key * s.kss + d]);
        vv = to_f32(vb[key * s.vss + d]);
      }
      Kt[d * KT_STRIDE + c] = kv;
      Vs[c * dh + d] = vv;
    }
    __syncthreads();

    float sc[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float a[RM], b[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty + 16 * i) * qs + d];
#pragma unroll
      for (int j = 0; j < CM; ++j) b[j] = Kt[d * KT_STRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

    float p[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i + s.offset;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int key = kt + tx + 16 * j;
        bool valid = key < s.kv_valid;
        if (s.causal) valid = valid && key <= qpos;
        sc[i][j] = valid ? sc[i][j] * s.scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        // keys past skv do not exist (the last tile's ragged end): p = 0
        p[i][j] = kt + tx + 16 * j < s.skv ? expf(sc[i][j] - m_new) : 0.0f;
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done reading Kt
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) Ps[(ty + 16 * i) * KT_STRIDE + tx + 16 * j] = p[i][j];
    __syncthreads();

    const int nkeys = min(BKV, s.skv - kt);
    for (int c = 0; c < nkeys; ++c) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty + 16 * i) * KT_STRIDE + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < dh) {
          const float vv = Vs[c * dh + d];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s.sq) continue;
    const float safe = fmaxf(l[i], 1e-30f);
    const size_t o = ((size_t)(bi * s.hq + h) * s.sq + row);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) put(out + o * dh + d, acc[i][j] / safe);
    }
    if (tx == 0) lse[o] = l[i] > 0.0f ? m[i] + logf(safe) : NEG;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes(s.dh);
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((s.sq + BQ - 1) / BQ, s.hq, b);
  flash_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: float32 operands and output; 1: bfloat16.  Strides in elements,
// head dimension contiguous; out and lse contiguous.  dh <= 128, hq % hkv
// == 0 (the wrapper checks).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, int b, int hq, int hkv, int sq, int skv, int dh,
                           int causal, int offset, int kv_valid, float scale,
                           long long qsb, long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb, long long vsh,
                           long long vss, int dtype, void* stream) {
  if (dh < 1 || dh > DMAX || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{hq, hkv, sq, skv, dh, causal, offset, kv_valid, scale,
                qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, lse, b, s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, lse, b, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
