// Level-1 KDE estimates of decode attention mass per key block (block lse).
//
// kde_block_lse_launch replaces
//     src/repro/kernels/kde_attention/kernel.py:block_lse_pallas
//     (body _block_lse_kernel)
//   q (b, hq, dh), k (b, hkv, S, dh) f32 -> out (b, hq, S / bk) f32
//   out[b, h, j] = log(stride * sum_{i < ceil(bk / stride)}
//                      exp(q_h . k[j bk + i stride] * scale))
// with positions >= kv_valid at -1e30 before the max, as the Pallas body:
// the dot products in f32, then the mask, then the max m, then
// m + log(max(sum exp(s - m), 1e-30)) + log(stride).  A block with no valid
// key comes out at -1e30 exactly.
//
// Bound on the H100: bytes.  Only the strided keys are read:
// b hkv (S / stride) dh 4 bytes, plus q and the (b, hq, S / bk) output; at
// the serve shape (b = 4, hkv = 4, S = 544, stride 4, dh = 128) that is 1.1
// MB (0.3 us at 3.35 TB/s), so a launch costs more than the work.  The
// design reads each strided key row once per CTA from device memory: one
// CTA per (key block, kv-head, batch) holds the whole GQA group, one warp
// per q-head (at most 8 warps, looping over larger groups), and the
// group's warps read the same 512-byte rows (coalesced across the warp;
// the repeats hit L1).  A warp keeps its q-head's vector in
// registers (dims lane + 32 t), reduces each dot product by xor shuffles,
// parks the block's scores in shared memory and then takes the max and the
// sum over them in a fixed order.  IEEE f32 (expf, logf), no fast-math.
// kv_valid is a runtime argument: one build serves every decode step.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int DMAX = 128;
constexpr int DT = DMAX / 32;    // q dims per lane
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
block_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 float* __restrict__ out, int hq, int hkv, int nb, int dh, int bk,
                 int stride, int kv_valid, float scale, float log_stride,
                 long long qsb, long long qsh, long long ksb, long long ksh,
                 long long kss) {
  extern __shared__ float scores[];          // (warps of the CTA) x nk
  const int j = blockIdx.x;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nk = (bk + stride - 1) / stride;
  float* my = scores + warp * nk;
  const float* kb = k + bi * ksb + kvh * ksh;

  for (int hl = warp; hl < group; hl += nwarps) {
    const int h = kvh * group + hl;
    const float* qr = q + bi * qsb + h * qsh;
    float qv[DT];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = lane + 32 * t;
      qv[t] = d < dh ? qr[d] : 0.0f;
    }
    for (int i = 0; i < nk; ++i) {
      const int pos = j * bk + i * stride;
      const float* kr = kb + pos * kss;
      float part = 0.0f;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) part = fmaf(qv[t], __ldg(kr + d), part);
      }
      const float dot = warp_sum(part);
      if (lane == 0) my[i] = pos < kv_valid ? dot * scale : NEG;
    }
    __syncwarp();
    float mx = NEG;
    for (int i = lane; i < nk; i += 32) mx = fmaxf(mx, my[i]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int i = lane; i < nk; i += 32) sum += expf(my[i] - mx);
    sum = warp_sum(sum);
    if (lane == 0)
      out[((size_t)bi * hq + h) * nb + j] = mx + logf(fmaxf(sum, 1e-30f)) + log_stride;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// q strided over (batch, head), k over (batch, head, position); the head
// dimension contiguous; out contiguous.  dh <= 128, hq % hkv == 0, S a
// multiple of bk (nb = S / bk blocks); the wrapper checks.
int kde_block_lse_launch(const float* q, const float* k, float* out, int b, int hq,
                         int hkv, int nb, int dh, int bk, int stride, int kv_valid,
                         float scale, float log_stride, long long qsb, long long qsh,
                         long long ksb, long long ksh, long long kss, void* stream) {
  if (dh < 1 || dh > DMAX || hkv < 1 || hq % hkv != 0 || bk < 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nk = (bk + stride - 1) / stride;
  const int warps = hq / hkv < WARPS ? hq / hkv : WARPS;    // one warp per q-head of the group
  const size_t smem = sizeof(float) * (size_t)warps * nk;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, hkv, b);
  block_lse_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, out, hq, hkv, nb, dh, bk, stride, kv_valid, scale, log_stride, qsb, qsh, ksb,
      ksh, kss);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
