// KDE decode attention: the whole decode pipeline of one step and one layer
// in one launch, by one of two kernels the plan picks by shape: a cluster
// of up to 8 CTAs per (batch, kv-head) (kde_decode_kernel, the serve
// shape) or the grid spread over every SM (kde_spread_kernel, long caches
// at small batch).
//
// kde_decode_launch replaces
//     src/repro/kernels/kde_attention/kernel.py:block_lse_pallas
//     (body _block_lse_kernel) and the jnp steps around it
//     (src/repro/kernels/kde_attention/ops.py:kde_attention)
// Step 1 is block_lse_pallas's function: for each (batch, q-head, key block
// of bk), out[b, h, j] = log(stride * sum_{i < ceil(bk / stride)}
// exp(q_h . k[j bk + i stride] * scale)), positions >= kv_valid at -1e30
// before the max, as the Pallas body: the dot products in f32, then the
// mask, then the max m, then m + log(max(sum exp(s - m), 1e-30)) +
// log(stride).  A block with no valid key comes out at -1e30 exactly.
//
// Operands: q in f32 or bf16, the cache (k and v together) in f32 or bf16;
// out in q's dtype.  The reference casts q and the keys to f32 inside its
// kernel (kernel.py:30-31) and the gathered keys and values in its ops
// (ops.py:68-74), and returns out.astype(q.dtype) (:87).  Here a bf16 value
// becomes f32 exactly where a row is loaded (its 16 bits shifted up), so
// every instance runs the f32 instance's arithmetic on the upcast values and
// a bf16 out is the f32 result rounded to nearest even: bitwise
// round(kde_decode(q.float(), k.float(), v.float())), and est bitwise the
// f32 instance's.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 128;
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

// an operand element as f32: a bf16 pattern is the high half of its f32
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

}  // namespace

// ---------------------------------------------------------------------------
// kde_decode_launch: the reference's whole kde_attention for one decode step
// and one layer:
//   q (b, hq, dh), k / v (b, hkv, S, dh) -> out (b, hq, dh) in q's dtype
//   (1) est (b, hq, nb) f32: block_lse_pallas's function, as above;
//   (2) the GQA group consensus est_kv[j] = lse over the group's q-heads of
//       est[h, j] (max, then the sum of exp in head order), then the top P =
//       min(top_p, nb) blocks of est_kv: the larger value first, ties to the
//       lower block index (lax.top_k's order);
//   (3) exact attention of the group's q-heads over the P bk gathered keys:
//       a key at or past kv_valid scores -1e30 and its value is zero, the
//       max m is taken over the selected keys only, p = exp(s - m),
//       l = sum p, o = sum p v / max(l, 1e-30);
//   (4) the residual correction: out = o * l / max(l + r, 1e-30) with
//       r = sum_j exp((j selected ? -1e30 : est[h, j]) - m).
// est is written to the optional est pointer (null on the decode path), so
// checks can hold step 1 against block_lse_plain.
//
// Bound on the H100: bytes -- the strided keys below kv_valid once per
// kv-head, less those of the selected blocks (read again as gathered keys),
// and the gathered keys and values below kv_valid (b hkv P bk dh 4 bytes
// each at most, 2 in bf16); at the serve shape (b 4, hkv 4, S 544, dh 128, bk 32,
// stride 4, top_p 4) about 3.1 MB, 0.9 us at 3.35 TB/s.  The cost to beat
// is not the bytes but the ~25 eager torch ops per layer that steps 2-4
// took, each a launch from the host; on the card the time is a chain of
// latencies (loads, barriers), so the design keeps the chain short:
//
// * One thread-block cluster of C CTAs (2-8, enough to cover the SMs) per
//   (batch, kv-head).  CTA c owns blocks [c nbc, (c + 1) nbc) and computes
//   their estimates into its shared memory, a window of whole blocks at a
//   time (64 strided rows, or one block's when it has more): the rows are
//   staged 64 at a time (every load of a chunk in flight before the first
//   store; rows at or past kv_valid are not read), a thread per (q-head,
//   key) runs the dot product with 16-byte shared loads into four partial
//   sums (row stride an odd number of 16-byte units, so a quarter-warp's 8
//   rows hit 8 bank groups), and a thread per (q-head, block) takes the
//   max and the sum of exp once the window's scores are in.
// * The selection, without gathering the estimates: each CTA forms the
//   group consensus of its own blocks and ranks them within its slice (the
//   count of blocks that come first: a larger value, or an equal one at a
//   lower index), which sorts its local top P into a candidate list.  The
//   global top P lies in the union of the lists.  After a cluster barrier
//   each candidate's global rank is its local rank plus, for every other
//   CTA, a binary search of that CTA's sorted list through distributed
//   shared memory (cluster.map_shared_rank); a candidate of rank R < P is
//   selected and stored, as the R-th selected block, into the shared
//   memory of the CTAs whose key range covers it.
// * The CTAs split the P bk selected keys into contiguous ranges and run
//   flash-decode over them: keys and values of a chunk are staged
//   together, and each CTA keeps a running max m_c, l_c and the p v sums
//   acc_c of its group's q-heads (a thread per (head, 4 dims) in PV).
//   Before that each CTA sums the residual of its own unselected blocks as
//   (mu_c, r_c): their max estimate and sum exp(est - mu_c).  After a
//   barrier every CTA reads all (m_c, l_c, mu_c, r_c) through DSMEM, takes
//   m = max_c m_c (the max over all selected keys), w_c = exp(m_c - m),
//   l = sum_c w_c l_c and r = sum_c r_c exp(mu_c - m), and the CTAs split
//   the output: out = sum_c w_c acc_c / l times l / (l + r), each sum in a
//   fixed order (rank order, a fixed shuffle tree: the result does not
//   depend on scheduling).  exp(s - m_c) exp(m_c - m) is exp(s - m) to a
//   few ulp, and so for the residual.
// Shared memory per CTA is a fixed part (the q-heads, a chunk of key and
// value rows, a window of scores, the accumulators: ~78 KB at g = 8, dh =
// 128) plus g + 2 words per own block and the candidate and selection
// lists.  The launch takes the smallest C >= the SM-covering one whose
// carve-up fits 227 KB; where none of 2-8 does (about 980k keys at bk 32,
// g 8, dh 128) the plan takes the spread kernel.  Four cluster barriers in
// all, the last one only so that
// no CTA leaves while another reads its shared memory.  kv_valid is a
// runtime argument: one build serves every decode step.  IEEE f32 (expf,
// logf, true division), no fast-math.
namespace {

namespace cg = cooperative_groups;

constexpr int DK_THREADS = 256;
constexpr int DK_WARPS = DK_THREADS / 32;
constexpr int KCH = 64;            // key rows staged per chunk
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA may take

struct Decode {
  const void* q;      // TQ
  const void* k;      // TKV
  const void* v;      // TKV
  void* out;          // TQ
  float* est;
  int hq, hkv, nb, dh, bk, stride, P, kv_valid;
  int g, nk, C, nbc, kc, ks, d4, bpw, scw, ncand, nsel;
  float scale, log_stride;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
};

// the next array of a carve-up at word offset o, 16-byte aligned
__host__ __device__ inline int take(int& o, int words) {
  const int at = o;
  o += (words + 3) & ~3;
  return at;
}

// shared-memory carve-up, in 4-byte words, the same on host and device
struct Carve {
  int qs, kr, vr, sc, est_l, ekv, chosen, cv, ci, cnt, sel, mc, lc, al, mu, rr, wc, lh, rh,
      acc, total;
  __host__ __device__ explicit Carve(const Decode& a) {
    int o = 0;
    qs = take(o, a.g * a.ks);                 // the group's q-heads
    kr = take(o, KCH * a.ks);                 // staged key rows
    vr = take(o, KCH * a.ks);                 // staged value rows
    sc = take(o, a.g * a.scw);                // a window's scores, then p
    est_l = take(o, a.g * a.nbc);             // this CTA's estimates
    ekv = take(o, a.nbc);                     // their group consensus
    chosen = take(o, a.nbc);                  // selected-block flags
    cv = take(o, a.ncand);                    // candidate list: values,
    ci = take(o, a.ncand);                    // block indices,
    cnt = take(o, a.ncand);                   // entries of other CTAs first
    sel = take(o, a.nsel);                    // selected blocks of my keys
    mc = take(o, a.g);                        // running max of this CTA's keys
    lc = take(o, a.g);                        // running sum of p
    al = take(o, a.g);                        // a chunk's rescale factor
    mu = take(o, a.g);                        // max est of own unselected blocks
    rr = take(o, a.g);                        // their sum of exp(est - mu)
    wc = take(o, MAX_CLUSTER * a.g);          // exp(m_c - m) per CTA and head
    lh = take(o, a.g);                        // l over all selected keys
    rh = take(o, a.g);                        // residual mass
    acc = take(o, a.g * 4 * a.d4);            // this CTA's sum of p v
    total = o;
  }
};

// Stage rows [c0, c0 + nr) of a CTA's key list: the key rows into kr and,
// with V, the value rows into vr, as f32.  Warp w takes rows w + 8 i, lane l
// dims l + 32 t; every load of the chunk is issued before the first store.
// row_pos maps a list index to its cache position, or -1 for a zero row;
// dims [dh, 4 d4) are zero.
template <bool V, typename TKV, typename RowPos>
__device__ __forceinline__ void stage_rows(float* kr, float* vr, const TKV* __restrict__ kb,
                                           const TKV* __restrict__ vb, const Decode& a,
                                           int c0, int nr, RowPos row_pos) {
  constexpr int RPW = KCH / DK_WARPS, DPL = DMAX / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float bk_[RPW][DPL], bv_[V ? RPW : 1][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + DK_WARPS * i;
    const int pos = r < nr ? row_pos(c0 + r) : -1;
    const long long at = pos < 0 ? 0 : pos;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      const bool ok = pos >= 0 && d < a.dh;
      bk_[i][t] = ok ? load_f32(kb + at * a.kss + d) : 0.0f;
      if constexpr (V) bv_[i][t] = ok ? load_f32(vb + at * a.vss + d) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + DK_WARPS * i;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (r < nr && d < 4 * a.d4) {
        kr[r * a.ks + d] = bk_[i][t];
        if constexpr (V) vr[r * a.ks + d] = bv_[i][t];
      }
    }
  }
}

// scores of staged key rows [0, nr) (list indices c0 + e) against the
// group's q-heads: sc[h * scs + col + e] = dot * scale, or -1e30 where
// valid(c0 + e) is false.  A thread per (head, key) pair, consecutive keys
// on consecutive lanes; the dot product runs in 16-byte shared loads into
// four partial sums.
template <typename Valid>
__device__ __forceinline__ void score_rows(float* sc, int scs, int col, const float* qs,
                                           const float* kr, int c0, int nr, const Decode& a,
                                           Valid valid) {
  for (int pp = threadIdx.x; pp < nr * a.g; pp += DK_THREADS) {
    const int h = pp / nr, e = pp - h * nr;
    const float4* kv = reinterpret_cast<const float4*>(kr + e * a.ks);
    const float4* qv = reinterpret_cast<const float4*>(qs + h * a.ks);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
    for (int c = 0; c < a.d4; ++c) {
      const float4 x = kv[c], y = qv[c];
      s0 = fmaf(y.x, x.x, s0);
      s1 = fmaf(y.y, x.y, s1);
      s2 = fmaf(y.z, x.z, s2);
      s3 = fmaf(y.w, x.w, s3);
    }
    const float dot = (s0 + s1) + (s2 + s3);
    sc[h * scs + col + e] = valid(c0 + e) ? dot * a.scale : NEG;
  }
}

// the number of blocks CTA c owns, and the length of its candidate list
__device__ __forceinline__ int own_blocks(const Decode& a, int c) {
  return max(0, min(a.nb - c * a.nbc, a.nbc));
}

// two CTAs per SM (at most 128 registers a thread), so at the serve shape
// every cluster of a launch is resident at once.  TQ: q and out; TKV: k and
// v (float or __nv_bfloat16 each).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(DK_THREADS, 2)
kde_decode_kernel(Decode a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const Carve cv(a);
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = a.g, dh = a.dh, ks = a.ks, w4 = 4 * a.d4;
  float* qs = sm + cv.qs;
  float* kr = sm + cv.kr;
  float* vr = sm + cv.vr;
  float* sc = sm + cv.sc;
  float* est_l = sm + cv.est_l;
  float* ekv = sm + cv.ekv;
  int* chosen = reinterpret_cast<int*>(sm + cv.chosen);
  float* cand_v = sm + cv.cv;
  int* cand_i = reinterpret_cast<int*>(sm + cv.ci);
  int* cnt = reinterpret_cast<int*>(sm + cv.cnt);
  int* sel = reinterpret_cast<int*>(sm + cv.sel);
  float* mc = sm + cv.mc;
  float* lc = sm + cv.lc;
  float* al = sm + cv.al;
  float* mu = sm + cv.mu;
  float* rr = sm + cv.rr;
  float* wc = sm + cv.wc;
  float* lh = sm + cv.lh;
  float* rh = sm + cv.rh;
  float* acc = sm + cv.acc;
  const TKV* kb = static_cast<const TKV*>(a.k) + bi * a.ksb + kvh * a.ksh;
  const TKV* vb = static_cast<const TKV*>(a.v) + bi * a.vsb + kvh * a.vsh;
  const int j0 = rank * a.nbc;
  const int nbl = own_blocks(a, rank);

  for (int h = warp; h < g; h += DK_WARPS) {
    const TQ* qr = static_cast<const TQ*>(a.q) + bi * a.qsb + (long long)(kvh * g + h) * a.qsh;
    float x[DMAX / 32];
#pragma unroll
    for (int t = 0; t < DMAX / 32; ++t)
      x[t] = lane + 32 * t < dh ? load_f32(qr + lane + 32 * t) : 0.0f;
#pragma unroll
    for (int t = 0; t < DMAX / 32; ++t)
      if (lane + 32 * t < w4) qs[h * ks + lane + 32 * t] = x[t];
  }
  // lists other CTAs write into after barrier (A) start defined: a block
  // index that is always in range, and no selection
  for (int i = tid; i < a.nbc; i += DK_THREADS) chosen[i] = 0;
  for (int i = tid; i < a.ncand; i += DK_THREADS) {
    cand_v[i] = NEG;
    cand_i[i] = j0;
    cnt[i] = 0;
  }
  for (int i = tid; i < a.nsel; i += DK_THREADS) sel[i] = 0;

  // (1) the estimates of blocks [j0, j0 + nbl), a window of whole blocks
  // at a time: list index kl is strided row kl % nk of own block kl / nk
  auto strided_pos = [&](int kl) {
    const int jl = kl / a.nk;
    return (j0 + jl) * a.bk + (kl - jl * a.nk) * a.stride;
  };
  auto strided_live = [&](int kl) {   // -1: at or past kv_valid (not read)
    const int pos = strided_pos(kl);
    return pos < a.kv_valid ? pos : -1;
  };
  for (int w0 = 0; w0 < nbl; w0 += a.bpw) {
    const int nwb = min(a.bpw, nbl - w0), n = nwb * a.nk, base = w0 * a.nk;
    for (int c0 = 0; c0 < n; c0 += KCH) {
      const int nr = min(KCH, n - c0);
      __syncthreads();   // the previous chunk's rows and window's scores are consumed
      stage_rows<false>(kr, vr, kb, vb, a, base + c0, nr, strided_live);
      __syncthreads();
      score_rows(sc, a.scw, c0, qs, kr, base + c0, nr, a,
                 [&](int kl) { return strided_pos(kl) < a.kv_valid; });
    }
    __syncthreads();
    for (int pr = tid; pr < g * nwb; pr += DK_THREADS) {   // a thread per (head, block)
      const int h = pr / nwb, jw = pr - h * nwb;
      const float* s = sc + h * a.scw + jw * a.nk;
      float mx = NEG;
      for (int i = 0; i < a.nk; ++i) mx = fmaxf(mx, s[i]);
      float sum = 0.0f;
      for (int i = 0; i < a.nk; ++i) sum += expf(s[i] - mx);
      const float e = mx + logf(fmaxf(sum, 1e-30f)) + a.log_stride;
      est_l[h * a.nbc + w0 + jw] = e;
      if (a.est) a.est[((size_t)bi * a.hq + kvh * g + h) * a.nb + j0 + w0 + jw] = e;
    }
  }
  __syncthreads();

  // (2) the group consensus of own blocks, then their rank within the
  // slice: the local top P, sorted, is this CTA's candidate list
  for (int jl = tid; jl < nbl; jl += DK_THREADS) {
    float m = est_l[jl];
    for (int h = 1; h < g; ++h) m = fmaxf(m, est_l[h * a.nbc + jl]);
    float sum = 0.0f;
    for (int h = 0; h < g; ++h) sum += expf(est_l[h * a.nbc + jl] - m);
    ekv[jl] = m + logf(fmaxf(sum, 1e-30f));
  }
  __syncthreads();
  for (int jl = tid; jl < nbl; jl += DK_THREADS) {
    const float x = ekv[jl];
    int before = 0;
    for (int i = 0; i < nbl && before < a.P; ++i) {
      const float y = ekv[i];
      before += y > x || (y == x && i < jl);
    }
    if (before < a.P) {
      cand_v[before] = x;
      cand_i[before] = j0 + jl;
    }
  }
  cluster.sync();   // (A) every CTA's candidate list is in its shared memory

  // each candidate's global rank: its local rank plus, per other CTA, the
  // length of the prefix of that CTA's sorted list that comes first
  const int ncl = min(a.P, nbl);
  for (int pr = tid; pr < ncl * a.C; pr += DK_THREADS) {
    const int kk = pr / a.C, c = pr - kk * a.C;
    if (c == rank) continue;
    const float x = cand_v[kk];
    const int j = cand_i[kk];
    const float* rv = cluster.map_shared_rank(cand_v, c);
    const int* ri = cluster.map_shared_rank(cand_i, c);
    int lo = 0, hi = min(a.P, own_blocks(a, c));
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float y = rv[mid];
      if (y > x || (y == x && ri[mid] < j)) lo = mid + 1;
      else hi = mid;
    }
    atomicAdd(cnt + kk, lo);
  }
  __syncthreads();
  // a selected block goes, as entry R of the selection, to every CTA whose
  // key range [c kc, (c + 1) kc) meets [R bk, (R + 1) bk)
  for (int kk = tid; kk < ncl; kk += DK_THREADS) {
    const int R = kk + cnt[kk];
    if (R >= a.P) continue;
    const int j = cand_i[kk];
    chosen[j - j0] = 1;
    const int c_hi = min(a.C - 1, ((R + 1) * a.bk - 1) / a.kc);
    for (int c = R * a.bk / a.kc; c <= c_hi; ++c)
      cluster.map_shared_rank(sel, c)[R - c * a.kc / a.bk] = j;
  }
  __syncthreads();
  // the residual of own unselected blocks per head, as (mu, r)
  for (int h = warp; h < g; h += DK_WARPS) {
    const float* e = est_l + h * a.nbc;
    float mx = -INFINITY;
    for (int jl = lane; jl < nbl; jl += 32)
      if (!chosen[jl]) mx = fmaxf(mx, e[jl]);
    mx = warp_max(mx);
    float r = 0.0f;
    if (mx != -INFINITY) {
      for (int jl = lane; jl < nbl; jl += 32)
        if (!chosen[jl]) r += expf(e[jl] - mx);
      r = warp_sum(r);
    }
    if (lane == 0) {
      mu[h] = mx == -INFINITY ? NEG : mx;
      rr[h] = r;
    }
  }
  for (int h = tid; h < g; h += DK_THREADS) {
    mc[h] = -INFINITY;
    lc[h] = 0.0f;
  }
  for (int pr = tid; pr < g * w4; pr += DK_THREADS) acc[pr] = 0.0f;
  cluster.sync();   // (A2) every CTA's selection entries are in place

  // (3) flash-decode over this CTA's share of the P bk selected keys
  const int e0 = rank * a.kc;
  const int p0 = e0 / a.bk;           // sel[i] is selected block p0 + i
  const int n3 = max(0, min(a.P * a.bk - e0, a.kc));
  auto sel_pos = [&](int el) {
    const int e = e0 + el, p = e / a.bk;
    return sel[p - p0] * a.bk + (e - p * a.bk);
  };
  auto live_pos = [&](int el) {       // -1: a key at or past kv_valid (zero row)
    const int pos = sel_pos(el);
    return pos < a.kv_valid ? pos : -1;
  };
  for (int c0 = 0; c0 < n3; c0 += KCH) {
    const int nr = min(KCH, n3 - c0);
    __syncthreads();   // the previous chunk is consumed
    stage_rows<true>(kr, vr, kb, vb, a, c0, nr, live_pos);
    __syncthreads();
    score_rows(sc, KCH, 0, qs, kr, c0, nr, a,
               [&](int el) { return sel_pos(el) < a.kv_valid; });
    __syncthreads();
    for (int h = warp; h < g; h += DK_WARPS) {
      float* s = sc + h * KCH;
      float mx = -INFINITY;
      for (int i = lane; i < nr; i += 32) mx = fmaxf(mx, s[i]);
      mx = warp_max(mx);
      const float m_new = fmaxf(mc[h], mx);
      float sum = 0.0f;
      for (int i = lane; i < nr; i += 32) {
        const float p = expf(s[i] - m_new);
        s[i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(mc[h] - m_new);   // 0 on the first chunk
        al[h] = alpha;
        lc[h] = lc[h] * alpha + sum;
        mc[h] = m_new;
      }
    }
    __syncthreads();
    // a thread per (head, 4 dims): one 16-byte value load per 4 FMAs
    for (int pr = tid; pr < g * a.d4; pr += DK_THREADS) {
      const int h = pr / a.d4, c = pr - h * a.d4;
      float4* ac = reinterpret_cast<float4*>(acc + h * w4) + c;
      const float alpha = al[h];
      const float* ph = sc + h * KCH;
      float4 o = *ac;
      o.x *= alpha;
      o.y *= alpha;
      o.z *= alpha;
      o.w *= alpha;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float p = ph[r];
        const float4 x = reinterpret_cast<const float4*>(vr + r * ks)[c];
        o.x = fmaf(p, x.x, o.x);
        o.y = fmaf(p, x.y, o.y);
        o.z = fmaf(p, x.z, o.z);
        o.w = fmaf(p, x.w, o.w);
      }
      *ac = o;
    }
  }
  cluster.sync();   // (B) every CTA's (m_c, l_c, acc_c, mu_c, r_c) is published

  // (4) per head: m, the CTA weights, l and the residual mass
  for (int h = warp; h < g; h += DK_WARPS) {
    const bool in = lane < a.C;
    const float mr = in ? cluster.map_shared_rank(mc, lane)[h] : -INFINITY;
    const float lr = in ? cluster.map_shared_rank(lc, lane)[h] : 0.0f;
    const float mur = in ? cluster.map_shared_rank(mu, lane)[h] : NEG;
    const float rrr = in ? cluster.map_shared_rank(rr, lane)[h] : 0.0f;
    const float m = warp_max(mr);
    const float w = in ? expf(mr - m) : 0.0f;
    const float l = warp_sum(lr * w);
    const float rs = warp_sum(rrr > 0.0f ? rrr * expf(mur - m) : 0.0f);
    if (in) wc[lane * g + h] = w;
    if (lane == 0) {
      lh[h] = l;
      rh[h] = rs;
    }
  }
  __syncthreads();
  for (int pr = rank * DK_THREADS + tid; pr < g * dh; pr += a.C * DK_THREADS) {
    const int h = pr / dh, d = pr - h * dh;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < a.C) s = fmaf(cluster.map_shared_rank(acc, r)[h * w4 + d], wc[r * g + h], s);
    const float l = lh[h];
    const float o = s / fmaxf(l, 1e-30f);
    store_f32(static_cast<TQ*>(a.out) + ((size_t)bi * a.hq + kvh * g + h) * dh + d,
              o * (l / fmaxf(l + rh[h], 1e-30f)));
  }
  cluster.sync();   // (C) no CTA leaves while another reads its shared memory
}


// ---------------------------------------------------------------------------
// kde_spread_kernel: the same function, spread over the card.  The cluster
// design above gives a (batch, kv-head) at most 8 CTAs, so a launch at
// batch 1 with 4 kv-heads (the long_500k cell: S = 524,288, bk 512,
// stride 16, top_p 16) ran 32 CTAs on 132 SMs, each walking 4,096 strided
// rows through a serial stage -> barrier -> score -> barrier chain.  Bound
// there: bytes, about 50 MB (the 32,768 strided rows a kv-head and the
// 8,192 gathered keys and values, 2 bytes a value): 15 us at 3.35 TB/s.
// The plan takes this kernel when the cluster one would fill under half
// the SMs (b hkv <= 8 on the H100) or does not fit.  This design:
// * C = floor(SMs / (b hkv)) plain CTAs (at most 128) per (batch,
//   kv-head), one launch with the cooperative attribute, so every CTA of
//   the grid is resident at once (C = 33 there: 132 CTAs).  The
//   estimates, each CTA's top-P candidate list and its partial sums go
//   through a global scratch the wrapper allocates (torch.empty); the CTAs
//   of a (batch, kv-head) meet at two barriers on counters of a
//   per-stream int buffer, which the last CTA out leaves at 0.
// * Step 1, warps alone: warp w of CTA c takes blocks w, w + 8, ... of the
//   CTA's slice.  A row is 8 dims a lane (one 16-byte load of bf16, two of
//   f32), a half-warp a row, so a warp scores two rows at a time against
//   8 q-heads held in registers; a lane's 8 dot products are reduced over
//   its half-warp by a reduce-scatter butterfly (7 shuffles for 8 heads).
//   Rows load two batches ahead of the batch being scored, as raw 16-byte
//   words, and loads never sit behind a branch, so the shuffles stay in
//   converged code (the warp index comes through a shuffle for the same
//   reason).  A warp keeps a window of 64 rows' scores a head in shared
//   memory and reduces it over quads of lanes (max, then the sum of exp);
//   a block longer than the window folds its windows in order.
// * Step 2: each CTA forms the GQA consensus of its own blocks and ranks
//   them within its slice; its local top P, sorted, is its candidate list.
//   After the first barrier every CTA reads the C lists and warp 0 merges
//   them, a warp max and min reduction a step (the larger value, ties to
//   the lower block), so every CTA knows the same selection.
// * Step 3: CTA c takes keys [c kc, (c + 1) kc) of the P bk selected keys,
//   8 a warp at a time (4 a half-warp; bf16 rows load a batch ahead); a
//   warp keeps a running max and sum per head, rescaled once a batch, and
//   the p v sums of its 8 dims per lane; the warps' partials fold into
//   the CTA's (m_c, l_c, acc_c) in warp order.  The residual of own
//   unselected blocks is summed as (mu_c, r_c).
// * Step 4, after the second barrier: every CTA folds the C partials for
//   its slice of the g dh outputs, in CTA order: out = sum_c w_c acc_c / l
//   times l / (l + r).
// Every sum runs in a fixed order and no float atomic touches a result, so
// a bf16 instance is bitwise the f32 instance on the upcast inputs (the
// arithmetic after a load is the same code), and ties go to the lower
// block as lax.top_k's.  Shared memory is about 50 KB plus g + 2 words an
// own block and 2 C P words of lists, so a cache is refused only when that
// passes 227 KB (past about 4.7 million keys at bk 32, g 8, batch 1 with 4
// kv-heads).
constexpr int SP_THREADS = 256;
constexpr int SP_WARPS = SP_THREADS / 32;
constexpr int HP = 8;            // q-heads a pass
constexpr int SROWS = 64;        // scores a warp's window holds, a head
constexpr int U3 = 4;            // keys a half-warp loads a batch in step 3

struct Spread {
  const void* q;       // TQ
  const void* k;       // TKV
  const void* v;       // TKV
  void* out;           // TQ
  float* est;          // (b, hq, nb)
  float* cand;         // (b hkv, C, P) values, then (b hkv, C, P) indices
  float* part;         // (b hkv, C, 4 g + g dh): m, l, mu, r, acc
  int* sync;           // (b hkv, 3): two barrier counts, exits
  int hq, hkv, nb, dh, bk, stride, P, kv_valid;
  int g, nk, C, nbc, kc, nsel;
  float scale, log_stride;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
};

// shared memory of a spread CTA, in 4-byte words
struct SpreadCarve {
  int ws, wm, wl, wacc, est, ekv, chosen, sel, lv, li, wc, hl, hr, total;
  __host__ __device__ explicit SpreadCarve(const Spread& a) {
    int o = 0;
    ws = take(o, SP_WARPS * HP * SROWS);      // a window of scores a warp
    wm = take(o, SP_WARPS * HP);              // a warp's running max (step 3)
    wl = take(o, SP_WARPS * HP);              // and sum of p
    wacc = take(o, SP_WARPS * HP * DMAX);     // a warp's sums of p v
    est = take(o, a.g * a.nbc);               // estimates of own blocks
    ekv = take(o, a.nbc);                     // their consensus
    chosen = take(o, a.nbc);                  // own blocks selected
    sel = take(o, a.nsel);                    // selected blocks of my keys
    lv = take(o, a.C * a.P);                  // the group's candidate lists:
    li = take(o, a.C * a.P);                  // values, block indices
    wc = take(o, a.g * a.C);                  // step 4: exp(m_c - m),
    hl = take(o, a.g);                        // l and the residual mass
    hr = take(o, a.g);
    total = o;
  }
};

// The 8 dims [d0, d0 + 8) a lane holds of a row, as loaded: VEC, one
// 16-byte load of bf16 (two of f32); else 8 element loads.  Loads are
// never skipped by a branch (a dead row reads row 0, a lane past dh the
// last 8 dims) so the shuffles that follow stay in converged code; live
// selects zeros afterwards.
template <typename T, bool VEC> struct Row;
template <> struct Row<__nv_bfloat16, true> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int d0, int dh) {
    w = __ldg(reinterpret_cast<const uint4*>(row + min(d0, dh - 8)));
  }
  __device__ __forceinline__ void get(float (&x)[8], bool live) const {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = live ? __uint_as_float(u[e] << 16) : 0.0f;
      x[2 * e + 1] = live ? __uint_as_float(u[e] & 0xffff0000u) : 0.0f;
    }
  }
};
template <> struct Row<float, true> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* row, int d0, int dh) {
    const float4* p = reinterpret_cast<const float4*>(row + min(d0, dh - 8));
    a = __ldg(p);
    b = __ldg(p + 1);
  }
  __device__ __forceinline__ void get(float (&x)[8], bool live) const {
    const float y[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = live ? y[e] : 0.0f;
  }
};
template <typename T> struct Row<T, false> {
  float y[8];
  int d0, dh;
  __device__ __forceinline__ void load(const T* row, int d0_, int dh_) {
    d0 = d0_;
    dh = dh_;
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = load_f32(row + min(d0 + e, dh - 1));
  }
  __device__ __forceinline__ void get(float (&x)[8], bool live) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = live && d0 + e < dh ? y[e] : 0.0f;
  }
};

// the 8 dot products of a lane's dims, reduced over its half-warp: returns
// the full dot product of head (lane % 16) / 2 (the reduce-scatter keeps
// heads by lane bits 3, 2, 1; bit 0 sums the pair)
__device__ __forceinline__ float half_warp_dots(const float (&qr)[HP][8], const float (&x)[8],
                                                int lane) {
  float d[HP];
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(qr[h][e], x[e], s);
    d[h] = s;
  }
  const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float give = b3 ? d[i] : d[4 + i];
    w4[i] = (b3 ? d[4 + i] : d[i]) + __shfl_xor_sync(0xffffffffu, give, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float give = b2 ? w4[i] : w4[2 + i];
    w2[i] = (b2 ? w4[2 + i] : w4[i]) + __shfl_xor_sync(0xffffffffu, give, 4);
  }
  const float give = b1 ? w2[0] : w2[1];
  const float w1 = (b1 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, give, 2);
  return w1 + __shfl_xor_sync(0xffffffffu, w1, 1);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// (max, sum of exp(x - max)) of n scores x[r], r < n, over a quad of lanes
// (lane % 4 takes r = lane % 4, + 4, ...), in a fixed order
__device__ __forceinline__ void quad_lse(const float* x, int n, int lane, float& mx,
                                         float& sum) {
  mx = -INFINITY;
  for (int i = 0; i < (n + 3) / 4; ++i) {
    const int r = (lane & 3) + 4 * i;
    if (r < n) mx = fmaxf(mx, x[r]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  sum = 0.0f;
  for (int i = 0; i < (n + 3) / 4; ++i) {
    const int r = (lane & 3) + 4 * i;
    if (r < n) sum += expf(x[r] - mx);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
}

template <typename TQ, typename TKV, bool VEC>
__global__ void __launch_bounds__(SP_THREADS, 1)
kde_spread_kernel(Spread a) {
  extern __shared__ __align__(16) float sm[];
  const SpreadCarve cv(a);
  const int c = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int grp = bi * a.hkv + kvh;
  // the warp index through a shuffle: the compiler then knows it is the
  // same in every lane, so loops over a warp's batches hold converged
  // shuffles
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int hl = lane & 15, half = lane >> 4, d0 = 8 * hl;
  const bool in_dh = d0 < a.dh;
  const int g = a.g, dh = a.dh;
  float* ws = sm + cv.ws + warp * HP * SROWS;
  float* est_s = sm + cv.est;   // (g, nbc)
  float* ekv = sm + cv.ekv;
  int* chosen = reinterpret_cast<int*>(sm + cv.chosen);
  int* sel = reinterpret_cast<int*>(sm + cv.sel);
  const TKV* kb = static_cast<const TKV*>(a.k) + bi * a.ksb + kvh * a.ksh;
  const TKV* vb = static_cast<const TKV*>(a.v) + bi * a.vsb + kvh * a.vsh;
  const int j0 = c * a.nbc;
  const int nbl = max(0, min(a.nb - j0, a.nbc));
  float* est_g = a.est + ((size_t)bi * a.hq + kvh * g) * a.nb;   // (g, nb)
  const int PW = 4 * g + g * dh;
  float* part = a.part + ((size_t)grp * a.C + c) * PW;
  int* bar = a.sync + 3 * grp;
  const size_t groups = (size_t)gridDim.z * a.hkv;

  // the q-heads of a pass, 8 dims a lane (zeros past g and dh)
  float qr[HP][8];
  auto load_q = [&](int hp0) {
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      Row<TQ, false> r;
      r.load(static_cast<const TQ*>(a.q) + bi * a.qsb +
                 (long long)(kvh * g + min(hp0 + h, g - 1)) * a.qsh,
             d0, dh);
      r.get(qr[h], hp0 + h < g);
    }
  };

  // (1) the estimates of own blocks [j0, j0 + nbl), per pass of 8 q-heads:
  // warp w takes blocks w, w + 8, ...; a batch is RB rows of a block, U1
  // a half-warp, loaded two batches ahead of the one scored
  constexpr int U1 = VEC ? 16 / sizeof(TKV) : 4;
  constexpr int RB = 2 * U1;
  const int nbt = (a.nk + RB - 1) / RB;    // batches a block
  const int nwb = nbl > warp ? (nbl - 1 - warp) / SP_WARPS + 1 : 0;
  const int total = nwb * nbt;
  for (int hp0 = 0; hp0 < g; hp0 += HP) {
    load_q(hp0);
    float M = NEG, S = 0.0f;   // the running (max, sum) of head lane / 4 over a block
    Row<TKV, VEC> cur[U1], nxt[U1], nx2[U1];   // batches t, t + 1, t + 2
    auto load_batch = [&](int t, Row<TKV, VEC> (&x)[U1]) {
      const int jl = warp + SP_WARPS * (t / nbt), bt = t % nbt;
#pragma unroll
      for (int u = 0; u < U1; ++u) {
        const int i = bt * RB + 2 * u + half;
        const long long pos = (long long)(j0 + jl) * a.bk + (long long)i * a.stride;
        x[u].load(kb + (i < a.nk && pos < a.kv_valid ? pos : 0) * a.kss, d0, dh);
      }
    };
    if (total > 0) load_batch(0, cur);
    if (total > 1) load_batch(1, nxt);
    for (int t = 0; t < total; ++t) {
      if (t + 2 < total) load_batch(t + 2, nx2);
      const int jl = warp + SP_WARPS * (t / nbt), bt = t % nbt;
#pragma unroll
      for (int u = 0; u < U1; ++u) {
        const int i = bt * RB + 2 * u + half;
        const long long pos = (long long)(j0 + jl) * a.bk + (long long)i * a.stride;
        const bool live = i < a.nk && pos < a.kv_valid;
        float x[8];
        cur[u].get(x, live && in_dh);
        const float dot = half_warp_dots(qr, x, lane);
        if (!(hl & 1) && i < a.nk)
          ws[((hl >> 1) & 7) * SROWS + i % SROWS] = live ? dot * a.scale : NEG;
      }
#pragma unroll
      for (int u = 0; u < U1; ++u) {
        cur[u] = nxt[u];
        nxt[u] = nx2[u];
      }
      const int i_end = min(a.nk, (bt + 1) * RB);
      if (i_end % SROWS != 0 && i_end != a.nk) continue;   // the window goes on
      __syncwarp();
      // fold the window [w0, i_end) of each head: lane l reduces head l / 4
      const int w0 = (i_end - 1) / SROWS * SROWS;
      float mx, sum;
      quad_lse(ws + (lane >> 2) * SROWS, i_end - w0, lane, mx, sum);
      if (w0 == 0) {
        M = mx;
        S = sum;
      } else {
        const float nm = fmaxf(M, mx);
        S = S * expf(M - nm) + sum * expf(mx - nm);
        M = nm;
      }
      __syncwarp();
      const int h = hp0 + (lane >> 2);
      if (i_end == a.nk && !(lane & 3) && h < g) {   // the block is done
        const float e = M + logf(fmaxf(S, 1e-30f)) + a.log_stride;
        est_g[(size_t)h * a.nb + j0 + jl] = e;
        est_s[h * a.nbc + jl] = e;
      }
    }
  }
  __syncthreads();   // own estimates are in est_s

  // (2) the consensus of own blocks, their rank within the slice: the local
  // top P, sorted, is this CTA's candidate list
  float* cand_v = a.cand + ((size_t)grp * a.C + c) * a.P;
  int* cand_i = reinterpret_cast<int*>(a.cand) + (groups + grp) * a.C * a.P + (size_t)c * a.P;
  for (int jl = tid; jl < nbl; jl += SP_THREADS) {
    float m = -INFINITY;
    for (int h = 0; h < g; ++h) m = fmaxf(m, est_s[h * a.nbc + jl]);
    float sum = 0.0f;
    for (int h = 0; h < g; ++h) sum += expf(est_s[h * a.nbc + jl] - m);
    ekv[jl] = m + logf(fmaxf(sum, 1e-30f));
    chosen[jl] = 0;
  }
  __syncthreads();
  for (int jl = tid; jl < nbl; jl += SP_THREADS) {
    const float x = ekv[jl];
    int before = 0;
    for (int i = 0; i < nbl && before < a.P; ++i) {
      const float y = ekv[i];
      before += y > x || (y == x && i < jl);
    }
    if (before < a.P) {
      cand_v[before] = x;
      cand_i[before] = j0 + jl;
    }
  }
  // the group barrier: every CTA's list is in the scratch
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(bar, 1);
    while (ld_acquire(bar) < a.C) __nanosleep(32);
  }
  __syncthreads();

  // the selection, the same in every CTA: the group's lists (list cc holds
  // min(P, its own blocks) entries, at least P in all) side by side in
  // shared memory, merged in order -- the larger value first, ties to the
  // lower block; the R-th merged entry is selected block R, kept in sel
  // when it covers my keys and in chosen when it is my own block
  const int e0 = c * a.kc;
  const int n3 = max(0, min(a.P * a.bk - e0, a.kc));
  const int p0 = e0 / a.bk;
  float* lv = sm + cv.lv;
  int* li = reinterpret_cast<int*>(sm + cv.li);
  const int ne = a.C * a.P;   // list slots; slot i of list cc holds an entry iff i < len
  for (int x = tid; x < ne; x += SP_THREADS) {
    const int cc = x / a.P, i = x - cc * a.P;
    const bool ok = i < min(a.P, max(0, min(a.nb - cc * a.nbc, a.nbc)));
    const float y = __ldcg(a.cand + (size_t)grp * ne + x);
    const int j = __ldcg(reinterpret_cast<const int*>(a.cand) + (groups + grp) * ne + x);
    lv[x] = ok ? y : -INFINITY;   // an empty slot comes after every entry
    li[x] = ok ? j : 0x7fffffff;
  }
  __syncthreads();
  if (warp == 0) {
    // warp 0 merges the lists: lane l holds the heads of lists l, l + 32,
    // ...; step R takes the best head (the larger value, ties to the lower
    // block) by two warp reductions, and that list advances
    constexpr int LPL = 4;   // lists a lane, C <= 128
    unsigned hk[LPL];        // a head's value as an order-preserving key
    int hj[LPL], hp[LPL];    // its block, its list position
    auto head = [&](int t) {
      const int cc = lane + 32 * t;
      const float y = hp[t] < a.P && cc < a.C ? lv[cc * a.P + hp[t]] : -INFINITY;
      const unsigned u = __float_as_uint(y);
      hk[t] = y == -INFINITY ? 0u : (u >> 31 ? ~u : u | 0x80000000u);
      hj[t] = y == -INFINITY ? 0x7fffffff : li[cc * a.P + hp[t]];
    };
#pragma unroll
    for (int t = 0; t < LPL; ++t) {
      hp[t] = 0;
      head(t);
    }
    for (int R = 0; R < a.P; ++R) {
      unsigned bk = hk[0];
      int bj = hj[0], bt = 0;
#pragma unroll
      for (int t = 1; t < LPL; ++t)
        if (hk[t] > bk || (hk[t] == bk && hj[t] < bj)) {
          bk = hk[t];
          bj = hj[t];
          bt = t;
        }
      const unsigned mk = __reduce_max_sync(0xffffffffu, bk);
      const int mj = static_cast<int>(
          __reduce_min_sync(0xffffffffu, bk == mk ? static_cast<unsigned>(bj) : 0xffffffffu));
      if (bk == mk && bj == mj) {   // block indices are distinct: one lane
#pragma unroll
        for (int t = 0; t < LPL; ++t)
          if (t == bt) {
            ++hp[t];
            head(t);
          }
      }
      if (lane == 0) {
        if (R >= p0 && R - p0 < a.nsel) sel[R - p0] = mj;
        if (mj >= j0 && mj < j0 + nbl) chosen[mj - j0] = 1;
      }
    }
  }
  __syncthreads();

  // the residual of own unselected blocks per head, as (mu, r)
  for (int h = warp; h < g; h += SP_WARPS) {
    const float* e = est_s + h * a.nbc;
    float mx = -INFINITY;
    for (int i = 0; i < (nbl + 31) / 32; ++i) {
      const int jl = lane + 32 * i;
      if (jl < nbl && !chosen[jl]) mx = fmaxf(mx, e[jl]);
    }
    mx = warp_max(mx);
    float r = 0.0f;
    if (mx != -INFINITY) {
      for (int i = 0; i < (nbl + 31) / 32; ++i) {
        const int jl = lane + 32 * i;
        if (jl < nbl && !chosen[jl]) r += expf(e[jl] - mx);
      }
      r = warp_sum(r);
    }
    if (lane == 0) {
      part[2 * g + h] = mx == -INFINITY ? NEG : mx;
      part[3 * g + h] = r;
    }
  }

  // (3) flash-decode over keys [e0, e0 + n3) of the selection, per pass:
  // warp w takes batches w, w + 8, ... of KB3 keys, U3 a half-warp; a
  // batch's keys and values load while the batch before is summed (bf16)
  auto key_pos = [&](int el) {   // cache position of key el of my range
    const int e = e0 + el, R = e / a.bk;
    return (long long)sel[R - p0] * a.bk + (e - R * a.bk);
  };
  constexpr int KB3 = 2 * U3;
  constexpr bool PF3 = sizeof(TKV) == 2;   // f32 rows would take too many registers
  const int nb3 = (n3 + KB3 - 1) / KB3;
  float* wm = sm + cv.wm + warp * HP;
  float* wl = sm + cv.wl + warp * HP;
  for (int hp0 = 0; hp0 < g; hp0 += HP) {
    load_q(hp0);
    float acc[HP][8];
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] = 0.0f;
    float m = -INFINITY, l = 0.0f;   // of head lane / 4
    Row<TKV, VEC> kx[U3], vx[U3], kn[U3], vn[U3];
    auto load_keys = [&](int bt, Row<TKV, VEC> (&kr)[U3], Row<TKV, VEC> (&vr)[U3]) {
#pragma unroll
      for (int u = 0; u < U3; ++u) {
        const int el = bt * KB3 + 2 * u + half;
        const long long pos = el < n3 ? key_pos(el) : 0;
        const long long at = el < n3 && pos < a.kv_valid ? pos : 0;
        kr[u].load(kb + at * a.kss, d0, dh);
        vr[u].load(vb + at * a.vss, d0, dh);
      }
    };
    if (warp < nb3) load_keys(warp, kx, vx);
    for (int bt = warp; bt < nb3; bt += SP_WARPS) {
      if constexpr (PF3) {
        if (bt + SP_WARPS < nb3) load_keys(bt + SP_WARPS, kn, vn);
      }
      bool live[U3];
#pragma unroll
      for (int u = 0; u < U3; ++u) {
        const int el = bt * KB3 + 2 * u + half;
        live[u] = el < n3 && key_pos(el) < a.kv_valid;
        float x[8];
        kx[u].get(x, live[u] && in_dh);
        const float dot = half_warp_dots(qr, x, lane);
        if (!(hl & 1)) ws[((hl >> 1) & 7) * SROWS + 2 * u + half] = live[u] ? dot * a.scale : NEG;
      }
      __syncwarp();
      // per head (lane / 4): the batch max over its keys in range, then p
      const int nk3 = min(KB3, n3 - bt * KB3);
      float* wsh = ws + (lane >> 2) * SROWS;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KB3 / 4; ++i) {
        const int r = (lane & 3) + 4 * i;
        if (r < nk3) mx = fmaxf(mx, wsh[r]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < KB3 / 4; ++i) {
        const int r = (lane & 3) + 4 * i;
        const float p = r < nk3 ? expf(wsh[r] - m_new) : 0.0f;
        wsh[r] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m - m_new);   // 0 on the first batch
      l = l * alpha + sum;
      m = m_new;
      if (!(lane & 3)) wsh[SROWS - 1] = alpha;   // past the batch's keys
      __syncwarp();
      float vv[U3][8];
#pragma unroll
      for (int u = 0; u < U3; ++u) vx[u].get(vv[u], live[u] && in_dh);
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        const float al = ws[h * SROWS + SROWS - 1];
        float ph[U3];
#pragma unroll
        for (int u = 0; u < U3; ++u) ph[u] = ws[h * SROWS + 2 * u + half];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float o = acc[h][e] * al;
#pragma unroll
          for (int u = 0; u < U3; ++u) o = fmaf(ph[u], vv[u][e], o);
          acc[h][e] = o;
        }
      }
      __syncwarp();
      if constexpr (PF3) {
#pragma unroll
        for (int u = 0; u < U3; ++u) {
          kx[u] = kn[u];
          vx[u] = vn[u];
        }
      } else {
        if (bt + SP_WARPS < nb3) load_keys(bt + SP_WARPS, kx, vx);
      }
    }
    // the warp's two halves share m: add the halves, then publish
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], 16);
    float* wacc = sm + cv.wacc + warp * HP * DMAX;
    if (half == 0 && in_dh)
#pragma unroll
      for (int h = 0; h < HP; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) wacc[h * DMAX + d0 + e] = acc[h][e];
    if (!(lane & 3)) {
      wm[lane >> 2] = m;
      wl[lane >> 2] = l;
    }
    __syncthreads();
    // the CTA's partial of this pass: the warps folded in warp order
    const int hn = min(HP, g - hp0);
    for (int pr = tid; pr < hn * dh; pr += SP_THREADS) {
      const int h = pr / dh, d = pr - h * dh;
      float mc = -INFINITY;
#pragma unroll
      for (int w = 0; w < SP_WARPS; ++w) mc = fmaxf(mc, sm[cv.wm + w * HP + h]);
      float lc = 0.0f, s = 0.0f;
      if (mc != -INFINITY)
#pragma unroll
        for (int w = 0; w < SP_WARPS; ++w) {
          const float wt = expf(sm[cv.wm + w * HP + h] - mc);
          lc = fmaf(sm[cv.wl + w * HP + h], wt, lc);
          s = fmaf(sm[cv.wacc + (w * HP + h) * DMAX + d], wt, s);
        }
      part[4 * g + (hp0 + h) * dh + d] = s;
      if (d == 0) {
        part[hp0 + h] = mc;
        part[g + hp0 + h] = lc;
      }
    }
    __syncthreads();
  }

  // the second group barrier: every CTA's partials are in the scratch
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(bar + 1, 1);
    while (ld_acquire(bar + 1) < a.C) __nanosleep(32);
  }
  __syncthreads();

  // (4) per head: m, the CTA weights, l and the residual mass, lanes over
  // CTAs, summed in a fixed shuffle order; then CTA c writes outputs
  // [c no, (c + 1) no) of the group's g dh, each folded over the CTAs in
  // order: out = sum_c w_c acc_c / l times l / (l + r)
  const float* parts = a.part + (size_t)grp * a.C * PW;
  float* wc = sm + cv.wc;   // exp(m_c - m) per (head, CTA)
  float* hl_ = sm + cv.hl;
  float* hr = sm + cv.hr;
  const int no = (g * dh + a.C - 1) / a.C;
  const int o0 = c * no, o1 = min(g * dh, o0 + no);
  for (int h = o0 / dh + warp; h < (o1 + dh - 1) / dh; h += SP_WARPS) {
    const int nc = (a.C + 31) / 32;
    float m = -INFINITY;
    for (int i = 0; i < nc; ++i) {
      const int cc = lane + 32 * i;
      if (cc < a.C) m = fmaxf(m, __ldcg(parts + (size_t)cc * PW + h));
    }
    m = warp_max(m);
    float l = 0.0f, rs = 0.0f;
    for (int i = 0; i < nc; ++i) {
      const int cc = lane + 32 * i;
      if (cc < a.C) {
        const float* pc = parts + (size_t)cc * PW;
        const float w = expf(__ldcg(pc + h) - m);
        wc[h * a.C + cc] = w;
        l = fmaf(__ldcg(pc + g + h), w, l);
        const float r = __ldcg(pc + 3 * g + h);
        if (r > 0.0f) rs = fmaf(r, expf(__ldcg(pc + 2 * g + h) - m), rs);
      }
    }
    l = warp_sum(l);
    rs = warp_sum(rs);
    if (lane == 0) {
      hl_[h] = l;
      hr[h] = rs;
    }
  }
  __syncthreads();
  for (int pr = o0 + tid; pr < o1; pr += SP_THREADS) {
    const int h = pr / dh;
    float s = 0.0f;
#pragma unroll 8
    for (int cc = 0; cc < a.C; ++cc)
      s = fmaf(__ldcg(parts + (size_t)cc * PW + 4 * g + pr), wc[h * a.C + cc], s);
    const float l = hl_[h];
    const float o = s / fmaxf(l, 1e-30f);
    store_f32(static_cast<TQ*>(a.out) + ((size_t)bi * a.hq + kvh * g) * dh + pr,
              o * (l / fmaxf(l + hr[h], 1e-30f)));
  }

  // the last CTA out resets the group's counters for the next launch
  __syncthreads();
  if (tid == 0 && atomicAdd(bar + 2, 1) == a.C - 1) {
    bar[0] = 0;
    bar[1] = 0;
    bar[2] = 0;
  }
}

}  // namespace

extern "C" {

// The static arguments of a kde_decode launch: one struct per (shapes,
// strides, bk, stride, top_p), built once by the wrapper (mirrored by
// kernels/build.py KdeDecodeShape), so a call passes 10 arguments.
struct KdeDecodeShape {
  int b, hq, hkv, S, dh, bk, stride, top_p;
  int q_dtype, kv_dtype;   // 0: float32, 1: bfloat16
  int mode;                // -1: the plan's choice; 0: cluster; 1: spread
  float scale, log_stride;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
};

// What a launch of a shape takes (mirrored by build.py KdeDecodePlan).
struct KdeDecodePlan {
  int mode;            // 0: cluster kernel, 1: spread kernel
  int ctas;            // CTAs per (batch, kv-head)
  int blocks;          // key blocks a CTA estimates
  int smem;            // dynamic shared memory, bytes
  long long work;      // f32 words of global scratch after est (spread)
  int sync;            // int32 counters (spread)
};

}  // extern "C"

namespace {

// the card's SM count (queried once), or a negative CUDA error code
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    sms = n;
  }
  return sms;
}

bool valid_shape(const KdeDecodeShape* sh) {
  return sh->dh >= 1 && sh->dh <= DMAX && sh->hkv >= 1 && sh->hq % sh->hkv == 0 &&
         sh->bk >= 1 && sh->stride >= 1 && sh->top_p >= 1 && sh->S >= sh->bk &&
         sh->S % sh->bk == 0 && sh->b >= 1 && sh->b <= 65535 && sh->hkv <= 65535 &&
         sh->q_dtype >= 0 && sh->q_dtype <= 1 && sh->kv_dtype >= 0 && sh->kv_dtype <= 1 &&
         sh->mode >= -1 && sh->mode <= 1;
}

// The cluster launch's arguments: the smallest cluster size C in [2, 8],
// at least ceil(SMs / clusters), whose carve-up fits MAX_SMEM.  Returns
// the dynamic shared memory in bytes, 0 when no cluster size fits.
long long cluster_args(const KdeDecodeShape* sh, int sms, Decode& a) {
  const int b = sh->b, hq = sh->hq, hkv = sh->hkv, S = sh->S, dh = sh->dh, bk = sh->bk,
            stride = sh->stride, top_p = sh->top_p;
  a = Decode{nullptr, nullptr, nullptr, nullptr, nullptr, hq, hkv, S / bk, dh, bk, stride, 0, 0};
  a.P = top_p < a.nb ? top_p : a.nb;
  a.g = hq / hkv;
  a.nk = (bk + stride - 1) / stride;
  a.bpw = a.nk >= KCH ? 1 : KCH / a.nk;
  a.scw = a.nk > KCH ? a.nk : KCH;
  a.d4 = (dh + 3) / 4;
  a.ks = 4 * (a.d4 % 2 ? a.d4 : a.d4 + 1);   // an odd number of 16-byte units
  a.scale = sh->scale;
  a.log_stride = sh->log_stride;
  a.qsb = sh->qsb; a.qsh = sh->qsh; a.ksb = sh->ksb; a.ksh = sh->ksh; a.kss = sh->kss;
  a.vsb = sh->vsb; a.vsh = sh->vsh; a.vss = sh->vss;
  const int clusters = b * hkv;
  int c = (sms + clusters - 1) / clusters;
  c = c < 2 ? 2 : (c > MAX_CLUSTER ? MAX_CLUSTER : c);
  for (; c <= MAX_CLUSTER; ++c) {
    a.C = c;
    a.nbc = (a.nb + c - 1) / c;
    a.kc = (a.P * bk + c - 1) / c;
    a.ncand = a.P < a.nbc ? a.P : a.nbc;
    a.nsel = (a.kc + bk - 1) / bk + 1;
    const long long smem = static_cast<long long>(sizeof(float)) * Carve(a).total;
    if (smem <= MAX_SMEM) return smem;
  }
  return 0;
}

// The spread launch's arguments: C = floor(SMs / (b hkv)) CTAs a (batch,
// kv-head), at most 128 (the merge's lanes).  Returns the dynamic shared
// memory in bytes, 0 when the grid exceeds the SMs or the carve-up does
// not fit.
long long spread_args(const KdeDecodeShape* sh, int sms, Spread& a) {
  const int groups = sh->b * sh->hkv;
  if (groups > sms) return 0;
  a = Spread{};
  a.hq = sh->hq;
  a.hkv = sh->hkv;
  a.nb = sh->S / sh->bk;
  a.dh = sh->dh;
  a.bk = sh->bk;
  a.stride = sh->stride;
  a.P = sh->top_p < a.nb ? sh->top_p : a.nb;
  a.g = sh->hq / sh->hkv;
  a.nk = (sh->bk + sh->stride - 1) / sh->stride;
  a.C = sms / groups < 128 ? sms / groups : 128;
  a.nbc = (a.nb + a.C - 1) / a.C;
  a.kc = static_cast<int>((static_cast<long long>(a.P) * a.bk + a.C - 1) / a.C);
  a.nsel = (a.kc + a.bk - 1) / a.bk + 1;
  a.scale = sh->scale;
  a.log_stride = sh->log_stride;
  a.qsb = sh->qsb; a.qsh = sh->qsh; a.ksb = sh->ksb; a.ksh = sh->ksh; a.kss = sh->kss;
  a.vsb = sh->vsb; a.vsh = sh->vsh; a.vss = sh->vss;
  const long long smem = static_cast<long long>(sizeof(float)) * SpreadCarve(a).total;
  return smem <= MAX_SMEM ? smem : 0;
}

// The plan of a shape: the spread kernel when the cluster kernel would
// leave most SMs idle (b hkv 8 < SMs / 2, the long_500k cell's batch 1)
// or does not fit, else the cluster kernel (the serve shape); ``mode``
// forces one.  Returns 0, 1 when neither fits (refused), or a negative
// CUDA error code.
int make_plan(const KdeDecodeShape* sh, Decode& da, Spread& sa, KdeDecodePlan& pl) {
  if (!valid_shape(sh)) return 1;
  const int sms = sm_count();
  if (sms < 0) return sms;
  const long long cl = sh->mode == 1 ? 0 : cluster_args(sh, sms, da);
  const long long sp = sh->mode == 0 ? 0 : spread_args(sh, sms, sa);
  const bool idle = 2LL * sh->b * sh->hkv * MAX_CLUSTER < sms;
  const bool spread = sp > 0 && (cl == 0 || idle || sh->mode == 1);
  if (!spread && cl == 0) return 1;
  pl = KdeDecodePlan{};
  if (spread) {
    const long long groups = static_cast<long long>(sh->b) * sh->hkv;
    pl = {1, sa.C, sa.nbc, static_cast<int>(sp),
          groups * sa.C * (2LL * sa.P + 4LL * sa.g + static_cast<long long>(sa.g) * sa.dh),
          static_cast<int>(3 * groups)};
  } else {
    pl = {0, da.C, da.nbc, static_cast<int>(cl), 0, 0};
  }
  return 0;
}

// Raise a kernel's dynamic shared memory past 48 KB once per size.
template <typename K>
int raise_smem(K kernel, long long smem, long long& raised) {
  if (smem <= raised) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  raised = smem;
  return 0;
}

// One launch of the (TQ, TKV) cluster instance, the cluster size as a
// launch attribute.
template <typename TQ, typename TKV>
int launch_cluster(Decode a, long long smem, const KdeDecodeShape* sh, cudaStream_t st) {
  static long long raised = 48 * 1024;
  if (const int err = raise_smem(kde_decode_kernel<TQ, TKV>, smem, raised)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C, sh->hkv, sh->b);
  cfg.blockDim = dim3(DK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kde_decode_kernel<TQ, TKV>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the (TQ, TKV, VEC) spread instance, cooperative: every
// CTA of the grid is resident at once (the group barrier spins on it).
template <typename TQ, typename TKV, bool VEC>
int launch_spread(Spread a, long long smem, const KdeDecodeShape* sh, cudaStream_t st) {
  static long long raised = 48 * 1024;
  if (const int err = raise_smem(kde_spread_kernel<TQ, TKV, VEC>, smem, raised)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C, sh->hkv, sh->b);
  cfg.blockDim = dim3(SP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kde_spread_kernel<TQ, TKV, VEC>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_spread(Spread a, bool vec, long long smem, const KdeDecodeShape* sh,
                  cudaStream_t st) {
  return vec ? launch_spread<TQ, TKV, true>(a, smem, sh, st)
             : launch_spread<TQ, TKV, false>(a, smem, sh, st);
}

// rows of t at p with strides (b, h, s) in elements: 16-byte loads of 8
// dims a lane stay aligned and inside the row
bool rows16(const void* p, long long sb, long long sh_, long long ss, int dh, int esize) {
  const long long ve = 16 / esize;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % ve == 0 && sh_ % ve == 0 &&
         ss % ve == 0 && dh % 8 == 0;
}

}  // namespace

extern "C" {

// The plan a kde_decode launch of this shape takes: 0 and *plan filled, 1
// when the shape is invalid or fits neither kernel (refused), or a CUDA
// error code (negative).
int kde_decode_plan(const KdeDecodeShape* sh, KdeDecodePlan* plan) {
  Decode da;
  Spread sa;
  return make_plan(sh, da, sa, *plan);
}

// q strided over (batch, head), k / v over (batch, head, position); head
// dimension contiguous; out (b, hq, dh) in q's dtype and est (b, hq, S / bk)
// f32 contiguous.  The cluster kernel takes est null or not and ignores
// work and sync; the spread kernel needs est, work (the plan's ``work``
// f32 words, uninitialised) and sync (the plan's ``sync`` int32 words, 0
// before the launch and left at 0 by it; one buffer a stream).  S a
// multiple of bk, hq % hkv == 0, dh <= 128, dtype ids 0 (float32) or 1
// (bfloat16), and a plan (kde_decode_plan 0; the wrapper checks).
int kde_decode_launch(const void* q, const void* k, const void* v, void* out, float* est,
                      float* work, int* sync, int kv_valid, void* stream,
                      const KdeDecodeShape* sh) {
  Decode da;
  Spread sa;
  KdeDecodePlan pl;
  const int rc = make_plan(sh, da, sa, pl);
  if (rc < 0) return -rc;
  if (rc > 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qd = sh->q_dtype, kd = sh->kv_dtype;
  if (pl.mode == 0) {
    da.q = q; da.k = k; da.v = v; da.out = out; da.est = est; da.kv_valid = kv_valid;
    if (qd == 0)
      return kd == 0 ? launch_cluster<float, float>(da, pl.smem, sh, st)
                     : launch_cluster<float, __nv_bfloat16>(da, pl.smem, sh, st);
    return kd == 0 ? launch_cluster<__nv_bfloat16, float>(da, pl.smem, sh, st)
                   : launch_cluster<__nv_bfloat16, __nv_bfloat16>(da, pl.smem, sh, st);
  }
  if (est == nullptr || work == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(sh->b) * sh->hkv;
  sa.q = q; sa.k = k; sa.v = v; sa.out = out; sa.est = est; sa.sync = sync;
  sa.cand = work;
  sa.part = work + 2 * groups * sa.C * sa.P;
  sa.kv_valid = kv_valid;
  const int es = kd == 0 ? 4 : 2;
  const bool vec = rows16(k, sh->ksb, sh->ksh, sh->kss, sh->dh, es) &&
                   rows16(v, sh->vsb, sh->vsh, sh->vss, sh->dh, es);
  if (qd == 0)
    return kd == 0 ? launch_spread<float, float>(sa, vec, pl.smem, sh, st)
                   : launch_spread<float, __nv_bfloat16>(sa, vec, pl.smem, sh, st);
  return kd == 0 ? launch_spread<__nv_bfloat16, float>(sa, vec, pl.smem, sh, st)
                 : launch_spread<__nv_bfloat16, __nv_bfloat16>(sa, vec, pl.smem, sh, st);
}

}  // extern "C"
