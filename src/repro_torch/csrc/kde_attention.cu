// KDE decode attention: the whole decode pipeline of one step and one layer
// in one launch.
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
// carve-up fits 227 KB; kde_decode_cluster reports 0 where none of 2-8
// does (about 980k keys at bk 32, g 8, dh 128), and the wrapper refuses
// such a cache.  Four cluster barriers in all, the last one only so that
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

}  // namespace

extern "C" {

// The static arguments of a kde_decode launch: one struct per (shapes,
// strides, bk, stride, top_p), built once by the wrapper (mirrored by
// kernels/build.py KdeDecodeShape), so a call passes 8 arguments.
struct KdeDecodeShape {
  int b, hq, hkv, S, dh, bk, stride, top_p;
  int q_dtype, kv_dtype;   // 0: float32, 1: bfloat16
  float scale, log_stride;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
};

}  // extern "C"

namespace {

// The launch arguments of a shape, with the cluster size: the smallest C
// in [2, 8], at least ceil(SMs / clusters), whose carve-up fits MAX_SMEM.
// Returns the dynamic shared memory in bytes, 0 when the shape is invalid
// or no cluster size fits, or a negative CUDA error code.
long long decode_args(const KdeDecodeShape* sh, Decode& a) {
  const int b = sh->b, hq = sh->hq, hkv = sh->hkv, S = sh->S, dh = sh->dh, bk = sh->bk,
            stride = sh->stride, top_p = sh->top_p;
  if (dh < 1 || dh > DMAX || hkv < 1 || hq % hkv != 0 || bk < 1 || stride < 1 ||
      top_p < 1 || S < bk || S % bk != 0 || b < 1 || b > 65535 || hkv > 65535 ||
      sh->q_dtype < 0 || sh->q_dtype > 1 || sh->kv_dtype < 0 || sh->kv_dtype > 1)
    return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<long long>(err);
  }
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

// One launch of the (TQ, TKV) instance: its dynamic shared memory raised
// past 48 KB once per instance, the cluster size as a launch attribute.
template <typename TQ, typename TKV>
int launch_decode(Decode a, long long smem, const KdeDecodeShape* sh, cudaStream_t st) {
  static long long raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kde_decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = smem;
  }
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

}  // namespace

extern "C" {

// The cluster size a kde_decode launch of this shape takes, 0 when the
// shape is invalid or its carve-up fits no cluster of 2-8 CTAs, or a
// negative CUDA error code.
int kde_decode_cluster(const KdeDecodeShape* sh) {
  Decode a;
  const long long smem = decode_args(sh, a);
  return smem > 0 ? a.C : static_cast<int>(smem);
}

// q strided over (batch, head), k / v over (batch, head, position); head
// dimension contiguous; out (b, hq, dh) in q's dtype and est (b, hq, S / bk)
// f32 contiguous, est may be null.  S a multiple of bk, hq % hkv == 0, dh <=
// 128, dtype ids 0 (float32) or 1 (bfloat16), and a carve-up that fits
// (kde_decode_cluster > 0; the wrapper checks).
int kde_decode_launch(const void* q, const void* k, const void* v, void* out, float* est,
                      int kv_valid, void* stream, const KdeDecodeShape* sh) {
  Decode a;
  const long long smem = decode_args(sh, a);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.est = est;
  a.kv_valid = kv_valid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sh->q_dtype == 0)
    return sh->kv_dtype == 0 ? launch_decode<float, float>(a, smem, sh, st)
                             : launch_decode<float, __nv_bfloat16>(a, smem, sh, st);
  return sh->kv_dtype == 0 ? launch_decode<__nv_bfloat16, float>(a, smem, sh, st)
                           : launch_decode<__nv_bfloat16, __nv_bfloat16>(a, smem, sh, st);
}

}  // extern "C"
