// The resource query of every kernel instance (kde_resources.cu
// kde_func_attributes, the card's check of kernels/tuning.py RESOURCES).
//
// Each source exports one lookup, kde_<source>_func(id, instance, &info):
// the host stub, block size and dynamic shared memory of one instance, as
// that source's launcher launches it.  No launch path calls a lookup.  An
// instance is its kernel family (FuncId) and its template arguments packed
// a byte each, the first in the low byte: a bool 0 / 1, a type float 0 or
// __nv_bfloat16 1, an int as it is (tuning.instance_code).  A lookup names
// only instances its launcher instantiates, so it adds no kernel to the
// library.
#pragma once

#include <type_traits>

namespace kde {

// The kernel families, in the order of kernels/tuning.py KERNEL_IDS.
enum FuncId : int {
  F_BLOCKSUM = 0,        // kde_rowsum.cu blocksum_kernel<KIND, TENANT>
  F_BLOCKSUM_DEEP,       // blocksum_deep_kernel<KIND, TENANT>
  F_BLOCKSUM_WIDE,       // blocksum_wide_kernel<KIND, DK, TENANT>
  F_BLOCKSUM_MMA,        // blocksum_mma_kernel<KIND, DK>
  F_ROWSUM_REDUCE,       // rowsum_reduce_kernel
  F_SAMPLER_GENERIC,     // kde_sampler.cu sampler_generic_kernel<KIND, DRAW, TENANT>
  F_SAMPLER_WIDE,        // sampler_wide_kernel<KIND, DK, DRAW, TENANT>
  F_SAMPLER_MMA,         // sampler_mma_kernel<KIND, DK, DRAW>
  F_WEIGHTED_SCALAR,     // kde_hash.cu weighted_kv_scalar_kernel<KIND, SUM, XT>
  F_WEIGHTED_VEC,        // weighted_kv_vec_kernel<KIND, SUM, D4, XT>
  F_FLASH_FWD,           // flash_attention.cu flash_fwd_kernel<float, DB, VEC>
  F_FLASH_MMA,           // flash_mma_kernel<DB, VEC>
  F_KDE_DECODE,          // kde_attention.cu kde_decode_kernel<TQ, TKV>
  F_KDE_SPREAD,          // kde_spread_kernel<TQ, TKV, VEC>
};

struct FuncInfo {
  const void* fn;   // the instance's host stub
  int threads;      // the launch's block size
  int smem;         // the launch's dynamic shared memory, bytes
};

// Template argument i of a packed instance.
inline int targ(int instance, int i) { return (instance >> (8 * i)) & 0xff; }

template <int V>
using Int = std::integral_constant<int, V>;
template <bool V>
using Bool = std::integral_constant<bool, V>;

// fn(Int<KIND>, Bool<TENANT>) for the (kind, tenant) pairs the KDE tile
// launchers instantiate: every kind alone, the f32 kinds 0-3 with the tenant
// axis too.  False for any other pair.
template <class F>
bool with_kind_tenant(int kind, int tenant, F&& fn) {
  if (tenant) {
    switch (kind) {
      case 0: return fn(Int<0>{}, Bool<true>{});
      case 1: return fn(Int<1>{}, Bool<true>{});
      case 2: return fn(Int<2>{}, Bool<true>{});
      case 3: return fn(Int<3>{}, Bool<true>{});
      default: return false;
    }
  }
  switch (kind) {
    case 0: return fn(Int<0>{}, Bool<false>{});
    case 1: return fn(Int<1>{}, Bool<false>{});
    case 2: return fn(Int<2>{}, Bool<false>{});
    case 3: return fn(Int<3>{}, Bool<false>{});
    case 4: return fn(Int<4>{}, Bool<false>{});
    case 5: return fn(Int<5>{}, Bool<false>{});
    case 6: return fn(Int<6>{}, Bool<false>{});
    default: return false;
  }
}

// The FuncInfo of a kernel (a __global__ function or template instance).
template <class K>
inline FuncInfo info(K* kernel, int threads, int smem) {
  return FuncInfo{reinterpret_cast<const void*>(kernel), threads, smem};
}

}  // namespace kde

extern "C" {
int kde_rowsum_func(int id, int instance, kde::FuncInfo* f);
int kde_sampler_func(int id, int instance, kde::FuncInfo* f);
int kde_hash_func(int id, int instance, kde::FuncInfo* f);
int flash_attention_func(int id, int instance, kde::FuncInfo* f);
int kde_attention_func(int id, int instance, kde::FuncInfo* f);
}
