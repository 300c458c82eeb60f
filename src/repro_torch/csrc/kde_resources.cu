// What the card reports for each kernel instance and for itself: the check
// of kernels/tuning.py's RESOURCES table and HopperLimits (chip_smoke.py's
// tuning phase).  Replaces no TPU kernel: the reference sizes its Pallas
// tiles against a VMEM budget (src/repro/kernels/tuning.py), and this is
// the card's side of the port's budgets.  No launch path calls it.
#include <cuda_runtime.h>

#include "kde_func.cuh"

namespace {

// tuning.DEVICE_FIELDS, in order.
constexpr cudaDeviceAttr kFields[] = {
    cudaDevAttrMultiProcessorCount,              // sms
    cudaDevAttrMaxSharedMemoryPerBlockOptin,     // smem_per_cta_optin
    cudaDevAttrMaxSharedMemoryPerMultiprocessor, // smem_per_sm
    cudaDevAttrReservedSharedMemoryPerBlock,     // smem_reserved
    cudaDevAttrMaxRegistersPerMultiprocessor,    // regs_per_sm
    cudaDevAttrMaxThreadsPerMultiProcessor,      // threads_per_sm
    cudaDevAttrMaxBlocksPerMultiprocessor,       // max_ctas
    cudaDevAttrL2CacheSize,                      // l2_bytes
};

int lookup(int id, int instance, kde::FuncInfo* f) {
  if (id < kde::F_SAMPLER_GENERIC) return kde_rowsum_func(id, instance, f);
  if (id < kde::F_WEIGHTED_SCALAR) return kde_sampler_func(id, instance, f);
  if (id < kde::F_FLASH_FWD) return kde_hash_func(id, instance, f);
  if (id < kde::F_KDE_DECODE) return flash_attention_func(id, instance, f);
  return kde_attention_func(id, instance, f);
}

}  // namespace

extern "C" {

// Field `field` of tuning.DEVICE_FIELDS of device `device` (cudaDeviceGetAttribute).
int kde_device_attribute(int field, int device, int* value) {
  if (field < 0 || field >= static_cast<int>(sizeof(kFields) / sizeof(kFields[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaDeviceGetAttribute(value, kFields[field], device));
}

// Instance `instance` of kernel family `kernel_id` (kde_func.cuh) on the
// current device: the block size and dynamic shared memory its launcher
// uses, cudaFuncGetAttributes' registers, static shared memory, local memory
// and largest block, and cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// that block size and shared memory (the limit raised to it first, as the
// launcher raises it).  cudaErrorInvalidValue for an instance the library
// does not build.
int kde_func_attributes(int kernel_id, int instance, int* threads, int* regs, int* smem_static,
                        int* smem_dynamic, int* local_bytes, int* max_threads,
                        int* ctas_per_sm) {
  kde::FuncInfo f{nullptr, 0, 0};
  if (kernel_id < 0 || kernel_id > kde::F_KDE_SPREAD || !lookup(kernel_id, instance, &f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, f.fn);
  if (err == cudaSuccess && f.smem > 48 * 1024)
    err = cudaFuncSetAttribute(f.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, f.fn, f.threads, f.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = f.threads;
  *regs = a.numRegs;
  *smem_static = static_cast<int>(a.sharedSizeBytes);
  *smem_dynamic = f.smem;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  *ctas_per_sm = ctas;
  return 0;
}

}  // extern "C"
