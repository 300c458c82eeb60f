"""The card's budgets and the sizes of the KDE tile plans (DESIGN.md
§14): the reference's ``repro.kernels.tuning`` re-derived for Hopper.

* The walk-resident layout (``walk_samples_per_block``,
  ``walk_block_size``) is the reference's, unchanged: it fixes the walk
  programs' eval counters, which must equal the reference's.
* ``HopperLimits`` holds the card's budgets: ``H100_SXM`` from the data
  sheet (the CPU's figures), ``limits(device)`` read from the card.
  ``ctas_per_sm`` is the occupancy rule on them.
* ``RESOURCES`` holds every kernel instance the library builds: block
  size, registers (ptxas, sm_90a), shared memory, local memory and
  spills.  ``chip_smoke.py``'s tuning phase holds the card to it
  (``card_resources``, ``ptxas_resources``).
* The tile sizes and CTA counts the plans read
  (``kde_sampler.kernel.sample_block_plan`` / ``group_for``,
  ``kde_rowsum.kernel.blocksum_plan`` / ``rowsum_plan``,
  ``kde_hash.kernel.weighted_kv_plan``), and the reference's two
  choosers under its names and signatures: ``pallas_tiles`` (the (bm, bn)
  the rowsum / blocksum kernels run) and ``sweep_blocks_per_tile`` (the
  bf16 sweep's column tile).  The reference's ``VMEM_BUDGET`` (half of a
  TPU core's VMEM) becomes ``SMEM_BUDGET``, the shared memory one CTA may
  take.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import NamedTuple

# ------------------------------------------------------------- walk layout
# Level-1 columns resident in a walk program's subsample cache.  At the
# default block layout (bs = sqrt(n)) this equals num_blocks * s for
# n = 4096 (B=64, s=16), so small problems are untouched; past that the
# per-block width shrinks instead of the per-step cost growing.
WALK_CACHE_COLS = 1024
WALK_CACHE_MIN_S = 2

# Narrowest walk-layout stratum.
WALK_MIN_BLOCK = 64


@functools.lru_cache(maxsize=None)
def walk_samples_per_block(num_blocks: int, s: int,
                           cap: int = WALK_CACHE_COLS) -> int:
    """Per-block subsample width of the walk-resident level-1 cache:
    ``min(s, max(cap // num_blocks, WALK_CACHE_MIN_S))`` -- never more
    than the stratified width ``s``, never fewer than ``WALK_CACHE_MIN_S``
    rows a block, and at most ~``cap`` columns in all."""
    return min(int(s), max(int(cap) // max(int(num_blocks), 1),
                           WALK_CACHE_MIN_S))


@functools.lru_cache(maxsize=None)
def walk_block_size(n: int, block_size: int) -> int:
    """Stratum width of the walk-resident layout: half the next power of
    two at or above ``sqrt(n)``, floored at ``WALK_MIN_BLOCK`` and never
    wider than the sampler's own blocks (n = 4096: 64; n = 65536: 128;
    n = 10^6: 512).  A walk step's exact level-2 read is this wide."""
    p = 1
    while p * p < n:
        p *= 2
    return max(WALK_MIN_BLOCK, min(int(block_size), p // 2))


# ------------------------------------------------------------ the card
@dataclasses.dataclass(frozen=True)
class HopperLimits:
    """The budgets of one card that the plans and the occupancy rule
    read."""
    sms: int                  # streaming multiprocessors
    smem_per_cta_optin: int   # dynamic shared memory a CTA may opt in to
    smem_per_sm: int          # shared memory an SM holds for its CTAs
    smem_reserved: int        # shared memory an SM reserves for each CTA
    regs_per_sm: int          # 32-bit registers an SM
    reg_alloc_unit: int       # registers are given to a warp in these
    threads_per_sm: int       # resident threads an SM
    max_ctas: int             # resident CTAs an SM
    l2_bytes: int             # L2 cache


#: NVIDIA H100 SXM (data sheet; the CUDA occupancy calculator's sm_90
#: figures for the reservation and the allocation unit)
H100_SXM = HopperLimits(sms=132, smem_per_cta_optin=232448,
                        smem_per_sm=233472, smem_reserved=1024,
                        regs_per_sm=65536, reg_alloc_unit=256,
                        threads_per_sm=2048, max_ctas=32,
                        l2_bytes=50 * 1024 * 1024)

#: the ``HopperLimits`` fields a device attribute reports, in the order of
#: ``kde_device_attribute``'s table (csrc/kde_resources.cu); no attribute
#: reports ``reg_alloc_unit`` (256 on every card since sm_50), which the
#: card's occupancy API checks instead (``chip_smoke.py`` tuning phase)
DEVICE_FIELDS = ("sms", "smem_per_cta_optin", "smem_per_sm",
                 "smem_reserved", "regs_per_sm", "threads_per_sm",
                 "max_ctas", "l2_bytes")
#: the ``torch.cuda.get_device_properties`` field of each, where torch has
#: one; ``limits`` reads the rest through ``kde_device_attribute``
TORCH_FIELDS = {"sms": "multi_processor_count",
                "smem_per_cta_optin": "shared_memory_per_block_optin",
                "smem_per_sm": "shared_memory_per_multiprocessor",
                "regs_per_sm": "regs_per_multiprocessor",
                "threads_per_sm": "max_threads_per_multi_processor",
                "l2_bytes": "L2_cache_size"}
#: register files an SM splits its registers into (sm_90), each holding
#: whole warps' allocations
REG_PARTITIONS = 4
#: shared memory is given to a CTA in units of this many bytes (sm_90)
SMEM_UNIT = 128


def _index(device) -> int:
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the card's limits need a CUDA device, got {dev}")
    return torch.cuda.current_device() if dev.index is None else dev.index


def device_attribute(field: str, device=None) -> int:
    """``field`` of ``DEVICE_FIELDS`` as ``cudaDeviceGetAttribute`` reports
    it for ``device`` (the library's ``kde_device_attribute``)."""
    import ctypes
    from repro_torch.kernels import build as _build
    value = ctypes.c_int(0)
    err = _build.library().kde_device_attribute(
        DEVICE_FIELDS.index(field), _index(device), ctypes.byref(value))
    _build.check(err, f"kde_device_attribute({field})")
    return value.value


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> HopperLimits:
    import torch
    props = torch.cuda.get_device_properties(index)
    vals = {}
    for field in DEVICE_FIELDS:
        got = getattr(props, TORCH_FIELDS.get(field, ""), None)
        vals[field] = int(got) if got is not None \
            else device_attribute(field, index)
    return HopperLimits(reg_alloc_unit=H100_SXM.reg_alloc_unit, **vals)


def limits(device=None) -> HopperLimits:
    """The card's own figures (``device`` None: the current CUDA device),
    memoized by device index: the fields ``torch.cuda.
    get_device_properties`` has (``TORCH_FIELDS``), the others from
    ``cudaDeviceGetAttribute``."""
    return _limits(_index(device))


@functools.lru_cache(maxsize=None)
def ctas_per_sm(threads: int, regs: int, smem: int,
                lim: HopperLimits = H100_SXM) -> int:
    """CTAs of ``threads`` threads at ``regs`` registers a thread and
    ``smem`` bytes of shared memory (static and dynamic) that one SM holds
    at once: the least of the register, shared-memory, thread and CTA
    limits, as the CUDA occupancy calculator counts them.  Registers go to
    a warp in ``reg_alloc_unit`` units, within one of the SM's
    ``REG_PARTITIONS`` register files; a CTA's shared memory adds the SM's
    reservation and rounds up to ``SMEM_UNIT``.  0 when one CTA does not
    fit (H100: 256 threads at 128 registers -> 2; at 118 -> 2; at 64 ->
    4)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // lim.reg_alloc_unit) * lim.reg_alloc_unit
    used = -(-(smem + lim.smem_reserved) // SMEM_UNIT) * SMEM_UNIT
    if warps * 32 > lim.threads_per_sm or smem > lim.smem_per_cta_optin \
            or per_warp * -(-warps // REG_PARTITIONS) * REG_PARTITIONS \
            > lim.regs_per_sm:
        return 0
    by_regs = (lim.regs_per_sm // REG_PARTITIONS // per_warp
               * REG_PARTITIONS // warps) if per_warp else lim.max_ctas
    return min(by_regs, lim.smem_per_sm // used,
               lim.threads_per_sm // (warps * 32), lim.max_ctas)


# -------------------------------------------------- the kernel instances
class Resource(NamedTuple):
    threads: int    # the launch's block size
    regs: int       # registers a thread (ptxas, sm_90a)
    smem: int       # dynamic shared memory the launch asks for, bytes
    static: int     # static shared memory, bytes
    stack: int      # local memory a thread (ptxas' stack frame), bytes
    spill_stores: int   # bytes (ptxas)
    spill_loads: int    # bytes (ptxas)


#: every kernel instance of the library: the C++ template-id (``bf16``
#: for ``__nv_bfloat16``), block size (thr), registers (reg), dynamic /
#: static shared memory (smem / stat), stack frame (stk) and spill stores /
#: loads (spst / spld) in bytes, as ptxas reports them for sm_90a (the
#: card's CUDA toolkit) and the launchers launch them.  KIND: 0-3 the f32
#: kinds, 4-6 the bf16 ones (csrc/kde_tile.cuh ``enum Kind``).  The
#: weighted scalar instances add 4 d bytes to the 0 here at launch; the
#: decode instances take their plan's carve-up, at most ``SMEM_BUDGET``
#: (the figure here).  25 instances spill today (the exponential wide
#: tiles, some tenant-axis and draw tiles, the spread kernel): the card's
#: check holds the spills to this table, not to 0.
_TABLE = """
# instance                                 thr reg   smem stat stk spst spld
blocksum_kernel<0, false>                  256  40      0 8832   0    0    0
blocksum_kernel<0, true>                   256  63      0 8832   0    0    0
blocksum_kernel<1, false>                  256  40      0 8832   0    0    0
blocksum_kernel<1, true>                   256  63      0 8832   0    0    0
blocksum_kernel<2, false>                  256  48      0 8832   0    0    0
blocksum_kernel<2, true>                   256  60      0 8832   0    0    0
blocksum_kernel<3, false>                  256  48      0 8832   0    0    0
blocksum_kernel<3, true>                   256  57      0 8832   0    0    0
blocksum_kernel<4, false>                  256  40      0 8832   0    0    0
blocksum_kernel<5, false>                  256  40      0 8832   0    0    0
blocksum_kernel<6, false>                  256  48      0 8832   0    0    0
blocksum_deep_kernel<0, false>             256 127  34816    0   0    0    0
blocksum_deep_kernel<0, true>              256 127  34816    0   0    0    0
blocksum_deep_kernel<1, false>             256 128  34816    0   0    0    0
blocksum_deep_kernel<1, true>              256 128  34816    0   8    4    4
blocksum_deep_kernel<2, false>             256 124  34816    0   0    0    0
blocksum_deep_kernel<2, true>              256 127  34816    0   0    0    0
blocksum_deep_kernel<3, false>             256 128  34816    0   0    0    0
blocksum_deep_kernel<3, true>              256 128  34816    0   0    0    0
blocksum_deep_kernel<4, false>             256 127  34816    0   0    0    0
blocksum_deep_kernel<5, false>             256 128  34816    0   0    0    0
blocksum_deep_kernel<6, false>             256 125  34816    0   0    0    0
blocksum_wide_kernel<0, 16, false>         256 128  31744    0   0    0    0
blocksum_wide_kernel<0, 16, true>          256 128  31744    0   0    0    0
blocksum_wide_kernel<0, 32, false>         256 128  56320    0   0    0    0
blocksum_wide_kernel<0, 32, true>          256 128  56320    0   0    0    0
blocksum_wide_kernel<1, 16, false>         256 128  31744    0  16   12   16
blocksum_wide_kernel<1, 16, true>          256 128  31744    0   8    8    8
blocksum_wide_kernel<1, 32, false>         256 128  56320    0  64   60   72
blocksum_wide_kernel<1, 32, true>          256 128  56320    0  56   56   64
blocksum_wide_kernel<2, 16, false>         256 128  31744    0   0    0    0
blocksum_wide_kernel<2, 16, true>          256 128  31744    0   0    0    0
blocksum_wide_kernel<2, 32, false>         256 128  56320    0   0    0    0
blocksum_wide_kernel<2, 32, true>          256 128  56320    0   0    0    0
blocksum_wide_kernel<3, 16, false>         256 128  31744    0   0    0    0
blocksum_wide_kernel<3, 16, true>          256 128  31744    0   0    0    0
blocksum_wide_kernel<3, 32, false>         256 128  56320    0   0    0    0
blocksum_wide_kernel<3, 32, true>          256 128  56320    0   0    0    0
blocksum_mma_kernel<4, 16>                 256 124  44032    0   0    0    0
blocksum_mma_kernel<4, 32>                 256 116  76800    0   0    0    0
blocksum_mma_kernel<5, 16>                 256  82  44032    0   0    0    0
blocksum_mma_kernel<5, 32>                 256  66  76800    0   0    0    0
blocksum_mma_kernel<6, 16>                 256  60  44032    0   0    0    0
blocksum_mma_kernel<6, 32>                 256  68  76800    0   0    0    0
rowsum_reduce_kernel                       256  31      0    0   0    0    0
sampler_generic_kernel<0, false, false>    256  64      0 8832   0    0    0
sampler_generic_kernel<0, false, true>     256  48      0 8832   0    0    0
sampler_generic_kernel<0, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<0, true, true>      256 118      0 8848   0    0    0
sampler_generic_kernel<1, false, false>    256  64      0 8832   0    0    0
sampler_generic_kernel<1, false, true>     256  48      0 8832   0    0    0
sampler_generic_kernel<1, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<1, true, true>      256 118      0 8848   0    0    0
sampler_generic_kernel<2, false, false>    256  48      0 8832   0    0    0
sampler_generic_kernel<2, false, true>     256  48      0 8832   0    0    0
sampler_generic_kernel<2, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<2, true, true>      256 118      0 8848   0    0    0
sampler_generic_kernel<3, false, false>    256  62      0 8832   0    0    0
sampler_generic_kernel<3, false, true>     256  59      0 8832   0    0    0
sampler_generic_kernel<3, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<3, true, true>      256 118      0 8848   0    0    0
sampler_generic_kernel<4, false, false>    256  64      0 8832   0    0    0
sampler_generic_kernel<4, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<5, false, false>    256  64      0 8832   0    0    0
sampler_generic_kernel<5, true, false>     256 118      0 8848   0    0    0
sampler_generic_kernel<6, false, false>    256  48      0 8832   0    0    0
sampler_generic_kernel<6, true, false>     256 118      0 8848   0    0    0
sampler_wide_kernel<0, 16, false, false>   256 128  31744    0   0    0    0
sampler_wide_kernel<0, 16, false, true>    256 128  31744    0   8    8    8
sampler_wide_kernel<0, 16, true, false>    256 128  31744   16   0    0    0
sampler_wide_kernel<0, 16, true, true>     256 128  31744   16   8    8    8
sampler_wide_kernel<0, 32, false, false>   256 128  56320    0   0    0    0
sampler_wide_kernel<0, 32, false, true>    256 128  56320    0  40   40   64
sampler_wide_kernel<0, 32, true, false>    256 128  56320   16   0    0    0
sampler_wide_kernel<0, 32, true, true>     256 128  56320   16  40   40   64
sampler_wide_kernel<1, 16, false, false>   256 128  31744    0  24   20   20
sampler_wide_kernel<1, 16, false, true>    256 128  31744    0   0    0    0
sampler_wide_kernel<1, 16, true, false>    256 128  31744   16   0    0    0
sampler_wide_kernel<1, 16, true, true>     256 128  31744   16   8    8    8
sampler_wide_kernel<1, 32, false, false>   256 128  56320    0  24   24   32
sampler_wide_kernel<1, 32, false, true>    256 128  56320    0   0    0    0
sampler_wide_kernel<1, 32, true, false>    256 128  56320   16   0    0    0
sampler_wide_kernel<1, 32, true, true>     256 128  56320   16  40   32   60
sampler_wide_kernel<2, 16, false, false>   256 128  31744    0   0    0    0
sampler_wide_kernel<2, 16, false, true>    256 128  31744    0   0    0    0
sampler_wide_kernel<2, 16, true, false>    256 128  31744   16   0    0    0
sampler_wide_kernel<2, 16, true, true>     256 128  31744   16  16   16   32
sampler_wide_kernel<2, 32, false, false>   256 128  56320    0   0    0    0
sampler_wide_kernel<2, 32, false, true>    256 128  56320    0   0    0    0
sampler_wide_kernel<2, 32, true, false>    256 128  56320   16   0    0    0
sampler_wide_kernel<2, 32, true, true>     256 128  56320   16  56   84   68
sampler_wide_kernel<3, 16, false, false>   256 128  31744    0   8    8   16
sampler_wide_kernel<3, 16, false, true>    256 128  31744    0  32   28   32
sampler_wide_kernel<3, 16, true, false>    256 128  31744   16   0    0    0
sampler_wide_kernel<3, 16, true, true>     256 128  31744   16   0    0    0
sampler_wide_kernel<3, 32, false, false>   256 128  56320    0   0    0    0
sampler_wide_kernel<3, 32, false, true>    256 128  56320    0  40   36   60
sampler_wide_kernel<3, 32, true, false>    256 128  56320   16   0    0    0
sampler_wide_kernel<3, 32, true, true>     256 128  56320   16   0    0    0
sampler_mma_kernel<4, 16, false>           256 123  44032    0   0    0    0
sampler_mma_kernel<4, 16, true>            256 126  44032   16   0    0    0
sampler_mma_kernel<4, 32, false>           256 120  76800    0   0    0    0
sampler_mma_kernel<4, 32, true>            256 121  76800   16   0    0    0
sampler_mma_kernel<5, 16, false>           256  84  44032    0   0    0    0
sampler_mma_kernel<5, 16, true>            256 120  44032   16   0    0    0
sampler_mma_kernel<5, 32, false>           256  71  76800    0   0    0    0
sampler_mma_kernel<5, 32, true>            256 120  76800   16   0    0    0
sampler_mma_kernel<6, 16, false>           256  64  44032    0   0    0    0
sampler_mma_kernel<6, 16, true>            256 120  44032   16   0    0    0
sampler_mma_kernel<6, 32, false>           256  72  76800    0   0    0    0
sampler_mma_kernel<6, 32, true>            256 120  76800   16   0    0    0
weighted_kv_scalar_kernel<0, false, float> 128  32      0    0   0    0    0
weighted_kv_scalar_kernel<0, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<1, false, float> 128  32      0    0   0    0    0
weighted_kv_scalar_kernel<1, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<2, false, float> 128  40      0    0   0    0    0
weighted_kv_scalar_kernel<2, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<3, false, float> 128  32      0    0   0    0    0
weighted_kv_scalar_kernel<3, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<4, false, float> 128  32      0    0   0    0    0
weighted_kv_scalar_kernel<4, false, bf16>  128  32      0    0   0    0    0
weighted_kv_scalar_kernel<4, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<4, true, bf16>   128  32      0   16   0    0    0
weighted_kv_scalar_kernel<5, false, float> 128  32      0    0   0    0    0
weighted_kv_scalar_kernel<5, false, bf16>  128  32      0    0   0    0    0
weighted_kv_scalar_kernel<5, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<5, true, bf16>   128  32      0   16   0    0    0
weighted_kv_scalar_kernel<6, false, float> 128  31      0    0   0    0    0
weighted_kv_scalar_kernel<6, false, bf16>  128  32      0    0   0    0    0
weighted_kv_scalar_kernel<6, true, float>  128  32      0   16   0    0    0
weighted_kv_scalar_kernel<6, true, bf16>   128  32      0   16   0    0    0
weighted_kv_vec_kernel<0, false, 4, float> 128  44      0    0   0    0    0
weighted_kv_vec_kernel<0, false, 8, float> 128  48      0    0   0    0    0
weighted_kv_vec_kernel<0, true, 4, float>  128  79      0   16   0    0    0
weighted_kv_vec_kernel<0, true, 8, float>  128  79      0   16   0    0    0
weighted_kv_vec_kernel<1, false, 4, float> 128  96      0    0   0    0    0
weighted_kv_vec_kernel<1, false, 8, float> 128  96      0    0   8    4    4
weighted_kv_vec_kernel<1, true, 4, float>  128  94      0   16   0    0    0
weighted_kv_vec_kernel<1, true, 8, float>  128  94      0   16   0    0    0
weighted_kv_vec_kernel<2, false, 4, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<2, false, 8, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<2, true, 4, float>  128  94      0   16   0    0    0
weighted_kv_vec_kernel<2, true, 8, float>  128  94      0   16   0    0    0
weighted_kv_vec_kernel<3, false, 4, float> 128  48      0    0   0    0    0
weighted_kv_vec_kernel<3, false, 8, float> 128  48      0    0   0    0    0
weighted_kv_vec_kernel<3, true, 4, float>  128  80      0   16   0    0    0
weighted_kv_vec_kernel<3, true, 8, float>  128  80      0   16   0    0    0
weighted_kv_vec_kernel<4, false, 4, float> 128  56      0    0   0    0    0
weighted_kv_vec_kernel<4, false, 4, bf16>  128  40      0    0   0    0    0
weighted_kv_vec_kernel<4, false, 8, float> 128  56      0    0   0    0    0
weighted_kv_vec_kernel<4, false, 8, bf16>  128  32      0    0   0    0    0
weighted_kv_vec_kernel<4, true, 4, float>  128  72      0   16   0    0    0
weighted_kv_vec_kernel<4, true, 4, bf16>   128  48      0   16   0    0    0
weighted_kv_vec_kernel<4, true, 8, float>  128  72      0   16   0    0    0
weighted_kv_vec_kernel<4, true, 8, bf16>   128  48      0   16   0    0    0
weighted_kv_vec_kernel<5, false, 4, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<5, false, 4, bf16>  128  56      0    0   0    0    0
weighted_kv_vec_kernel<5, false, 8, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<5, false, 8, bf16>  128  56      0    0   0    0    0
weighted_kv_vec_kernel<5, true, 4, float>  128 115      0   16   0    0    0
weighted_kv_vec_kernel<5, true, 4, bf16>   128  64      0   16   0    0    0
weighted_kv_vec_kernel<5, true, 8, float>  128 114      0   16   0    0    0
weighted_kv_vec_kernel<5, true, 8, bf16>   128  64      0   16   0    0    0
weighted_kv_vec_kernel<6, false, 4, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<6, false, 4, bf16>  128  55      0    0   0    0    0
weighted_kv_vec_kernel<6, false, 8, float> 128  92      0    0   0    0    0
weighted_kv_vec_kernel<6, false, 8, bf16>  128  55      0    0   0    0    0
weighted_kv_vec_kernel<6, true, 4, float>  128  96      0   16   0    0    0
weighted_kv_vec_kernel<6, true, 4, bf16>   128  53      0   16   0    0    0
weighted_kv_vec_kernel<6, true, 8, float>  128  96      0   16   0    0    0
weighted_kv_vec_kernel<6, true, 8, bf16>   128  53      0   16   0    0    0
flash_fwd_kernel<float, 32, false>         256 168 104448    0   0    0    0
flash_fwd_kernel<float, 32, true>          256 168 104448    0   0    0    0
flash_fwd_kernel<float, 64, false>         256 168 137216    0   0    0    0
flash_fwd_kernel<float, 64, true>          256 168 137216    0   0    0    0
flash_fwd_kernel<float, 128, false>        256 220 202752    0   0    0    0
flash_fwd_kernel<float, 128, true>         256 226 202752    0   0    0    0
flash_mma_kernel<32, false>                256 116  30720    0   0    0    0
flash_mma_kernel<32, true>                 256 120  30720    0   0    0    0
flash_mma_kernel<64, false>                256 145  55296    0   0    0    0
flash_mma_kernel<64, true>                 256 154  55296    0   0    0    0
flash_mma_kernel<128, false>               256 205 104448    0   0    0    0
flash_mma_kernel<128, true>                256 212 104448    0   0    0    0
kde_decode_kernel<float, float>            256 122 232448    0   0    0    0
kde_decode_kernel<float, bf16>             256 124 232448    0   0    0    0
kde_decode_kernel<bf16, float>             256 122 232448    0   0    0    0
kde_decode_kernel<bf16, bf16>              256 124 232448    0   0    0    0
kde_spread_kernel<float, float, false>     256 255 232448    0  56   68   52
kde_spread_kernel<float, float, true>      256 252 232448    0   0    0    0
kde_spread_kernel<float, bf16, false>      256 255 232448    0 688 1188 1008
kde_spread_kernel<float, bf16, true>       256 255 232448    0  24   20   20
kde_spread_kernel<bf16, float, false>      256 255 232448    0  40   56   48
kde_spread_kernel<bf16, float, true>       256 254 232448    0   0    0    0
kde_spread_kernel<bf16, bf16, false>       256 255 232448    0 688 1180 1000
kde_spread_kernel<bf16, bf16, true>        256 255 232448    0  24   20   20
"""
RESOURCES = {}
for _line in _TABLE.strip().splitlines():
    if _line.startswith("#"):
        continue
    _name, *_nums = _line.rsplit(None, 7)
    RESOURCES[_name] = Resource(*map(int, _nums))
del _line, _name, _nums

#: the kernel families, in the order of ``kde::FuncId``
#: (csrc/kde_func.cuh): ``kde_func_attributes``' kernel id
KERNEL_IDS = ("blocksum_kernel", "blocksum_deep_kernel",
              "blocksum_wide_kernel", "blocksum_mma_kernel",
              "rowsum_reduce_kernel", "sampler_generic_kernel",
              "sampler_wide_kernel", "sampler_mma_kernel",
              "weighted_kv_scalar_kernel", "weighted_kv_vec_kernel",
              "flash_fwd_kernel", "flash_mma_kernel", "kde_decode_kernel",
              "kde_spread_kernel")
#: template type arguments as the packed instance gives them
_TYPES = {"float": 0, "bf16": 1}


def template_args(name: str):
    """(family, [args]) of an instance name, the args as written."""
    family, _, rest = name.partition("<")
    return family, [a.strip() for a in rest.rstrip(">").split(",") if rest]


def instance_code(name: str) -> int:
    """``kde_func_attributes``' packed instance: template argument i in
    byte i (bool 0 / 1; float 0, bf16 1)."""
    code = 0
    for i, a in enumerate(template_args(name)[1]):
        v = _TYPES[a] if a in _TYPES else int(a == "true") \
            if a in ("true", "false") else int(a)
        code |= v << (8 * i)
    return code


def instance_name(demangled: str) -> str:
    """The ``RESOURCES`` name of a demangled kernel symbol: ``void
    (anonymous namespace)::sampler_mma_kernel<4, 16, true>((anonymous
    namespace)::Args)`` -> ``sampler_mma_kernel<4, 16, true>`` (also in
    cu++filt's spelling, ``<unnamed>::`` and ``(int)4, (bool)1``)."""
    text = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", demangled)
    text = re.sub(r"\(bool\)([01])",
                  lambda m: ("false", "true")[int(m.group(1))], text)
    head = re.sub(r"\(int\)", "", text).split("(")[0]
    return head.removeprefix("void ").strip().replace("__nv_bfloat16",
                                                      "bf16")


def ptxas_resources(log: str, demangle) -> dict:
    """Instance name -> (regs, static, stack, spill stores, spill loads)
    of each entry function in an nvcc ``-Xptxas=-v`` log; ``demangle``
    maps a list of mangled symbols to their demangled names (``cu++filt``
    on the card)."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), 0, 0, 0, 0, 0]
            entries.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur[3:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                      line)
        if m and cur is not None:
            cur[1], cur[2] = int(m.group(1)), int(m.group(2) or 0)
    names = demangle([e[0] for e in entries])
    return {instance_name(n): tuple(e[1:]) for n, e in zip(names, entries)}


class CardResource(NamedTuple):
    threads: int        # the block size the launcher uses
    regs: int           # cudaFuncAttributes::numRegs
    static: int         # ::sharedSizeBytes
    smem: int           # the dynamic shared memory the launcher asks for
    local: int          # ::localSizeBytes
    max_threads: int    # ::maxThreadsPerBlock
    ctas: int           # cudaOccupancyMaxActiveBlocksPerMultiprocessor


def card_resources(name: str, device=None) -> CardResource:
    """What the card reports for instance ``name`` of ``RESOURCES``
    (``kde_func_attributes``: ``cudaFuncGetAttributes``, and the occupancy
    API at the launch's own block size and dynamic shared memory).  No
    launch path calls it."""
    import ctypes
    import torch
    from repro_torch.kernels import build as _build
    out = [ctypes.c_int(0) for _ in CardResource._fields]
    with torch.cuda.device(_index(device)):
        err = _build.library().kde_func_attributes(
            KERNEL_IDS.index(template_args(name)[0]), instance_code(name),
            *map(ctypes.byref, out))
    _build.check(err, f"kde_func_attributes({name})")
    return CardResource(*(o.value for o in out))


def resource_ctas(name: str, lim: HopperLimits = H100_SXM) -> int:
    """``ctas_per_sm`` of instance ``name``'s ``RESOURCES`` entry."""
    r = RESOURCES[name]
    return ctas_per_sm(r.threads, r.regs, r.smem + r.static, lim)


# ------------------------------------------------------------ the plans
#: query rows of a tile: kde_tile.cuh's generic tile and kde_wide.cuh's
#: wide, deep and tensor-core tiles
GENERIC_BM, WIDE_BM = 64, 128
#: columns a CTA stages at a time: the generic tile's chunk, the 128-row
#: tiles' chunk
GENERIC_BN, TILE_BN = 64, 128
#: widest d the wide and tensor-core tiles take (d padded to 16 or 32)
MAX_WIDE_D = 32
#: the dynamic shared memory one CTA may opt in to (``H100_SXM``;
#: csrc/kde_attention.cu ``MAX_SMEM``): the budget every tile fits under,
#: the counterpart of the reference's ``VMEM_BUDGET``
SMEM_BUDGET = H100_SXM.smem_per_cta_optin
#: lanes the weighted kernels' vector instance reads one gathered row
#: with (4 coordinates a lane), by the widest d each count covers
WEIGHTED_LANES = ((16, 4), (32, 8))

#: the instances each plan's CTA count covers: ``group_for`` sizes every
#: sampler grid and the blocksum's 128-row grids with ``CTAS_PER_SM``;
#: ``rowsum_plan`` splits for ``GENERIC_CTAS_PER_SM`` on the generic tile
PLAN_FAMILIES = {
    "CTAS_PER_SM": ("sampler_generic_kernel", "sampler_wide_kernel",
                    "sampler_mma_kernel", "blocksum_wide_kernel",
                    "blocksum_deep_kernel", "blocksum_mma_kernel"),
    "GENERIC_CTAS_PER_SM": ("blocksum_kernel",)}


def plan_ctas(which: str, lim: HopperLimits = H100_SXM) -> int:
    """The CTAs an SM that plan count ``which`` of ``PLAN_FAMILIES`` holds
    for every one of its instances: the least ``resource_ctas``."""
    fams = PLAN_FAMILIES[which]
    return min(resource_ctas(n, lim) for n in RESOURCES
               if template_args(n)[0] in fams)


#: CTAs an SM the sampler's and the 128-row blocksum tiles hold at once
#: (2 on the H100: the 128-row tiles at up to 128 registers, the generic
#: tile with the draw at 118)
CTAS_PER_SM = plan_ctas("CTAS_PER_SM")
#: CTAs an SM a generic-tile rowsum's split aims for (4 on the H100: its
#: 64-row tile at up to 63 registers)
GENERIC_CTAS_PER_SM = plan_ctas("GENERIC_CTAS_PER_SM")


def weighted_lanes(d: int) -> int:
    """Lanes the weighted kernels' vector instance reads a row of width
    ``d`` with (``WEIGHTED_LANES``); 1 (the scalar instance, a lane a
    row) past ``MAX_WIDE_D`` or when d % 4 != 0."""
    if d % 4 == 0:
        for widest, lanes in WEIGHTED_LANES:
            if d <= widest:
                return lanes
    return 1


@functools.lru_cache(maxsize=None)
def pallas_tiles(m: int, n: int, d: int, precision: str = "f32"):
    """(bm, bn) of the rowsum / blocksum CUDA kernels at (m, n, d): the
    query rows of the tile ``kde_rowsum.kernel.blocksum_plan`` takes for
    16-byte-aligned operands (128 on the wide, deep and tensor-core tiles,
    64 on the generic one) and the columns a CTA stages a chunk at a time
    (``TILE_BN`` / ``GENERIC_BN``).  The reference pads its operands to its
    tile; the port's kernels mask the ragged edges and take any m and
    n."""
    from repro_torch.kernels.kde_rowsum.kernel import blocksum_plan
    plan = blocksum_plan(m, max(n, 1), d, max(n, 1), True,
                         precision=precision)
    return plan.bm, GENERIC_BN if plan.instance == 0 else TILE_BN


# Column budget of the bf16 sweep tile (kde_sampler.ref.kv_block_sums_bf16):
# the widest power of two whose (1024, cols) f32 value tile plus its
# (64, cols) bf16 operand tile fit in half the H100's 50 MiB L2 (the
# reference's m <= 1024, d <= 64 range): cols (1024 * 4 + 64 * 2) = 4224
# cols bytes <= 26,214,400 gives cols <= 6206, so 4096 (17.3 MB; 8192
# would take 34.6 MB).  The reference's 2048 was its host backend's knee.
SWEEP_TILE_COLS = 4096


@functools.lru_cache(maxsize=None)
def sweep_blocks_per_tile(bn: int, d: int,
                          target_cols: int = SWEEP_TILE_COLS) -> int:
    """Blocks per column tile of the bf16 blocked sweep (>= 1)."""
    return max(1, int(target_cols) // max(int(bn), 1))
