"""The walk-resident layout's sizes (DESIGN.md §14), carried over from the
reference's ``repro.kernels.tuning`` unchanged.

These values fix the walk programs' eval counters, which must equal the
reference's exactly, so they are copied, not re-derived for the card.  The
reference's other choosers (its VMEM budget and tile sizes) are TPU
mechanisms and stay out (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import functools

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
