"""``chip_smoke.py``'s lm-mesh phase (phase 19) with one NCCL rank a card.

    python tools/lm_mesh_cards.py        # on a host with 4 cards

Phase 19 puts its 4 ranks on one card in a gloo group (NCCL refuses two
ranks on one device), so every collective is staged through the host and
its walls are correctness numbers.  This runs the same phase -- the same
checks (a)-(g) against the unsharded port on rank 0's card (the
context-parallel prefill (f) and train step (g) included), the same
printed lines (their "gloo" wording is the phase's) -- with rank r on
cuda:r and the group on NCCL, where the collectives move over NVLink.
Needs as many cards as ``chip_smoke.MESH_P`` (4).  Exits 0 when every
check passes.
"""
from __future__ import annotations

import datetime
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def card_rank(rank, world, backend, store, out, job):
    """``chip_smoke.mesh_rank`` with the rank on its own card and the
    group on NCCL."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    torch.zeros(1, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=cs.MESH_TIMEOUT))
    res = {"lm_mesh_main": cs.lmm_job_main,
           "lm_mesh_solo": cs.lmm_job_solo}[job](rank, world)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


cs.mesh_rank = card_rank

if __name__ == "__main__":
    import torch
    n = torch.cuda.device_count()
    if n < cs.MESH_P:
        print(f"lm_mesh_cards: needs {cs.MESH_P} cards, found {n}",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"[lm-mesh cards] torch {torch.__version__}, {n} x "
           f"{torch.cuda.get_device_name(0)}; {cs.MESH_P} NCCL ranks, one "
           f"a card")
    from repro_torch.kernels import build
    build.library()
    t0 = time.perf_counter()
    launches, secs, _ = cs.phase_lm_mesh()
    cs.log(f"[lm-mesh cards] launches {launches}; secs {secs}; "
           f"{time.perf_counter() - t0:.1f} s")
    cs.log(cs.card_line())
