"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step as one
rank of the production mesh -- the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 host devices standing
in for 2 pods x 256 chips.  The port has no compiler to ask: its step is
an SPMD program, so ``lower_cell`` runs rank 0's program on a ``"fake"``
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks under
``FakeTensorMode``.  Nothing is spawned, no data moves and nothing is
compiled; every tensor has its shape and dtype, every collective goes
through the wrapper (``distributed.collectives``), which counts it.  The
record keeps the reference's keys:
  * ``memory``: ``argument_bytes`` exactly, from the rank's shard shapes
    (parameters, AdamW moments, the batch or the cache shard), outputs
    and donated aliases likewise; ``temp_bytes`` / ``peak_estimate_bytes``
    are null (no allocator runs under fake tensors; ``memory_note`` says
    so);
  * ``raw_cost``: ``FlopCounterMode``'s FLOPs of the traced rank program
    ("bytes accessed" null: nothing counts them);
  * ``collectives``: the rank's realized collectives by kind and bytes
    (``roofline.analysis.collective_bytes``);
  * ``roofline``: the analytic terms of ``roofline/flops.py`` against the
    H100 spec.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --arch qwen2_5_14b --shape prefill_32k \
      --seq-mode-prefill
  python -m repro_torch.launch.dryrun --all --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, get_config
from repro_torch.data.pipeline import input_specs, token_split
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shard
from repro_torch.distributed import state as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.roofline.analysis import collective_bytes, roofline_terms
from repro_torch.roofline.flops import cell_cost
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_decode_step, make_prefill_step, make_train_step

KDE_DECODE_CFG = {"top_p": 16, "bk": 512, "stride": 16}

MEMORY_NOTE = ("temp / peak not measured: fake tensors allocate nothing, "
               "so no allocator sees the step's transients")


def _uses_kde_decode(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k exact attention would be quadratic-in-context; attention
    archs run it with the paper's KDE attention (DESIGN.md §3/§8)."""
    return (shape.name == "long_500k" and not cfg.attention_free
            and shape.kind == "decode")


def fake_group(world: int) -> None:
    """Make the process group a ``"fake"`` one of ``world`` ranks, this
    process rank 0 (re-made when the world differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        C._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               donate: bool = True, microbatch: int = 4,
               seq_mode_prefill: bool = False) -> Dict[str, Any]:
    """Trace one cell on rank 0 of a fake production mesh and return its
    record.  ``seq_mode_prefill`` runs a prefill cell context-parallel
    (``activation_sharding(seq_mode=True)``), as the reference's does: seq
    mode applies to prefill shapes only."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    shape = SHAPES[shape_name]
    return trace_cell(get_config(arch), shape, mesh, donate=donate,
                      microbatch=microbatch,
                      seq_mode=seq_mode_prefill and shape.kind == "prefill")


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               donate: bool = True, microbatch: int = 4,
               seq_mode: bool = False) -> Dict[str, Any]:
    """The record of ``cfg``'s ``shape`` step traced as rank 0 of ``mesh``
    (a ``"cpu"`` mesh on the current fake group), under
    ``activation_sharding(seq_mode=seq_mode)``: ``record["seq_mode"]``
    says whether seq mode was asked for, ``record["seq_layout"]`` the
    layout the step took (``layers.seq_layout``; None without seq mode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    chips = int(mesh.mesh.numel())
    kde = _uses_kde_decode(cfg, shape)
    record: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.mesh.shape), "chips": chips,
        "kde_decode": kde, "seq_mode": bool(seq_mode),
    }
    t0 = time.time()
    baxes = shard.batch_axes(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            L.activation_sharding(mesh, baxes, seq_mode=seq_mode):
        model = T.cast_params(T.init_params(cfg, 0, device="cpu"),
                              torch.bfloat16)
        D.shard_model(model, mesh)
        params = list(model.parameters())
        specs = input_specs(cfg, shape)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in specs.items()}
        local_batch = [T.local_rows(v)[0] for v in batch.values()]
        C.reset_collectives()
        fc = FlopCounterMode(display=False)
        if shape.kind == "train":
            opt_state = opt.init_adamw(model)
            moments = list(opt_state.m.values()) + list(opt_state.v.values())
            step = make_train_step(cfg, remat=True, microbatch=microbatch)
            record["microbatch"] = microbatch
            with fc:
                _, _, metrics = step(model, opt_state, batch)
            args = params + moments + local_batch
            outs = params + moments + list(metrics.values())
            alias = params + moments if donate else []
        elif shape.kind == "prefill":
            with fc:
                logits = make_prefill_step(cfg)(model, batch)
            args, outs, alias = params + local_batch, [logits], []
        else:
            split = token_split(cfg, shape)
            enc_len = split["frontend"] if (cfg.is_encdec
                                            or cfg.frontend != "none") else 0
            cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 torch.bfloat16, enc_len=max(enc_len, 1),
                                 device="cpu")
            step = make_decode_step(cfg, impl="kde" if kde else "xla",
                                    kde_cfg=KDE_DECODE_CFG if kde else None)
            tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
            with fc:
                nxt, logits, cache = step(model, cache, tokens,
                                          shape.seq_len - 1)
            tok_l = T.local_rows(tokens)[0] \
                if cache.specs[next(iter(cache.specs))][1] is not None \
                else tokens
            args = params + list(cache.values()) + [tok_l]
            outs = [nxt, logits] + list(cache.values())
            alias = list(cache.values()) if donate else []
        flops = float(fc.get_total_flops())
        record["seq_layout"] = L._ACT["seq_layout"]
    record["lower_s"] = round(time.time() - t0, 1)
    record["compile_s"] = 0.0
    record["memory"] = {
        "argument_bytes": _nbytes(args), "output_bytes": _nbytes(outs),
        "temp_bytes": None, "alias_bytes": _nbytes(alias),
        "peak_estimate_bytes": None}
    record["memory_note"] = MEMORY_NOTE
    record["raw_cost"] = {"flops": flops, "bytes accessed": None}
    cs = collective_bytes()
    record["collectives"] = {
        "bytes_by_kind": {k: float(v) for k, v in cs.bytes_by_kind.items()},
        "count_by_kind": cs.count_by_kind,
        "total_bytes_per_device": float(cs.total_bytes),
        "unresolved_trips": cs.unresolved_trips,
    }
    cost = cell_cost(cfg, shape, kde_decode=kde)
    rl = roofline_terms(cost.flops, cost.model_flops, cost.hbm_bytes,
                        cs.total_bytes, chips, record["raw_cost"])
    record["roofline"] = rl.as_dict()
    record["ok"] = True
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    ap.add_argument("--archs", type=str, default="",
                    help="comma-separated subset for --all")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells even if cached ok")
    ap.add_argument("--seq-mode-prefill", action="store_true",
                    help="run prefill cells context-parallel (the sequence "
                         "over 'model')")
    ap.add_argument("--microbatch", type=int, default=4)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        archs = args.archs.split(",") if args.archs else ARCH_IDS
        for a in archs:
            for s in SHAPES:
                cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = set() if args.force else {
        (r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    for arch, sh in cells:
        if (arch, sh, mesh_name) in done:
            print(f"[skip] {arch} x {sh} x {mesh_name} (cached)")
            continue
        print(f"[dryrun] {arch} x {sh} x {mesh_name} ...", flush=True)
        try:
            rec = lower_cell(arch, sh, args.multi_pod,
                             microbatch=args.microbatch,
                             seq_mode_prefill=args.seq_mode_prefill)
            rl = rec["roofline"]
            print(f"  ok: seq_mode={rec['seq_mode']} "
                  f"layout={rec['seq_layout']} trace={rec['lower_s']}s "
                  f"args/dev={rec['memory']['argument_bytes']/2**30:.2f}GiB "
                  f"compute={rl['compute_s']*1e3:.2f}ms "
                  f"memory={rl['memory_s']*1e3:.2f}ms "
                  f"collective={rl['collective_s']*1e3:.2f}ms "
                  f"dominant={rl['dominant']}", flush=True)
        except Exception as e:  # record failures -- they are bugs to fix
            rec = {"arch": arch, "shape": sh, "mesh": mesh_name, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAIL: {rec['error']}", flush=True)
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == sh
                           and r["mesh"] == mesh_name)]
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells ok")


if __name__ == "__main__":
    main()
