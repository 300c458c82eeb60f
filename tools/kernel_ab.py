#!/usr/bin/env python3
"""Time the sampler and kde_hash kernels of one source tree on the card.

    python3 tools/kernel_ab.py --src SRC_DIR [--reps 50] [--group G]

Imports ``repro_torch`` from ``SRC_DIR`` (the ``src`` directory of this
checkout, or of another commit unpacked beside it), builds that tree's
kernels, and times four wrappers at their main-path shapes, on inputs
drawn from a fixed seed on the card:

- sample_block: m 1024, n 65536, d 16, bn 256, gaussian, int64 own;
- masked_blocksum: the same at m 4096;
- weighted_kv: m 1024, t 1152 uniform columns of n 262144, d 16;
- weighted_kv_sum: the same at t 192.

Prints one JSON line: for each wrapper ``ms`` (CUDA events around
back-to-back calls, host cost included), ``device_ms`` (torch.profiler:
every device activity of a call, summed), ``launches`` (device activities
a call), ``host_us`` (host clock per call, no synchronize inside) and
``max_abs_err`` against the plain version (for sample_block, of the block
sums, with ``blk_equal``, the share of rows drawing the plain version's
block); and the card's name and power limit.  ``--group G`` sets the
level-1 blocks a CTA of the sampler kernels sums (trees that have the
option).  Two trees compare only within one machine, in turns: A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--group", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_sampler import kernel as sk

    build.library()
    if args.group is not None:
        sk.group_for = lambda *_: args.group
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(65536, 16, generator=gen, device=dev)
    src = torch.randint(0, 65536, (4096,), generator=gen, device=dev)
    q4, own4 = x[src], src // 256
    q1, own1 = q4[:1024].contiguous(), own4[:1024].contiguous()
    g = -torch.log(-torch.log(torch.rand((1024, 256), generator=gen,
                                         device=dev).clamp_(min=1e-38)))
    xh = torch.randn(262144, 16, generator=gen, device=dev)
    qh = torch.randn(1024, 16, generator=gen, device=dev)
    sargs = (q1, x, own1, g, "gaussian", 1.0, 1.0, 256)
    margs = (q4, x, own4, "gaussian", 1.0, 1.0, 256)
    calls = {
        "sample_block": (lambda: sk.sample_block_cuda(*sargs),
                         lambda: sk.sample_block_plain(*sargs)),
        "masked_blocksum": (lambda: sk.masked_blocksum_cuda(*margs),
                            lambda: sk.masked_blocksum_plain(*margs)),
    }
    for name, t in (("weighted_kv", 1152), ("weighted_kv_sum", 192)):
        cols = torch.randint(0, 262144, (1024, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((1024, t), generator=gen, device=dev) * 256.0
        wargs = (qh, xh, cols, wgt, "gaussian", 1.0)
        calls[name] = (lambda n=name, a=wargs: getattr(hk, n + "_cuda")(*a),
                       lambda n=name, a=wargs: getattr(hk, n + "_plain")(*a))

    out = {}
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        err = {}
        if name == "sample_block":
            err["blk_equal"] = float((got[0] == want[0]).float().mean())
            got, want = got[3], want[3]
        err["max_abs_err"] = float((got - want).abs().max())
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        host = (time.perf_counter() - t0) / args.reps * 1e6
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in ev)
        out[name] = dict(ms=start.elapsed_time(end) / args.reps,
                         device_ms=dev_us / args.reps / 1e3 if ev else None,
                         launches=sum(e.count for e in ev) / args.reps,
                         host_us=host, **err)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(json.dumps({"src": args.src, "group": args.group,
                      "card": card.strip().splitlines()[0], "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
