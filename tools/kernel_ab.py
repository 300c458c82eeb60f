#!/usr/bin/env python3
"""Time the kernels of one source tree on the card.

    python3 tools/kernel_ab.py --src SRC_DIR [--reps 50] [--group G]
                               [--only NAME,...]

Imports ``repro_torch`` from ``SRC_DIR`` (the ``src`` directory of this
checkout, or of another commit unpacked beside it), builds that tree's
kernels, and times these wrappers at their main-path shapes, on inputs
drawn from a fixed seed on the card:

- rowsum: m 1024, n 16384, d 784, laplacian (the LRA's row norms);
- blocksum: m 1024, n 65536, d 16, bn 256, gaussian (the exact degrees);
- sample_block: m 1024, n 65536, d 16, bn 256, gaussian, int64 own;
- masked_blocksum: the same at m 4096;
- weighted_kv: m 1024, t 1152 uniform columns of n 262144, d 16;
- weighted_kv_sum: the same at t 192;
- flash / flash_bf16: the yi-6b prefill, (1, 32, 8192, 128), 4 kv-heads,
  causal, f32 and bf16 operands (v a transposed view, as the model hands
  it);
- kde_decode / kde_decode_bf16: the serve shape, q (4, 32, 128), cache (4,
  4, 544, 128), top_p 4, bk 32, stride 4, kv_valid 527, f32 and bf16;
- kde_decode_long: the long_500k cell on one layer's 1.07 GB bf16 cache,
  q (1, 32, 128), cache (1, 4, 524288, 128), top_p 16, bk 512, stride 16;
- <name>_bf16 for rowsum (m 64, n 1,048,576, d 16, gaussian at bandwidth
  4, N(0, 0.5) data: the bench_kde sweep's largest batch), blocksum,
  sample_block, masked_blocksum, weighted_kv and weighted_kv_sum: their
  f32 shapes (gaussian at bandwidth 1) at precision="bf16"; the two
  weighted kernels gather the dataset's bf16-resident copy where the tree
  takes one (``kde_hash.kernel.BF16_ROWS``), as the hashed estimator hands
  it, else the f32 rows; weighted_kv_bf16_f32x times the f32 rows at
  bf16 in any tree.

Prints one JSON line: for each wrapper ``ms`` (CUDA events around
back-to-back calls, host cost included), ``device_ms`` (torch.profiler:
every device activity of a call, summed), ``launches`` (device activities
a call), ``split`` (``device_ms`` by kernel name, e.g. a rowsum's block
sums and its reduce), ``host_us`` (host clock per call, no synchronize
inside) and
``max_abs_err`` against the plain version (for sample_block, of the block
sums, with ``blk_equal``, the share of rows drawing the plain version's
block; for bf16 outputs also ``max_bf16_steps``, beyond atol 1e-5); and
the card's name and power limit.  ``--group G`` sets the level-1 blocks a
CTA of the sampler kernels sums (trees that have the option); ``--only``
times the named wrappers alone.  Two trees compare only within one
machine, in turns: A, B, B, A.
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
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
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
    xl = torch.rand(16384, 784, generator=gen, device=dev)
    rargs = (xl[:1024].contiguous(), xl, "laplacian", 1.0 / 100.0)
    bargs = (q1, x, "gaussian", 1.0, 1.0, 256)
    calls = {
        "rowsum": (lambda: rk.rowsum_cuda(*rargs),
                   lambda: rk.rowsum_plain(*rargs)),
        "blocksum": (lambda: rk.blocksum_cuda(*bargs),
                     lambda: rk.blocksum_plain(*bargs)),
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

    for name, dtype in (("flash", torch.float32),
                        ("flash_bf16", torch.bfloat16)):
        q = torch.randn((1, 32, 8192, 128), generator=gen, device=dev)
        k = torch.randn((1, 4, 8192, 128), generator=gen, device=dev)
        v = torch.randn((1, 8192, 4, 128), generator=gen,
                        device=dev).transpose(1, 2)
        q, kp, vp, kw = (q.to(dtype), *fops.flash_args(
            q.to(dtype), k.to(dtype), v.to(dtype)))
        calls[name] = (
            lambda a=(q, kp, vp), kw=kw: fk.flash_attention_cuda(*a, **kw)[0],
            lambda a=(q, kp, vp), kw=kw: fk.flash_attention_plain(
                *a, **kw)[0])
    for name, dtype, (b, s, top_p, bk, stride, kv) in (
            ("kde_decode", torch.float32, (4, 544, 4, 32, 4, 527)),
            ("kde_decode_bf16", torch.bfloat16, (4, 544, 4, 32, 4, 527)),
            ("kde_decode_long", torch.bfloat16,
             (1, 524288, 16, 512, 16, 524288))):
        q = torch.randn((b, 32, 128), generator=gen, device=dev).to(dtype)
        k = (torch.randn((b, 4, s, 128), generator=gen, device=dev)
             * 0.3).to(dtype)
        v = torch.randn((b, 4, s, 128), generator=gen, device=dev).to(dtype)
        kw = dict(top_p=top_p, bk=bk, stride=stride, kv_valid=kv)
        calls[name] = (
            lambda a=(q, k, v), kw=kw: kk.kde_decode_cuda(*a, **kw),
            lambda a=(q, k, v), kw=kw: kk.kde_decode_plain(*a, **kw))
    xs = torch.randn(1048576, 16, generator=gen, device=dev) * 0.5
    qs = torch.randn(64, 16, generator=gen, device=dev) * 0.5
    bf = dict(precision="bf16")
    calls["rowsum_bf16"] = (
        lambda: rk.rowsum_cuda(qs, xs, "gaussian", 0.25, 1.0, **bf),
        lambda: rk.rowsum_plain(qs, xs, "gaussian", 0.25, 1.0, **bf))
    for name in ("blocksum", "sample_block", "masked_blocksum"):
        a = {"blocksum": bargs, "sample_block": sargs,
             "masked_blocksum": margs}[name]
        calls[name + "_bf16"] = (
            lambda n=name, a=a: getattr(sk if n != "blocksum" else rk,
                                        n + "_cuda")(*a, **bf),
            lambda n=name, a=a: getattr(sk if n != "blocksum" else rk,
                                        n + "_plain")(*a, **bf))
    xh16 = xh.to(torch.bfloat16) if hasattr(hk, "BF16_ROWS") else xh
    for name, t in (("weighted_kv", 1152), ("weighted_kv_sum", 192),
                    ("weighted_kv_f32x", 1152)):
        fn = name.replace("_f32x", "")
        rows = xh if name.endswith("f32x") else xh16
        cols = torch.randint(0, 262144, (1024, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((1024, t), generator=gen, device=dev) * 256.0
        wargs = (qh, rows, cols, wgt, "gaussian", 1.0)
        plain = (qh, xh, cols, wgt, "gaussian", 1.0)
        calls[fn + "_bf16" + name[len(fn):]] = (
            lambda n=fn, a=wargs: getattr(hk, n + "_cuda")(*a, **bf),
            lambda n=fn, a=plain: getattr(hk, n + "_plain")(*a, **bf))
    if args.only:
        calls = {n: calls[n] for n in args.only.split(",")}

    def bf16_steps(a, b, atol=1e-5):
        """Max bf16 steps between a and b where they differ by more than
        atol (as repro_torch.testing.assert_bf16_close, which a --src tree
        may predate)."""
        def line(t):
            i = t.contiguous().view(torch.int16).to(torch.int32)
            return torch.where(i < 0, -(i & 0x7FFF), i)
        far = (a.float() - b.float()).abs() > atol
        return int(torch.where(far, (line(a) - line(b)).abs(), 0).max())

    out = {}
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        err = {}
        if name.startswith("sample_block"):
            err["blk_equal"] = float((got[0] == want[0]).float().mean())
            got, want = got[3], want[3]
        err["max_abs_err"] = float((got.float() - want.float()).abs().max())
        if got.dtype == torch.bfloat16:
            err["max_bf16_steps"] = bf16_steps(got, want)
        del want
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
        # a trace can drop its first kernel records: spin kernels ahead of
        # the calls take that place, and are left out of the counts (as in
        # repro_torch.kernels.profiling, which a --src tree may predate)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(20000)
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and "spin_kernel" not in e.key]
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in ev)
        split = {}
        for e in ev:
            key = e.key.replace("(anonymous namespace)::", "")
            key = key.split("(")[0].split("<")[0].split("::")[-1]
            split[key] = split.get(key, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0)) / args.reps / 1e3
        out[name] = dict(ms=start.elapsed_time(end) / args.reps,
                         device_ms=dev_us / args.reps / 1e3 if ev else None,
                         launches=sum(e.count for e in ev) / args.reps,
                         split=split, host_us=host, **err)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(json.dumps({"src": args.src, "group": args.group,
                      "card": card.strip().splitlines()[0], "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
