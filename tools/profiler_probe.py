"""How many kernel records does a torch.profiler trace drop on the card,
and which ones?  Prints, for a sequence of ten distinct elementwise
kernels and for two port kernels (rowsum, bf16 sample_block), the records
each trace kept, in device order, with and without 32 spin kernels ahead
of the traced calls (the pad of ``repro_torch.kernels.profiling``).  It
probes once at the start of the process and again after the kernel
library is built and a minute has passed.

    PYTHONPATH=src python tools/profiler_probe.py [--traces 4]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.profiling import PAD_CYCLES, PAD_LAUNCHES  # noqa: E402

OPS = ("neg", "abs", "exp", "sin", "cos", "tanh", "sigmoid", "reciprocal",
       "sqrt", "log1p")


def short(name: str) -> str:
    for op in OPS:
        if op in name.lower():
            return op
    for word in ("spin_kernel", "block_sums", "blocksum", "rowsum_reduce",
                 "sampler_wide"):
        if word in name:
            return word
    return name[:30]


def trace(fn, pad: bool) -> list[str]:
    """Short names of the device records of one trace of ``fn``, in start
    order, after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_LAUNCHES if pad else 0):
            torch.cuda._sleep(PAD_CYCLES)
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    evs.sort(key=lambda e: e.time_range.start)
    return [short(e.name) for e in evs]


def runs(order: list[str]) -> str:
    out: list[list] = []
    for name in order:
        if out and out[-1][0] == name:
            out[-1][1] += 1
        else:
            out.append([name, 1])
    return " ".join(f"{n}x{c}" for n, c in out)


def probe(tag: str, fns, traces: int) -> None:
    for name, fn, want in fns:
        for pad in (False, True):
            for _ in range(traces):
                order = trace(fn, pad)
                kept = sum(1 for o in order if o != "spin_kernel")
                print(f"[probe] {tag} {name} pad {PAD_LAUNCHES if pad else 0}"
                      f": {kept} of {want} records; {runs(order)}",
                      flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=4)
    ap.add_argument("--wait", type=float, default=60.0,
                    help="seconds between the build and the second probe")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    a = torch.rand(2 ** 25, device=dev) + 0.5
    b = torch.empty_like(a)

    def ops():
        for op in OPS:
            getattr(torch, op)(a, out=b)

    probe("start", [("ops", ops, len(OPS))], args.traces)
    from repro_torch.kernels import build
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(65536, 16, generator=gen, device=dev)
    q = x[:1024].contiguous()
    own = torch.arange(1024, device=dev) // 256
    g = gumbel((1024, 256), gen, dev)
    xl = torch.randn(16384, 784, generator=gen, device=dev)
    ql = xl[:1024].contiguous()

    def rowsum():
        for _ in range(5):
            rk.rowsum_cuda(ql, xl, "laplacian", 0.01)

    def sample_block():
        for _ in range(10):
            sk.sample_block_cuda(q, x, own, g, "gaussian", 1.0, 1.0, 256,
                                 "bf16")

    time.sleep(args.wait)
    probe(f"after build + {args.wait:.0f} s",
          [("ops", ops, len(OPS)), ("rowsum", rowsum, 10),
           ("sample_block bf16", sample_block, 10)], args.traces)
    return 0


if __name__ == "__main__":
    sys.exit(main())
