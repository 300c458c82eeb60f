"""Does cuBLAS reduce a bf16 GEMM in bf16 while PyTorch's
``allow_bf16_reduced_precision_reduction`` is on?  For the decode GEMVs at
yi-6b's widths (M = 1 or 4, K up to d_ff) and for products with few output
tiles and a long K, prints with the flag off and on: the largest distance
of ``x @ w`` from the float64 product in bf16 steps, and the share of
outputs off the float64 product rounded once to bf16.  An f32 sum rounded
once misses that rounding only where the product lies within the f32
error of a rounding midpoint; a bf16 reduction of split-K partials misses
it often.  The card's name and power limit come first.

    python tools/gemv_reduction_probe.py
"""
from __future__ import annotations

import subprocess

import torch

# (M, N, K): yi-6b's decode GEMVs, then few output tiles and a long K
SHAPES = [(1, 4096, 11008), (4, 4096, 11008), (1, 11008, 4096),
          (4, 11008, 4096), (64, 16, 65536), (64, 256, 65536),
          (256, 256, 65536), (64, 256, 262144), (128, 256, 65536)]


def steps_of(t: torch.Tensor) -> torch.Tensor:
    """The bf16 step at |t| (float64)."""
    e = torch.frexp(t.float().abs().clamp_min(1e-30))[1]
    return torch.ldexp(torch.ones_like(t.float()), e - 8).double()


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    mm = torch.backends.cuda.matmul
    for m, n, k in SHAPES:
        for dist in ("rand", "randn"):
            gen = torch.Generator(device="cuda").manual_seed(m + n + k)
            draw = torch.rand if dist == "rand" else torch.randn
            x = draw((m, k), generator=gen, device="cuda").bfloat16()
            w = draw((k, n), generator=gen, device="cuda").bfloat16()
            exact = x.double() @ w.double()
            rounded = exact.to(torch.bfloat16)
            step = steps_of(rounded)
            cols = []
            for flag in (False, True):
                mm.allow_bf16_reduced_precision_reduction = flag
                got = x @ w
                far = float(((got.double() - exact).abs() / step).max())
                share = float((got != rounded).double().mean())
                cols.append(f"flag {'on ' if flag else 'off'}: max {far:.3f} "
                            f"steps, {100 * share:.3f}% off")
            print(f"M={m} N={n} K={k} {dist:5s} | " + " | ".join(cols),
                  flush=True)


if __name__ == "__main__":
    main()
