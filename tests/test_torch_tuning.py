"""The port's ``kernels/tuning.py``: the card's budgets, the occupancy
rule, the instance table and the reference's two tile choosers, and the
KDE tile plans that read them (CPU; the card's side is ``chip_smoke.py``'s
tuning phase).

``PINNED`` holds every plan's result as it was before the plans read
``tuning`` (instances 0 / 16 / 32 / DEEP / MMA + 16 / MMA + 32, aligned
and not, f32 and bf16, on 132 SMs), over the shapes ``chip_smoke.py`` and
the tests run: the launch counts and outputs of PERF.md section 6 rest on
these plans staying put.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.kernels import tuning as jtuning
from repro.kernels.kde_sampler import ref as jref
from repro_torch.kernels import build, tuning
from repro_torch.kernels.kde_hash import kernel as thk
from repro_torch.kernels.kde_rowsum import kernel as trk
from repro_torch.kernels.kde_sampler import kernel as tsk
from repro_torch.kernels.kde_sampler import ref as tref

CSRC = Path(build.CSRC)
RTOL, ATOL = 2e-4, 1e-5     # tests/test_torch_bf16.py's reduced outputs

#: (plan, arguments, result) before this module drove the plans.  "sb":
#: ``sample_block_plan(m, n, d, bn, aligned, 132, precision)`` ->
#: (instance, bm, tiles, nb, group); "bs": ``blocksum_plan``, the same;
#: "rs": ``rowsum_plan(m, n, d, aligned, 132, precision)`` -> the plan's
#: five fields and the split's columns; "wk": ``weighted_kv_plan(1024,
#: 262144, d, 192, aligned, x dtype, precision)`` -> (instance, lanes)
PINNED = [
    ("sb", (1024, 65536, 16, 256, True, "f32"), (16, 128, 8, 256, 8)),
    ("bs", (1024, 65536, 16, 256, True, "f32"), (16, 128, 8, 256, 8)),
    ("rs", (1024, 65536, 16, True, "f32"), (16, 128, 8, 32, 1, 2048)),
    ("sb", (1024, 65536, 16, 256, True, "bf16"), (80, 128, 8, 256, 8)),
    ("bs", (1024, 65536, 16, 256, True, "bf16"), (80, 128, 8, 256, 8)),
    ("rs", (1024, 65536, 16, True, "bf16"), (80, 128, 8, 32, 1, 2048)),
    ("sb", (1024, 65536, 16, 256, False, "f32"), (0, 64, 16, 256, 16)),
    ("bs", (1024, 65536, 16, 256, False, "f32"), (0, 64, 16, 256, 1)),
    ("rs", (1024, 65536, 16, False, "f32"), (0, 64, 16, 32, 1, 2048)),
    ("sb", (1024, 65536, 16, 256, False, "bf16"), (0, 64, 16, 256, 16)),
    ("bs", (1024, 65536, 16, 256, False, "bf16"), (0, 64, 16, 256, 1)),
    ("rs", (1024, 65536, 16, False, "bf16"), (0, 64, 16, 32, 1, 2048)),
    ("sb", (4096, 65536, 16, 256, True, "f32"), (16, 128, 32, 256, 32)),
    ("bs", (4096, 65536, 16, 256, True, "f32"), (16, 128, 32, 256, 32)),
    ("rs", (4096, 65536, 16, True, "f32"), (16, 128, 32, 9, 1, 7296)),
    ("sb", (4096, 65536, 16, 256, True, "bf16"), (80, 128, 32, 256, 32)),
    ("bs", (4096, 65536, 16, 256, True, "bf16"), (80, 128, 32, 256, 32)),
    ("rs", (4096, 65536, 16, True, "bf16"), (80, 128, 32, 9, 1, 7296)),
    ("sb", (4096, 65536, 16, 256, False, "f32"), (0, 64, 64, 256, 63)),
    ("bs", (4096, 65536, 16, 256, False, "f32"), (0, 64, 64, 256, 1)),
    ("rs", (4096, 65536, 16, False, "f32"), (0, 64, 64, 9, 1, 7296)),
    ("sb", (4096, 65536, 16, 256, False, "bf16"), (0, 64, 64, 256, 63)),
    ("bs", (4096, 65536, 16, 256, False, "bf16"), (0, 64, 64, 256, 1)),
    ("rs", (4096, 65536, 16, False, "bf16"), (0, 64, 64, 9, 1, 7296)),
    ("sb", (1024, 16384, 784, 70, True, "f32"), (0, 64, 16, 235, 15)),
    ("bs", (1024, 16384, 784, 70, True, "f32"), (1, 128, 8, 235, 8)),
    ("rs", (1024, 16384, 784, True, "f32"), (1, 128, 8, 32, 1, 512)),
    ("sb", (1024, 16384, 784, 70, True, "bf16"), (0, 64, 16, 235, 15)),
    ("bs", (1024, 16384, 784, 70, True, "bf16"), (1, 128, 8, 235, 8)),
    ("rs", (1024, 16384, 784, True, "bf16"), (1, 128, 8, 32, 1, 512)),
    ("sb", (1024, 16384, 784, 70, False, "f32"), (0, 64, 16, 235, 15)),
    ("bs", (1024, 16384, 784, 70, False, "f32"), (0, 64, 16, 235, 1)),
    ("rs", (1024, 16384, 784, False, "f32"), (0, 64, 16, 32, 1, 512)),
    ("sb", (1024, 16384, 784, 70, False, "bf16"), (0, 64, 16, 235, 15)),
    ("bs", (1024, 16384, 784, 70, False, "bf16"), (0, 64, 16, 235, 1)),
    ("rs", (1024, 16384, 784, False, "bf16"), (0, 64, 16, 32, 1, 512)),
    ("sb", (1024, 262144, 16, 512, True, "f32"), (16, 128, 8, 512, 16)),
    ("bs", (1024, 262144, 16, 512, True, "f32"), (16, 128, 8, 512, 16)),
    ("rs", (1024, 262144, 16, True, "f32"), (16, 128, 8, 33, 1, 8064)),
    ("sb", (1024, 262144, 16, 512, True, "bf16"), (80, 128, 8, 512, 16)),
    ("bs", (1024, 262144, 16, 512, True, "bf16"), (80, 128, 8, 512, 16)),
    ("rs", (1024, 262144, 16, True, "bf16"), (80, 128, 8, 33, 1, 8064)),
    ("sb", (1024, 262144, 16, 512, False, "f32"), (0, 64, 16, 512, 32)),
    ("bs", (1024, 262144, 16, 512, False, "f32"), (0, 64, 16, 512, 1)),
    ("rs", (1024, 262144, 16, False, "f32"), (0, 64, 16, 33, 1, 8000)),
    ("sb", (1024, 262144, 16, 512, False, "bf16"), (0, 64, 16, 512, 32)),
    ("bs", (1024, 262144, 16, 512, False, "bf16"), (0, 64, 16, 512, 1)),
    ("rs", (1024, 262144, 16, False, "bf16"), (0, 64, 16, 33, 1, 8000)),
    ("sb", (64, 1048576, 16, 256, True, "f32"), (16, 128, 1, 4096, 16)),
    ("bs", (64, 1048576, 16, 256, True, "f32"), (16, 128, 1, 4096, 16)),
    ("rs", (64, 1048576, 16, True, "f32"), (16, 128, 1, 256, 1, 4096)),
    ("sb", (64, 1048576, 16, 256, True, "bf16"), (80, 128, 1, 4096, 16)),
    ("bs", (64, 1048576, 16, 256, True, "bf16"), (80, 128, 1, 4096, 16)),
    ("rs", (64, 1048576, 16, True, "bf16"), (80, 128, 1, 256, 1, 4096)),
    ("sb", (64, 1048576, 16, 256, False, "f32"), (0, 64, 1, 4096, 16)),
    ("bs", (64, 1048576, 16, 256, False, "f32"), (0, 64, 1, 4096, 1)),
    ("rs", (64, 1048576, 16, False, "f32"), (0, 64, 1, 512, 1, 2048)),
    ("sb", (64, 1048576, 16, 256, False, "bf16"), (0, 64, 1, 4096, 16)),
    ("bs", (64, 1048576, 16, 256, False, "bf16"), (0, 64, 1, 4096, 1)),
    ("rs", (64, 1048576, 16, False, "bf16"), (0, 64, 1, 512, 1, 2048)),
    ("sb", (5000, 5000, 2, 70, True, "f32"), (0, 64, 79, 72, 22)),
    ("bs", (5000, 5000, 2, 70, True, "f32"), (0, 64, 79, 72, 1)),
    ("rs", (5000, 5000, 2, True, "f32"), (0, 64, 79, 7, 1, 768)),
    ("sb", (5000, 5000, 2, 70, True, "bf16"), (0, 64, 79, 72, 22)),
    ("bs", (5000, 5000, 2, 70, True, "bf16"), (0, 64, 79, 72, 1)),
    ("rs", (5000, 5000, 2, True, "bf16"), (0, 64, 79, 7, 1, 768)),
    ("sb", (5000, 5000, 2, 70, False, "f32"), (0, 64, 79, 72, 22)),
    ("bs", (5000, 5000, 2, 70, False, "f32"), (0, 64, 79, 72, 1)),
    ("rs", (5000, 5000, 2, False, "f32"), (0, 64, 79, 7, 1, 768)),
    ("sb", (5000, 5000, 2, 70, False, "bf16"), (0, 64, 79, 72, 22)),
    ("bs", (5000, 5000, 2, 70, False, "bf16"), (0, 64, 79, 72, 1)),
    ("rs", (5000, 5000, 2, False, "bf16"), (0, 64, 79, 7, 1, 768)),
    ("sb", (2500, 2500, 3, 50, True, "f32"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 3, 50, True, "f32"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 3, True, "f32"), (0, 64, 40, 14, 1, 192)),
    ("sb", (2500, 2500, 3, 50, True, "bf16"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 3, 50, True, "bf16"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 3, True, "bf16"), (0, 64, 40, 14, 1, 192)),
    ("sb", (2500, 2500, 3, 50, False, "f32"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 3, 50, False, "f32"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 3, False, "f32"), (0, 64, 40, 14, 1, 192)),
    ("sb", (2500, 2500, 3, 50, False, "bf16"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 3, 50, False, "bf16"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 3, False, "bf16"), (0, 64, 40, 14, 1, 192)),
    ("sb", (2500, 2500, 200, 50, True, "f32"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 200, 50, True, "f32"), (1, 128, 20, 50, 4)),
    ("rs", (2500, 2500, 200, True, "f32"), (1, 128, 20, 10, 1, 256)),
    ("sb", (2500, 2500, 200, 50, True, "bf16"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 200, 50, True, "bf16"), (1, 128, 20, 50, 4)),
    ("rs", (2500, 2500, 200, True, "bf16"), (1, 128, 20, 10, 1, 256)),
    ("sb", (2500, 2500, 200, 50, False, "f32"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 200, 50, False, "f32"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 200, False, "f32"), (0, 64, 40, 14, 1, 192)),
    ("sb", (2500, 2500, 200, 50, False, "bf16"), (0, 64, 40, 50, 8)),
    ("bs", (2500, 2500, 200, 50, False, "bf16"), (0, 64, 40, 50, 1)),
    ("rs", (2500, 2500, 200, False, "bf16"), (0, 64, 40, 14, 1, 192)),
    ("sb", (300, 5000, 20, 70, True, "f32"), (32, 128, 3, 72, 1)),
    ("bs", (300, 5000, 20, 70, True, "f32"), (32, 128, 3, 72, 1)),
    ("rs", (300, 5000, 20, True, "f32"), (32, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 20, 70, True, "bf16"), (96, 128, 3, 72, 1)),
    ("bs", (300, 5000, 20, 70, True, "bf16"), (96, 128, 3, 72, 1)),
    ("rs", (300, 5000, 20, True, "bf16"), (96, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 20, 70, False, "f32"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 20, 70, False, "f32"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 20, False, "f32"), (0, 64, 5, 79, 1, 64)),
    ("sb", (300, 5000, 20, 70, False, "bf16"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 20, 70, False, "bf16"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 20, False, "bf16"), (0, 64, 5, 79, 1, 64)),
    ("sb", (300, 5000, 32, 70, True, "f32"), (32, 128, 3, 72, 1)),
    ("bs", (300, 5000, 32, 70, True, "f32"), (32, 128, 3, 72, 1)),
    ("rs", (300, 5000, 32, True, "f32"), (32, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 32, 70, True, "bf16"), (96, 128, 3, 72, 1)),
    ("bs", (300, 5000, 32, 70, True, "bf16"), (96, 128, 3, 72, 1)),
    ("rs", (300, 5000, 32, True, "bf16"), (96, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 32, 70, False, "f32"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 32, 70, False, "f32"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 32, False, "f32"), (0, 64, 5, 79, 1, 64)),
    ("sb", (300, 5000, 32, 70, False, "bf16"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 32, 70, False, "bf16"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 32, False, "bf16"), (0, 64, 5, 79, 1, 64)),
    ("sb", (300, 5000, 36, 70, True, "f32"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 36, 70, True, "f32"), (1, 128, 3, 72, 1)),
    ("rs", (300, 5000, 36, True, "f32"), (1, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 36, 70, True, "bf16"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 36, 70, True, "bf16"), (1, 128, 3, 72, 1)),
    ("rs", (300, 5000, 36, True, "bf16"), (1, 128, 3, 40, 1, 128)),
    ("sb", (300, 5000, 36, 70, False, "f32"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 36, 70, False, "f32"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 36, False, "f32"), (0, 64, 5, 79, 1, 64)),
    ("sb", (300, 5000, 36, 70, False, "bf16"), (0, 64, 5, 72, 2)),
    ("bs", (300, 5000, 36, 70, False, "bf16"), (0, 64, 5, 72, 1)),
    ("rs", (300, 5000, 36, False, "bf16"), (0, 64, 5, 79, 1, 64)),
    ("sb", (1, 1, 8, 1, True, "f32"), (16, 128, 1, 1, 1)),
    ("bs", (1, 1, 8, 1, True, "f32"), (16, 128, 1, 1, 1)),
    ("rs", (1, 1, 8, True, "f32"), (16, 128, 1, 1, 1, 128)),
    ("sb", (1, 1, 8, 1, True, "bf16"), (80, 128, 1, 1, 1)),
    ("bs", (1, 1, 8, 1, True, "bf16"), (80, 128, 1, 1, 1)),
    ("rs", (1, 1, 8, True, "bf16"), (80, 128, 1, 1, 1, 128)),
    ("sb", (1, 1, 8, 1, False, "f32"), (0, 64, 1, 1, 1)),
    ("bs", (1, 1, 8, 1, False, "f32"), (0, 64, 1, 1, 1)),
    ("rs", (1, 1, 8, False, "f32"), (0, 64, 1, 1, 1, 64)),
    ("sb", (1, 1, 8, 1, False, "bf16"), (0, 64, 1, 1, 1)),
    ("bs", (1, 1, 8, 1, False, "bf16"), (0, 64, 1, 1, 1)),
    ("rs", (1, 1, 8, False, "bf16"), (0, 64, 1, 1, 1, 64)),
    ("sb", (129, 301, 8, 17, True, "f32"), (16, 128, 2, 18, 1)),
    ("bs", (129, 301, 8, 17, True, "f32"), (16, 128, 2, 18, 1)),
    ("rs", (129, 301, 8, True, "f32"), (16, 128, 2, 3, 1, 128)),
    ("sb", (129, 301, 8, 17, True, "bf16"), (80, 128, 2, 18, 1)),
    ("bs", (129, 301, 8, 17, True, "bf16"), (80, 128, 2, 18, 1)),
    ("rs", (129, 301, 8, True, "bf16"), (80, 128, 2, 3, 1, 128)),
    ("sb", (129, 301, 8, 17, False, "f32"), (0, 64, 3, 18, 1)),
    ("bs", (129, 301, 8, 17, False, "f32"), (0, 64, 3, 18, 1)),
    ("rs", (129, 301, 8, False, "f32"), (0, 64, 3, 5, 1, 64)),
    ("sb", (129, 301, 8, 17, False, "bf16"), (0, 64, 3, 18, 1)),
    ("bs", (129, 301, 8, 17, False, "bf16"), (0, 64, 3, 18, 1)),
    ("rs", (129, 301, 8, False, "bf16"), (0, 64, 3, 5, 1, 64)),
    ("sb", (1024, 524288, 8, 724, True, "f32"), (16, 128, 8, 725, 22)),
    ("bs", (1024, 524288, 8, 724, True, "f32"), (16, 128, 8, 725, 22)),
    ("rs", (1024, 524288, 8, True, "f32"), (16, 128, 8, 33, 1, 16000)),
    ("sb", (1024, 524288, 8, 724, True, "bf16"), (80, 128, 8, 725, 22)),
    ("bs", (1024, 524288, 8, 724, True, "bf16"), (80, 128, 8, 725, 22)),
    ("rs", (1024, 524288, 8, True, "bf16"), (80, 128, 8, 33, 1, 16000)),
    ("sb", (1024, 524288, 8, 724, False, "f32"), (0, 64, 16, 725, 44)),
    ("bs", (1024, 524288, 8, 724, False, "f32"), (0, 64, 16, 725, 1)),
    ("rs", (1024, 524288, 8, False, "f32"), (0, 64, 16, 33, 1, 15936)),
    ("sb", (1024, 524288, 8, 724, False, "bf16"), (0, 64, 16, 725, 44)),
    ("bs", (1024, 524288, 8, 724, False, "bf16"), (0, 64, 16, 725, 1)),
    ("rs", (1024, 524288, 8, False, "bf16"), (0, 64, 16, 33, 1, 15936)),
    ("sb", (16, 4096, 4, 64, True, "f32"), (16, 128, 1, 64, 1)),
    ("bs", (16, 4096, 4, 64, True, "f32"), (16, 128, 1, 64, 1)),
    ("rs", (16, 4096, 4, True, "f32"), (16, 128, 1, 32, 1, 128)),
    ("sb", (16, 4096, 4, 64, True, "bf16"), (80, 128, 1, 64, 1)),
    ("bs", (16, 4096, 4, 64, True, "bf16"), (80, 128, 1, 64, 1)),
    ("rs", (16, 4096, 4, True, "bf16"), (80, 128, 1, 32, 1, 128)),
    ("sb", (16, 4096, 4, 64, False, "f32"), (0, 64, 1, 64, 1)),
    ("bs", (16, 4096, 4, 64, False, "f32"), (0, 64, 1, 64, 1)),
    ("rs", (16, 4096, 4, False, "f32"), (0, 64, 1, 64, 1, 64)),
    ("sb", (16, 4096, 4, 64, False, "bf16"), (0, 64, 1, 64, 1)),
    ("bs", (16, 4096, 4, 64, False, "bf16"), (0, 64, 1, 64, 1)),
    ("rs", (16, 4096, 4, False, "bf16"), (0, 64, 1, 64, 1, 64)),
    ("wk", (2, True, "f32", "f32"), (0, 1)),
    ("wk", (2, True, "f32", "bf16"), (0, 1)),
    ("wk", (2, True, "bf16", "bf16"), (16, 1)),
    ("wk", (2, False, "f32", "f32"), (0, 1)),
    ("wk", (2, False, "f32", "bf16"), (0, 1)),
    ("wk", (2, False, "bf16", "bf16"), (16, 1)),
    ("wk", (3, True, "f32", "f32"), (0, 1)),
    ("wk", (3, True, "f32", "bf16"), (0, 1)),
    ("wk", (3, True, "bf16", "bf16"), (16, 1)),
    ("wk", (3, False, "f32", "f32"), (0, 1)),
    ("wk", (3, False, "f32", "bf16"), (0, 1)),
    ("wk", (3, False, "bf16", "bf16"), (16, 1)),
    ("wk", (4, True, "f32", "f32"), (4, 4)),
    ("wk", (4, True, "f32", "bf16"), (4, 4)),
    ("wk", (4, True, "bf16", "bf16"), (20, 4)),
    ("wk", (4, False, "f32", "f32"), (0, 1)),
    ("wk", (4, False, "f32", "bf16"), (0, 1)),
    ("wk", (4, False, "bf16", "bf16"), (16, 1)),
    ("wk", (8, True, "f32", "f32"), (4, 4)),
    ("wk", (8, True, "f32", "bf16"), (4, 4)),
    ("wk", (8, True, "bf16", "bf16"), (20, 4)),
    ("wk", (8, False, "f32", "f32"), (0, 1)),
    ("wk", (8, False, "f32", "bf16"), (0, 1)),
    ("wk", (8, False, "bf16", "bf16"), (16, 1)),
    ("wk", (12, True, "f32", "f32"), (4, 4)),
    ("wk", (12, True, "f32", "bf16"), (4, 4)),
    ("wk", (12, True, "bf16", "bf16"), (20, 4)),
    ("wk", (12, False, "f32", "f32"), (0, 1)),
    ("wk", (12, False, "f32", "bf16"), (0, 1)),
    ("wk", (12, False, "bf16", "bf16"), (16, 1)),
    ("wk", (16, True, "f32", "f32"), (4, 4)),
    ("wk", (16, True, "f32", "bf16"), (4, 4)),
    ("wk", (16, True, "bf16", "bf16"), (20, 4)),
    ("wk", (16, False, "f32", "f32"), (0, 1)),
    ("wk", (16, False, "f32", "bf16"), (0, 1)),
    ("wk", (16, False, "bf16", "bf16"), (16, 1)),
    ("wk", (20, True, "f32", "f32"), (8, 8)),
    ("wk", (20, True, "f32", "bf16"), (8, 8)),
    ("wk", (20, True, "bf16", "bf16"), (24, 8)),
    ("wk", (20, False, "f32", "f32"), (0, 1)),
    ("wk", (20, False, "f32", "bf16"), (0, 1)),
    ("wk", (20, False, "bf16", "bf16"), (16, 1)),
    ("wk", (32, True, "f32", "f32"), (8, 8)),
    ("wk", (32, True, "f32", "bf16"), (8, 8)),
    ("wk", (32, True, "bf16", "bf16"), (24, 8)),
    ("wk", (32, False, "f32", "f32"), (0, 1)),
    ("wk", (32, False, "f32", "bf16"), (0, 1)),
    ("wk", (32, False, "bf16", "bf16"), (16, 1)),
    ("wk", (36, True, "f32", "f32"), (0, 1)),
    ("wk", (36, True, "f32", "bf16"), (0, 1)),
    ("wk", (36, True, "bf16", "bf16"), (16, 1)),
    ("wk", (36, False, "f32", "f32"), (0, 1)),
    ("wk", (36, False, "f32", "bf16"), (0, 1)),
    ("wk", (36, False, "bf16", "bf16"), (16, 1)),
    ("wk", (784, True, "f32", "f32"), (0, 1)),
    ("wk", (784, True, "f32", "bf16"), (0, 1)),
    ("wk", (784, True, "bf16", "bf16"), (16, 1)),
    ("wk", (784, False, "f32", "f32"), (0, 1)),
    ("wk", (784, False, "f32", "bf16"), (0, 1)),
    ("wk", (784, False, "bf16", "bf16"), (16, 1)),
]


def _plan(kind, args):
    if kind == "sb":
        m, n, d, bn, aligned, prec = args
        return tuple(tsk.sample_block_plan(m, n, d, bn, aligned, 132, prec))
    if kind == "bs":
        m, n, d, bn, aligned, prec = args
        return tuple(trk.blocksum_plan(m, n, d, bn, aligned, 132, prec))
    if kind == "rs":
        m, n, d, aligned, prec = args
        plan, cols = trk.rowsum_plan(m, n, d, aligned, 132, prec)
        return (*plan, cols)
    d, aligned, rows, prec = args
    xd = torch.bfloat16 if rows == "bf16" else torch.float32
    return tuple(thk.weighted_kv_plan(1024, 262144, d, 192, aligned, xd,
                                      prec))


@pytest.mark.parametrize("kind, args, want", PINNED)
def test_plans_keep_their_results(kind, args, want):
    """Every plan gives today's instance, rows, tiles, blocks, group,
    split and lanes."""
    assert _plan(kind, args) == want


def test_pinned_table_covers_every_instance():
    """The pinned grid reaches every instance the plans can pick: the
    generic (0), wide (16, 32), deep (DEEP) and tensor-core (MMA + 16, MMA
    + 32) tiles, and every weighted instance."""
    tiles = {want[0] for kind, _, want in PINNED if kind != "wk"}
    assert tiles == {0, 16, 32, trk.DEEP, tsk.MMA + 16, tsk.MMA + 32}
    lanes = {want for kind, _, want in PINNED if kind == "wk"}
    assert lanes == {(0, 1), (4, 4), (8, 8), (16, 1), (20, 4), (24, 8)}


@pytest.mark.parametrize("threads, regs, smem, want", [
    (256, 128, 0, 2),          # the 128-row tiles: 4096 registers a warp
    (256, 118, 8848, 2),       # the generic tile with the draw
    (256, 64, 8832, 4),        # the generic tile without it
    (256, 40, 8832, 6),        # 1280 a warp: 12 warps a register file
    (256, 32, 100000, 2),      # shared memory: 101,120 B a CTA
    (128, 32, 232448, 1),      # the opt-in maximum: one CTA fills the SM
    (128, 32, 232449, 0),      # past the opt-in: none
    (256, 255, 0, 1),          # 8192 a warp: 2 warps a register file
    (1024, 255, 0, 0),         # 262,144 registers: no CTA fits
    (64, 16, 0, 32),           # the CTA limit
    (1024, 16, 0, 2),          # the thread limit
])
def test_ctas_per_sm_on_hand_worked_h100_figures(threads, regs, smem, want):
    """The occupancy rule on the H100's figures, worked by hand: registers
    in 256-register units a warp, a warp's registers in one of four
    register files; shared memory plus the 1 KiB reservation in 128-byte
    units out of 233,472 B; 2,048 threads and 32 CTAs."""
    assert tuning.ctas_per_sm(threads, regs, smem) == want


def test_plan_cta_counts_come_from_the_table():
    """``CTAS_PER_SM`` and ``GENERIC_CTAS_PER_SM`` are the least CTAs an
    SM over their instances (2 and 4 on the H100, today's values), and the
    kernel modules read them from ``tuning``."""
    for which, fams in tuning.PLAN_FAMILIES.items():
        names = [n for n in tuning.RESOURCES
                 if tuning.template_args(n)[0] in fams]
        assert names and getattr(tuning, which) == min(
            tuning.ctas_per_sm(tuning.RESOURCES[n].threads,
                               tuning.RESOURCES[n].regs,
                               tuning.RESOURCES[n].smem
                               + tuning.RESOURCES[n].static)
            for n in names)
    assert (tuning.CTAS_PER_SM, tuning.GENERIC_CTAS_PER_SM) == (2, 4)
    assert tsk.CTAS_PER_SM == tuning.CTAS_PER_SM
    assert (tsk.WIDE_BM, tsk.GENERIC_BM, tsk.MAX_WIDE_D) == (
        tuning.WIDE_BM, tuning.GENERIC_BM, tuning.MAX_WIDE_D)


@pytest.mark.parametrize("m, n, d", [(1024, 65536, 16), (1024, 16384, 784),
                                     (5000, 5000, 2), (2500, 2500, 3),
                                     (300, 5000, 20), (64, 1048576, 16),
                                     (129, 301, 36), (1, 1, 8)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_pallas_tiles_is_the_plans_tile(m, n, d, precision):
    """``pallas_tiles`` gives the (bm, chunk) the blocksum and rowsum
    kernels run at that shape, on 16-byte-aligned operands: the plan's
    query rows and its staged chunk's columns."""
    plan = trk.blocksum_plan(m, n, d, 256, True, precision=precision)
    rplan, cols = trk.rowsum_plan(m, n, d, True, precision=precision)
    chunk = tuning.GENERIC_BN if plan.instance == 0 else tuning.TILE_BN
    assert tuning.pallas_tiles(m, n, d, precision) == (plan.bm, chunk)
    assert rplan.bm == plan.bm and cols % chunk == 0


@pytest.mark.parametrize("bn", [1, 16, 50, 70, 256, 724, 4096, 5000])
@pytest.mark.parametrize("d", [2, 16, 784])
def test_sweep_blocks_per_tile(bn, d):
    """``sweep_blocks_per_tile`` is ``max(1, SWEEP_TILE_COLS // bn)``, the
    reference's rule on the card's column budget."""
    assert tuning.sweep_blocks_per_tile(bn, d) == max(
        1, tuning.SWEEP_TILE_COLS // bn)
    assert tuning.sweep_blocks_per_tile(bn, d, 2048) == \
        jtuning.sweep_blocks_per_tile(bn, d)


def test_sweep_tile_cols_fits_half_the_l2():
    """``SWEEP_TILE_COLS``: the widest power of two whose (1024, cols) f32
    value tile and (64, cols) bf16 operand tile fit in half the L2."""
    per_col = 1024 * 4 + 64 * 2
    half = tuning.H100_SXM.l2_bytes // 2
    cols = tuning.SWEEP_TILE_COLS
    assert cols & (cols - 1) == 0
    assert cols * per_col <= half < 2 * cols * per_col


@pytest.mark.parametrize("n, bn", [(4096, 256), (4001, 256), (5000, 70),
                                   (3000, 16)])
@pytest.mark.parametrize("kind", ["gaussian", "exponential",
                                  "rational_quadratic"])
def test_kv_block_sums_bf16_default_tile(kind, n, bn):
    """The bf16 sweep at its default tile (``sweep_blocks_per_tile``)
    equals its output at one block a tile and the reference's, at
    ``tests/test_torch_bf16.py``'s reduced-output tolerance."""
    rng = np.random.default_rng(stats.derive_seed("torch_tuning", kind))
    q = rng.normal(0, 0.5, (48, 16)).astype(np.float32)
    x = rng.normal(0, 0.5, (n, 16)).astype(np.float32)
    beta = 0.7 if kind == "rational_quadratic" else 1.0
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    got = tref.kv_block_sums_bf16(tq, tx, kind, 1 / 1.5, beta, bn)
    one = tref.kv_block_sums_bf16(tq, tx, kind, 1 / 1.5, beta, bn, 1)
    want = jref.kv_block_sums_bf16(jnp.asarray(q), jnp.asarray(x), kind,
                                   1 / 1.5, beta, bn=bn)
    assert got.shape == (48, -(-n // bn))
    for other in (one.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got.numpy(), other, rtol=RTOL, atol=ATOL)


def _c_int(path: Path, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, (path.name, name)
    return int(m.group(1))


@pytest.mark.parametrize("source, name, want", [
    ("kde_attention.cu", "MAX_SMEM", "SMEM_BUDGET"),
    ("kde_tile.cuh", "BM", "GENERIC_BM"),
    ("kde_tile.cuh", "BN", "GENERIC_BN"),
    ("kde_wide.cuh", "MMA", None),
    ("kde_wide.cuh", "DEEP", None),
])
def test_c_constants_equal_tuning(source, name, want):
    """The C constants the plans mirror: ``MAX_SMEM`` (the decode plan's
    shared-memory ceiling) is ``tuning.SMEM_BUDGET``, the generic tile's
    rows and chunk are ``tuning``'s, and the instance ids are the plans'."""
    got = _c_int(CSRC / source, name)
    expect = {"MMA": tsk.MMA, "DEEP": trk.DEEP}.get(name) if want is None \
        else getattr(tuning, want)
    assert got == expect
    if name == "MAX_SMEM":
        assert got == tuning.H100_SXM.smem_per_cta_optin


def test_wide_tiles_are_tunings():
    """kde_wide.cuh's 128-row tiles stage ``WIDE_BM`` rows and ``TILE_BN``
    columns."""
    text = (CSRC / "kde_wide.cuh").read_text()
    found = re.findall(r"static constexpr int BM = (\d+), BN = (\d+);", text)
    found += re.findall(r"static constexpr int BM = (\d+);\s.*\n\s*static "
                        r"constexpr int BN = (\d+);", text)
    assert len(found) == 3, found
    assert set(found) == {(str(tuning.WIDE_BM), str(tuning.TILE_BN))}


def test_kernel_ids_follow_the_c_enum():
    """``KERNEL_IDS`` is ``kde::FuncId``'s order (csrc/kde_func.cuh), and
    every family names one in the table."""
    text = (CSRC / "kde_func.cuh").read_text()
    enum = re.search(r"enum FuncId : int \{(.*?)\};", text, re.S).group(1)
    comments = re.findall(r"//\s*(?:[\w.]+\.cuh?\s+)?(\w+)<?", enum)
    assert tuple(comments) == tuning.KERNEL_IDS
    fams = {tuning.template_args(n)[0] for n in tuning.RESOURCES}
    assert fams == set(tuning.KERNEL_IDS)


def test_device_fields_follow_the_c_table():
    """``DEVICE_FIELDS`` is the order of ``kde_device_attribute``'s table
    (csrc/kde_resources.cu), and ``HopperLimits`` has each field."""
    text = (CSRC / "kde_resources.cu").read_text()
    table = re.search(r"kFields\[\] = \{(.*?)\};", text, re.S).group(1)
    assert tuple(re.findall(r"// (\w+)", table)) == tuning.DEVICE_FIELDS
    assert set(tuning.DEVICE_FIELDS) | {"reg_alloc_unit"} == {
        f.name for f in tuning.dataclasses.fields(tuning.HopperLimits)}
    assert set(tuning.TORCH_FIELDS) <= set(tuning.DEVICE_FIELDS)


def test_resources_entries_are_built_and_signed():
    """The build compiles the resources source and binds both entries."""
    assert "kde_resources.cu" in build.SOURCES
    assert "kde_func.cuh" in build.HEADERS
    assert len(build.SIGNATURES["kde_func_attributes"]) == 2 + len(
        tuning.CardResource._fields)
    assert len(build.SIGNATURES["kde_device_attribute"]) == 3


@pytest.mark.parametrize("name", sorted(tuning.RESOURCES))
def test_instance_names_round_trip(name):
    """Each table entry: its demangled symbol (either demangler's spelling)
    gives its name back, and its packed instance holds its template
    arguments a byte each."""
    cpp = name.replace("bf16", "__nv_bfloat16")
    family, args = tuning.template_args(name)
    gnu = f"void (anonymous namespace)::{cpp}((anonymous namespace)::Args)"
    assert tuning.instance_name(gnu) == name
    cu = "<unnamed>::".join(["void ", cpp]) + "(int)"
    cu = re.sub(r"\b(\d+)\b", r"(int)\1", cu)
    cu = cu.replace("true", "(bool)1").replace("false", "(bool)0")
    assert tuning.instance_name(cu) == name
    code = tuning.instance_code(name)
    for i, a in enumerate(args):
        v = {"float": 0, "bf16": 1, "false": 0, "true": 1}.get(a)
        assert (code >> (8 * i)) & 0xFF == (int(a) if v is None else v)
    assert code >> (8 * len(args)) == 0
    r = tuning.RESOURCES[name]
    assert r.threads in (128, 256) and 0 < r.regs <= 255
    assert r.smem + r.static <= tuning.SMEM_BUDGET
    assert tuning.resource_ctas(name) >= 1


def test_ptxas_resources_reads_a_log():
    """``ptxas_resources`` on nvcc's lines, a spilling entry's included."""
    log = (
        "ptxas info    : Compiling entry function '_Z1a' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1a\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 57 registers, used 1 barriers, 8832 bytes "
        "smem\n"
        "ptxas info    : Compiling entry function '_Z1b' for 'sm_90a'\n"
        "    56 bytes stack frame, 84 bytes spill stores, 68 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 56 bytes "
        "cumulative stack size, 16 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z1c' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 31 registers\n")
    names = {"_Z1a": "void blocksum_kernel<3, true>(A)",
             "_Z1b": "void (anonymous namespace)::sampler_wide_kernel"
                     "<2, 32, true, true>(A)",
             "_Z1c": "rowsum_reduce_kernel(float const*, float*, int, int)"}
    got = tuning.ptxas_resources(log, lambda ms: [names[m] for m in ms])
    assert got == {"blocksum_kernel<3, true>": (57, 8832, 0, 0, 0),
                   "sampler_wide_kernel<2, 32, true, true>":
                       (128, 16, 56, 84, 68),
                   "rowsum_reduce_kernel": (31, 0, 0, 0, 0)}
    for name, v in got.items():
        r = tuning.RESOURCES[name]
        assert v == (r.regs, r.static, r.stack, r.spill_stores,
                     r.spill_loads)


def test_walk_layout_is_the_references():
    """The walk layout's sizes fix the walk counters: the reference's."""
    for name in ("WALK_CACHE_COLS", "WALK_CACHE_MIN_S", "WALK_MIN_BLOCK"):
        assert getattr(tuning, name) == getattr(jtuning, name)
    for n in (16, 4096, 65536, 10 ** 6):
        for bs in (16, 64, 256, 1024):
            assert tuning.walk_block_size(n, bs) == \
                jtuning.walk_block_size(n, bs)
    for nb in (1, 64, 512, 4096):
        assert tuning.walk_samples_per_block(nb, 16) == \
            jtuning.walk_samples_per_block(nb, 16)


@pytest.mark.parametrize("d, lanes", [(2, 1), (4, 4), (16, 4), (18, 1),
                                      (20, 8), (32, 8), (36, 1), (784, 1)])
def test_weighted_lanes(d, lanes):
    """The weighted kernels' lanes a gathered row: 4 to d = 16, 8 to 32,
    and 1 (the scalar instance) past it or off a multiple of 4."""
    assert tuning.weighted_lanes(d) == lanes


def test_limits_need_a_cuda_device():
    """``limits`` reads a card; a CPU device is refused, never guessed."""
    with pytest.raises(ValueError):
        tuning.limits("cpu")
