#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s paper phase (phase 20, host-bound) in two
checkouts on one card, in turns, to tell the host's speed from a change's.

    python3 tools/paper_phase_ab.py PARENT_DIR CHANGE_DIR

Each directory is a checkout (``git archive`` of a commit unpacked beside
this one).  Both build their kernels at once, then the phase runs in a
fresh process per turn, in the order parent, change, change, parent,
parent, change, and each turn prints ``[ab] <dir> paper <s> s: {part:
s}``.  Needs one CUDA card.
"""
from __future__ import annotations

import os
import subprocess
import sys

_TURN = """
import sys, time
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
_, _, secs = cs.phase_paper()
cs.log(f"[ab] {sys.argv[1]} paper {time.perf_counter() - t0:.2f} s: {secs}")
"""
_BUILD = ("import sys; sys.path.insert(0, 'src'); "
          "from repro_torch.kernels import build; build.library(); "
          "print(sys.argv[1], 'built in', build.BUILD_SECONDS, 's')")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1:]
    env = {**os.environ, "REPRO_CHECKS": "1"}
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD, d], cwd=d,
                               env=env) for d in (parent, change)]
    if any(p.wait() for p in builds):
        return 1
    for d in (parent, change, change, parent, parent, change):
        rc = subprocess.run([sys.executable, "-c", _TURN, d], cwd=d,
                            env=env).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
