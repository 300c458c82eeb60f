"""PyTorch/CUDA port of the kernel-matrix algorithms (``repro``).

The package mirrors ``repro`` path for path (``repro/X/Y.py`` ->
``repro_torch/X/Y.py``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the level-1 kernels are hand-written CUDA
C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use.  On a CPU
tensor every kernel wrapper takes its plain PyTorch version instead.

Covered so far: the exact-level-1 main path -- kernel functions, exact
KDE oracles, degree sampling, the blocked neighbor sampler with exact
level-1 reads, spectral sparsification (Alg 5.1) and FKV low-rank
approximation (Alg 5.15).  See ROADMAP.md for what remains.
"""
