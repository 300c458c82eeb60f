"""PyTorch/CUDA port of the kernel-matrix algorithms (``repro``).

The package mirrors ``repro`` path for path (``repro/X/Y.py`` ->
``repro_torch/X/Y.py``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; every kernel is hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use.  On a CPU tensor
every kernel wrapper takes its plain PyTorch version instead.

Covered so far:
- the exact-level-1 main path -- kernel functions, exact KDE oracles,
  degree sampling, the blocked neighbor sampler with exact level-1 reads,
  spectral sparsification (Alg 5.1) and FKV low-rank approximation
  (Alg 5.15);
- the hashed-KDE path -- ``HashedKDE``, ``NeighborSampler(level1="hash")``
  and ``spectral_sparsify(estimator="hash")``;
- the LM path of every config of the reference -- the dense GQA ones
  (yi-6b, granite-3-2b, qwen2.5-14b, chatglm3-6b), the MoE ones, RWKV6,
  the Mamba2 hybrid, enc-dec and the vision frontend -- in f32 and bf16:
  ``configs``, ``data.pipeline``, ``models.{layers,ssm,transformer}``,
  the prefill,
  decode and train steps of ``train.train_step``, ``train.optimizer``
  (AdamW), ``ckpt.checkpoint``, ``launch.serve`` and ``launch.train``,
  with flash attention for prefill and training and the paper's KDE
  decode attention;
- every estimator, the streaming engine and the multi-tenant servable.
See ROADMAP.md for what remains.
"""
