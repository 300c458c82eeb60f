#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and continues):

1. build    -- compile the CUDA kernels from ``src/repro_torch/csrc`` with
               nvcc (one process per source, started together) and print
               the build seconds and ptxas register / spill lines.
2. kernels  -- every kernel against its plain PyTorch version on the card:
               all four kernel kinds on ragged shapes (m=37, n=301, d=19,
               bn=70; the kde_hash kernels at m=37, t=45, d=19; laplacian
               also at d=784) and each kernel at its main-path shape;
               floats within rtol 2e-4 / atol 1e-5 (the reference's own
               kernel tolerance; the kde_hash kernels' atol scales with
               the output, see ``HASH_ATOL``), drawn blocks equal except
               on rows whose top two scores lie within 1e-5.  Times the
               kernel, its plain version and a PyTorch yardstick
               (``torch.cdist`` + elementwise + sum) with CUDA events, and
               every kernel's card time with torch.profiler
               (``device_ms``).  The sample-block kernel is also held to
               one device launch a call (profiler events), to int32 and
               int64 own giving the same result, to planted exact ties
               (two equal blocks, equal Gumbel noise: the lower block on
               every row, every kind) and to calls of several row counts
               in a row (its arrival counters reset themselves); the
               wide-tile ragged shapes (d = 8, 32) and, for the kde_hash
               kernels, x off 16-byte alignment join the ragged checks.
               ``host_us`` of the sample-block and weighted-kv wrappers,
               and the weighted-kv kernel's achieved rate of gathered
               bytes, are printed.
3. sparsify -- ``spectral_sparsify`` (exact level-1, Alg 5.1) at n=65536,
               d=16, t=10n, batch 1024, with counters checked against the
               analytic formula; after the main path, the law of all its
               drawn edges is checked by chi-square (sources per level-1
               block against the exact degrees, destinations by their
               probability integral transform under k(u, .) / deg(u)), and
               sum(w) against the exact total kernel mass, which only
               shows that the sums are consistent.
4. sampler  -- ``NeighborSampler.sample`` then ``prob_of`` (a second
               sampler, so the masked-blocksum kernel reads the frontier
               afresh) on a 4096-row frontier at n=65536.
5. lra      -- ``fkv_lowrank`` (Alg 5.15) on mnist_like(16384, 784) with
               the laplacian kernel, rank 20, 500 rows, against a block
               subspace iteration on the dense K computed on the card.
6. hash     -- ``spectral_sparsify(estimator="hash")`` (the sub-linear
               hashed-KDE path of Section 3.1) on gaussian_clusters(n =
               262144, d = 16), gaussian kernel at bandwidth 1.0, t = 10n,
               batch 1024, the reference's defaults (block size 512,
               max_bucket 128, far_per_block 2, 64 FAR samples per degree
               query, 8 hash dims, cell width 2.0).  Then, off the counted
               run: (1) hashing the rows on the card reproduces the host
               build's ``point_bucket``; (2) sum of the hashed degrees
               within 2% of the exact sum (blocksum kernel); (3) no fatal
               status flag, ``kernel_evals`` and ``kde_queries`` equal the
               reference's formulas; (4) the edge law -- sources by
               chi-square per level-1 block against the hashed degrees the
               sampler drew from, destinations by randomized PITs under
               k(u, .) restricted to the destination's block (level 2 is
               exact; the block law itself is estimated); (5) the spectral
               error at the reference's bench_kde spectral config within
               ``SPEC_BOUND``.  A per-stage breakdown of one edge batch
               follows, timed with CUDA events.
7. lm-prefill -- yi-6b at full width and depth (random f32 weights drawn
               on the card, 6.06 B parameters): ``make_prefill_step(impl=
               "flash")`` on ``make_batch`` tokens at batch 1, seq 8192
               (the reference's prefill_32k shape, 32768 x 32, cut to
               8192 x 1): exactly 32 flash launches; its last-position
               logits against ``impl="xla"`` (the chunked branch at 8192):
               max |diff| <= 1e-3 max |logit| and the same argmax per row.
8. lm-serve -- the port's serve driver (``launch.serve.run_lm``) on the
               same model, batch 4, prompt 512, gen 16, twice: ``--attention
               xla`` (its last-prompt-step logits against the flash prefill
               of the same prompts, same bound and argmax) and ``--attention
               kde`` (the CLI defaults top_p 4, bk 32, stride 4; cache 528
               rounded up to 544): exactly 32 x (512 + 15) launches of the
               fused KDE decode kernel and no block-lse launch, then on its
               final cache (layers 0, 15, 31) kde_attention through the
               kernel against the plain-torch mirror.  Prints the first
               generated step's logit correlation (kde vs xla, reported,
               not gated), prefill s and decode tok/s, a torch.profiler
               split of 8 decode steps of each attention, and their walls
               over three rounds of 8 steps taken in turns (xla, kde, kde,
               xla, xla, kde).
9. report   -- a ``{"kernels": [...]}`` line, the card line from
               nvidia-smi, and a last line ``{"ok": true, "device": ...}``.

Phase 2 also holds the two LM kernels against their plain versions
(``phase_lm_kernels``): flash at the reference's ragged sweep and (5, 37),
at head dims that take the scalar-staged instance (30, 7) and on k / v
rows off 16-byte alignment, f32 and bf16 operands, and at the prefill
shape (1, 32, 8192, 128) with 4 kv-heads, printing the kernel instance
each check ran; the fused KDE decode kernel (out and its step-1
estimates) against its plain pipeline and ``block_lse_plain`` at the
serve shape over kv_valid 1, 31, 32, 33, 527, 544, at S = 32768, bk
256, stride 16, top_p 16 (random and bench_attention's planted keys) and
at a 131072-key cache at the serve settings; the estimate-only block-lse
kernel at the same inputs.  Times the kernels
(``ms``: CUDA events around back-to-back calls, host cost included;
``device_ms``: torch.profiler's kernel durations), their plain versions
and, for flash, ``scaled_dot_product_attention(is_causal=True,
enable_gqa=True)`` as the yardstick.

Launch counters are set to 0 just before phase 3 and read just after
phase 5, set to 0 again just before phase 6 and read just after its
sparsifier returns, and again around the flash prefill of phase 7 and
the kde serve run of phase 8, so the comparisons and timings of phase 2
and the checks do not count.  Each kernel's ``launches`` is its count from
the run of its own path.

``bound_ms`` is the least time the card could take for a kernel's work at
its main-path shape: the larger of (bytes of every input read once and
every output written once) / 3.35 TB/s and (FP32 operations) / 67 TFLOP/s
(H100 SXM data sheet, non-tensor f32).  Operations are counted per
(query, dataset row) pair: 2d + 6 for the L2 kinds (d FMAs of the cross
term, the distance assembly, the scale, exp and the accumulate) and
3d + 3 for the laplacian (subtract, |.|, add per coordinate; scale, exp,
accumulate); the kde_hash kernels add one multiply by the weight per
pair and read each distinct gathered row of x once (x is 16 MB and stays
in the 50 MB L2).  Flash counts the causal half, 4 b hq dh s^2 / 2 FP32
operations (QK^T and PV), against q, k, v, out and lse; the KDE decode
kernel's work depends on the run's data (kv_valid and the selection): it
reads the strided keys below kv_valid once per kv-head, less those of the
selected blocks (they are read as gathered keys), and the gathered keys and
values below kv_valid, with q and out; 2 dh + 4 operations per (q-head,
strided key below kv_valid) and 4 dh + 4 per (q-head, selected key below
kv_valid) -- counted from the plain pipeline's selection on the same inputs
(``decode_bound``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL, ATOL = 2e-4, 1e-5
TIE = 1e-5
PEAK_FLOPS = 67e12          # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SP_N, SP_D, SP_BW = 65536, 16, 1.0
NS_FRONTIER = 4096
LRA_N, LRA_D, LRA_RANK, LRA_ROWS = 16384, 784, 20, 500
LRA_FACTOR = 1.5            # FKV error <= 1.5x the subspace-iteration error
MASS_RTOL = 1e-3            # |sum w - total/2| / (total/2)
CHI2_Z = 3.0902             # normal quantile of alpha = 1e-3
PIT_BINS = 100
BATCH = 1024
HS_N, HS_D, HS_BW = 262144, 16, 1.0
HS_MAX_BUCKET, HS_FAR_PER_BLOCK, HS_NUM_FAR = 128, 2, 64
HS_LAYOUT_SEED = 0 + 2 + 7919   # spectral_sparsify(seed=0)'s hashed layout
HS_DEG_RTOL = 0.02              # |sum deg_hash - sum deg_exact| / sum
# The hash kernels' outputs carry HT weights up to block_size/far_per_block
# = 256 (frontier reads) and n/num_far = 4096 (degree queries): their f32
# rounding scales with the output, so the atol is 1e-6 of the largest
# plain value (on top of rtol 2e-4).
HASH_ATOL = 1e-6
SPEC_N, SPEC_D, SPEC_SIGMA, SPEC_BW = 1024, 8, 0.35, 3.0
# 1.5x the largest spectral error of the JAX reference's
# spectral_sparsify(estimator="hash") at this config over seeds 0-4 on the
# CPU (tools/hash_spectral_bound.py: 0.04874407935336533).
SPEC_BOUND = 0.073116119030048
LM_ARCH = "yi_6b"
# the reference's prefill_32k shape (seq 32768, batch 32), cut to 8192 x 1
LM_PREFILL_SEQ, LM_PREFILL_BATCH = 8192, 1
LM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "512", "--gen", "16"]
LM_LOGIT_REL = 1e-3         # max |diff| <= 1e-3 max |logit|, same argmax
LM_KDE_LAYERS = (0, 15, 31)
BF16_ATOL = 3e-2            # the reference's bf16 flash tolerance
# (b, hq, hkv, sq, skv, dh): the reference's flash sweep and (5, 37)
FLASH_RAGGED = [(2, 4, 2, 64, 64, 32), (1, 8, 2, 1, 300, 64),
                (2, 4, 4, 100, 228, 16), (1, 2, 1, 17, 17, 8),
                (1, 2, 1, 5, 37, 16)]
# head dims that are not a multiple of 16 bytes: the scalar-staged instance
FLASH_SCALAR = [(1, 4, 2, 257, 257, 30), (1, 2, 2, 70, 70, 7)]
FLASH_MAIN = (1, 32, 4, 8192, 8192, 128)    # the prefill shape
# (b, hq, hkv, S, dh, bk, stride): the serve shape (yi's heads, cache 544)
# and bench_attention's production setting at yi's heads
LSE_SERVE = (4, 32, 4, 544, 128, 32, 4)
LSE_LONG = (1, 32, 4, 32768, 128, 256, 16)
# a long cache at the serve settings: 4096 blocks, 512 per CTA of a cluster
LSE_XL = (4, 32, 4, 131072, 128, 32, 4)
KDE_LONG_TOP_P = 16
KDE_SERVE_TOP_P = 4
# decode steps of the serve run around block edges, and its last step
KDE_VALID_SWEEP = (1, 31, 32, 33, 527, 544)


def log(*a):
    print(*a, flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA
    events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds per call of ``fn`` over ``reps`` calls after
    one warm-up: the host clock around the calls only, so a wrapper's
    Python and launch cost, not the card's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def close(got, want, what: str, atol: float = ATOL,
          rtol: float = RTOL) -> float:
    """Assert |got - want| <= atol + rtol |want| everywhere; return the
    max abs error."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} values outside rtol {rtol} / atol "
        f"{atol:.3e} (max abs err {float(err.max()):.3e})")
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite values"
    return float(err.max())


def check_blk(blk, bs_plain, gumbel, what: str) -> None:
    """Drawn blocks equal the plain argmax except on near-tie rows."""
    import torch
    score = torch.log(bs_plain) + gumbel
    top2 = torch.topk(score, min(2, score.shape[1]), dim=1).values
    tie = (top2[:, 0] - top2[:, -1]) <= TIE if score.shape[1] > 1 else \
        torch.zeros(score.shape[0], dtype=torch.bool, device=score.device)
    want = torch.argmax(score, dim=1)
    bad = (blk != want) & ~tie
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} drawn blocks differ"


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by) of a kernel call."""
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_ops(kind: str, d: int) -> int:
    return 3 * d + 3 if kind == "laplacian" else 2 * d + 6


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_SECONDS:.2f} s; library {build.source_hash()})")
    for line in build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            log("[build]", line.strip())


def phase_kernels(data, gen):
    """Phase 2: every kernel against its plain version; returns the
    report rows (launches filled in after the main path)."""
    import torch
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in ("rowsum", "blocksum", "masked_blocksum",
                             "sample_block")}

    def check_all(q, x, own, g, kind, inv_bw, beta, bn, tag):
        e = errs
        e["rowsum"] = max(e["rowsum"], close(
            rk.rowsum_cuda(q, x, kind, inv_bw, beta),
            rk.rowsum_plain(q, x, kind, inv_bw, beta), f"rowsum {tag}"))
        e["blocksum"] = max(e["blocksum"], close(
            rk.blocksum_cuda(q, x, kind, inv_bw, beta, bn),
            rk.blocksum_plain(q, x, kind, inv_bw, beta, bn),
            f"blocksum {tag}"))
        e["masked_blocksum"] = max(e["masked_blocksum"], close(
            sk.masked_blocksum_cuda(q, x, own, kind, inv_bw, beta, bn),
            sk.masked_blocksum_plain(q, x, own, kind, inv_bw, beta, bn),
            f"masked_blocksum {tag}"))
        got = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, beta, bn)
        want = sk.sample_block_plain(q, x, own, g, kind, inv_bw, beta, bn)
        check_blk(got[0], want[3], g, f"sample_block {tag}")
        e["sample_block"] = max(
            e["sample_block"],
            close(got[3], want[3], f"sample_block sums {tag}"),
            close(got[2], want[2], f"sample_block tot {tag}"))
        # p_blk against the plain sums at the kernel's own draw
        pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
        e["sample_block"] = max(e["sample_block"],
                                close(got[1], pb, f"sample_block p {tag}"))

    # ragged shapes, every kind (d = 19, 784: the sampler kernels' generic
    # tile; d = 8, 32: their wide tile padded to 16 and 32)
    for kind, d in [("gaussian", 19), ("exponential", 19),
                    ("rational_quadratic", 19), ("laplacian", 19),
                    ("laplacian", 784), ("exponential", 8),
                    ("rational_quadratic", 32)]:
        m, n, bn = 37, 301, 70
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        x = torch.randn(n, d, generator=gen, device=dev) * 0.3
        inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else \
            1.0 / (0.4 * d ** 0.5)
        own = torch.randint(-1, -(-n // bn), (m,), generator=gen, device=dev)
        g = gumbel((m, -(-n // bn)), gen, dev)
        check_all(q, x, own, g, kind, inv_bw, 0.7, bn, f"{kind} d={d} ragged")
        log(f"[kernels] ragged m={m} n={n} d={d} bn={bn} {kind}: ok")

    rows = []
    # main-path shapes
    xs, bw_l = data["lra_xs"], data["lra_bw"]
    q = xs[:BATCH].contiguous()
    inv = 1.0 / bw_l
    err = close(rk.rowsum_cuda(q, xs, "laplacian", inv),
                rk.rowsum_plain(q, xs, "laplacian", inv), "rowsum main")
    errs["rowsum"] = max(errs["rowsum"], err)
    m, n, d = q.shape[0], xs.shape[0], xs.shape[1]
    b_ms, b_by = bound(m * n * pair_ops("laplacian", d),
                       4 * (m * d + n * d + m))
    rows.append(dict(
        name="rowsum", route="cuda", source="src/repro_torch/csrc/kde_rowsum.cu",
        replaces="src/repro/kernels/kde_rowsum/kernel.py:137",
        shape=f"m={m} n={n} d={d} laplacian",
        ms=timed(lambda: rk.rowsum_cuda(q, xs, "laplacian", inv), 10),
        # its two kernels: blocksum_kernel's partials, rowsum_reduce_kernel
        device_ms=kernel_device_ms(
            lambda: rk.rowsum_cuda(q, xs, "laplacian", inv), "", 5),
        plain_ms=timed(lambda: rk.rowsum_plain(q, xs, "laplacian", inv), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: torch.cdist(q, xs, p=1).mul_(-inv).exp_()
                         .sum(1), 3)))

    x, bn = data["sp_x"], data["sp_bs"]
    n, d = x.shape
    nb = -(-n // bn)
    inv = 1.0 / SP_BW
    inv2 = inv * inv

    def cdist_blocks(qq):
        kv = torch.cdist(qq, x).square_().mul_(-inv2).exp_()
        return kv.view(qq.shape[0], nb, bn).sum(-1)

    q = x[:BATCH].contiguous()
    m = q.shape[0]
    errs["blocksum"] = max(errs["blocksum"], close(
        rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn),
        rk.blocksum_plain(q, x, "gaussian", inv, 1.0, bn), "blocksum main"))
    b_ms, b_by = bound(m * n * pair_ops("gaussian", d),
                       4 * (m * d + n * d + m * nb))
    rows.append(dict(
        name="blocksum", route="cuda", source="src/repro_torch/csrc/kde_rowsum.cu",
        replaces="src/repro/kernels/kde_rowsum/kernel.py:169",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn), 20),
        device_ms=kernel_device_ms(
            lambda: rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn),
            "blocksum_kernel", 20),
        plain_ms=timed(lambda: rk.blocksum_plain(q, x, "gaussian", inv, 1.0,
                                                 bn), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: cdist_blocks(q), 5)))

    src = data["ns_src"]
    q = x[src].contiguous()
    own = src // bn                 # int64, as the sampler hands it
    m = q.shape[0]
    errs["masked_blocksum"] = max(errs["masked_blocksum"], close(
        sk.masked_blocksum_cuda(q, x, own, "gaussian", inv, 1.0, bn),
        sk.masked_blocksum_plain(q, x, own, "gaussian", inv, 1.0, bn),
        "masked_blocksum main"))

    def cdist_masked():
        s = cdist_blocks(q)
        s[torch.arange(m, device=dev), own.long()] -= 1.0
        return s.clamp_(min=1e-12)

    b_ms, b_by = bound(m * n * pair_ops("gaussian", d),
                       4 * (m * d + n * d + m + m * nb))
    rows.append(dict(
        name="masked_blocksum", route="cuda",
        source="src/repro_torch/csrc/kde_sampler.cu",
        replaces="src/repro/kernels/kde_sampler/kernel.py:90",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: sk.masked_blocksum_cuda(q, x, own, "gaussian", inv,
                                                 1.0, bn), 10),
        device_ms=kernel_device_ms(lambda: sk.masked_blocksum_cuda(
            q, x, own, "gaussian", inv, 1.0, bn), "sampler_", 10),
        plain_ms=timed(lambda: sk.masked_blocksum_plain(
            q, x, own, "gaussian", inv, 1.0, bn), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=timed(cdist_masked, 3)))

    src = src[:BATCH]
    q = x[src].contiguous()
    own = src // bn                 # the edge batch's own blocks, int64
    m = q.shape[0]
    g = gumbel((m, nb), gen, dev)
    plan = sk.sample_block_plan(
        m, n, d, bn, sms=torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    got = sk.sample_block_cuda(q, x, own, g, "gaussian", inv, 1.0, bn)
    want = sk.sample_block_plain(q, x, own, g, "gaussian", inv, 1.0, bn)
    check_blk(got[0], want[3], g, "sample_block main")
    assert got[0].dtype == torch.int64, got[0].dtype
    pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
    errs["sample_block"] = max(errs["sample_block"],
                               close(got[3], want[3], "sample_block main"),
                               close(got[2], want[2], "sample_block tot main"),
                               close(got[1], pb, "sample_block p main"))
    got32 = sk.sample_block_cuda(q, x, own.to(torch.int32), g, "gaussian",
                                 inv, 1.0, bn)
    assert all(torch.equal(a, b) for a, b in zip(got32, got)), \
        "sample_block: int32 and int64 own differ"
    per_call = launches_per_call(
        lambda: sk.sample_block_cuda(q, x, own, g, "gaussian", inv, 1.0, bn),
        10)
    assert per_call == 1.0, f"sample_block: {per_call} launches a call"
    log(f"[kernels] sample_block main: plan {plan}; {per_call:.0f} device "
        f"launch a call (torch.profiler); int32 and int64 own agree")
    sample_block_draw_checks(x, bn, gen)
    b_ms, b_by = bound(m * n * pair_ops("gaussian", d) + 3 * m * nb,
                       4 * (m * d + n * d + m + 2 * m * nb + 3 * m))
    rows.append(dict(
        name="sample_block", route="cuda",
        source="src/repro_torch/csrc/kde_sampler.cu",
        replaces="src/repro/kernels/kde_sampler/kernel.py:129",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: sk.sample_block_cuda(q, x, own, g, "gaussian", inv,
                                              1.0, bn), 20),
        device_ms=kernel_device_ms(lambda: sk.sample_block_cuda(
            q, x, own, g, "gaussian", inv, 1.0, bn), "sampler_", 20),
        host_us=host_us(lambda: sk.sample_block_cuda(
            q, x, own, g, "gaussian", inv, 1.0, bn), 200),
        plain_ms=timed(lambda: sk.sample_block_plain(
            q, x, own, g, "gaussian", inv, 1.0, bn), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log_row(r)
    return rows


def log_row(r) -> None:
    host = f", host {r['host_us']:.2f} us a call" if "host_us" in r else ""
    log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
        f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (device "
        f"{r.get('device_ms')}{host}, plain {r['plain_ms']:.4f}, library "
        f"{r['library_ms']}, bound {r['bound_ms']:.5f} by {r['bound_by']})")


def sample_block_draw_checks(x, bn, gen):
    """The fused draw of the sample-block kernel on the card: (1) planted
    exact ties at the main shape's n, d and bn go to the lower block on
    every row, every kind; (2) calls of several row counts in a row, each
    with fresh noise, match the plain version, so every launch leaves its
    tiles' arrival counters at 0."""
    import torch
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    dev = x.device
    n, d = x.shape
    nb = -(-n // bn)
    lo, hi = 1, nb - 2
    # dyadic coordinates: every distance is exact in f32 in any order, so
    # block hi (a copy of block lo) has bitwise equal sums
    xt = torch.randint(-4, 5, (n, d), generator=gen, device=dev) / 8.0
    xt[hi * bn:(hi + 1) * bn] = xt[lo * bn:(lo + 1) * bn]
    qt = torch.randint(-4, 5, (BATCH, d), generator=gen, device=dev) / 8.0
    own = torch.randint(-1, nb, (BATCH,), generator=gen, device=dev)
    own[(own == lo) | (own == hi)] = -1
    g = gumbel((BATCH, nb), gen, dev)
    g[:, lo] = g[:, hi] = 30.0
    for kind in ("gaussian", "exponential", "rational_quadratic",
                 "laplacian"):
        inv = 1.0 / (0.25 * d) if kind == "laplacian" else \
            1.0 / (0.5 * d ** 0.5)
        blk, _, tot, bs = sk.sample_block_cuda(qt, xt, own, g, kind, inv,
                                               0.7, bn)
        assert torch.equal(bs[:, lo], bs[:, hi]), f"tie sums differ {kind}"
        assert bool((blk == lo).all()), (
            f"sample_block ties {kind}: {int((blk != lo).sum())} rows did "
            f"not take the lower block")
        want = sk.sample_block_plain(qt, xt, own, g, kind, inv, 0.7, bn)
        close(bs, want[3], f"sample_block ties sums {kind}")
        close(tot, want[2], f"sample_block ties tot {kind}")
    log(f"[kernels] sample_block planted ties (blocks {lo} and {hi} equal, "
        f"equal Gumbel noise, {BATCH} rows, every kind): the lower block "
        f"on every row")
    ms = (BATCH, 37, 300, 1, BATCH, 129, 4096, BATCH)
    for m in ms:
        q = x[torch.randint(0, n, (m,), generator=gen, device=dev)]
        own = torch.randint(-1, nb, (m,), generator=gen, device=dev)
        g = gumbel((m, nb), gen, dev)
        got = sk.sample_block_cuda(q, x, own, g, "gaussian", 1.0 / SP_BW,
                                   1.0, bn)
        want = sk.sample_block_plain(q, x, own, g, "gaussian", 1.0 / SP_BW,
                                     1.0, bn)
        check_blk(got[0], want[3], g, f"sample_block repeated m={m}")
        close(got[3], want[3], f"sample_block repeated sums m={m}")
        pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
        close(got[1], pb, f"sample_block repeated p m={m}")
    log(f"[kernels] sample_block repeated calls, m = {ms}: every draw "
        f"matches (the arrival counters reset themselves)")


def phase_sparsify(data):
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    n = SP_N
    t = 10 * n
    t0 = time.perf_counter()
    g = spectral_sparsify(data["sp_x_np"], gaussian(SP_BW), num_edges=t,
                          estimator="exact", exact_blocks=True, seed=0,
                          batch=BATCH, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bs = data["sp_bs"]
    drawn = -(-t // BATCH) * BATCH
    assert rk.LAUNCHES["blocksum"] > 0, "degrees did not use the blocksum kernel"
    assert sk.LAUNCHES["sample_block"] > 0, \
        "edge batches did not use the sample-block kernel"
    assert g.kernel_evals == n * n + drawn * (n + bs + 1), g.kernel_evals
    assert g.kde_queries == n + drawn, g.kde_queries
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    assert g.src.min() >= 0 and g.src.max() < n and g.dst.max() < n
    log(f"[sparsify] n={n} d={SP_D} t={t}: {secs:.2f} s, "
        f"{t / secs:.0f} edges/s, kernel_evals={g.kernel_evals}, "
        f"status={g.status}")
    return g, secs


def chi2_critical(df: int) -> float:
    """Upper alpha = 1e-3 point of chi-square(df) by the Wilson-Hilferty
    approximation (within 0.1% of the exact point for df >= 50)."""
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + CHI2_Z * a ** 0.5) ** 3


def chi2_test(counts, expected, what: str) -> str:
    """Pearson chi-square of ``counts`` against ``expected`` (float64
    tensors; cells expecting fewer than 5 pooled into one) at alpha 1e-3;
    returns the log text."""
    import torch
    small = expected < 5.0
    if bool(small.any()):
        counts = torch.cat([counts[~small], counts[small].sum()[None]])
        expected = torch.cat([expected[~small], expected[small].sum()[None]])
    stat = float(((counts - expected) ** 2 / expected).sum())
    df = counts.numel() - 1
    crit = chi2_critical(df)
    assert stat < crit, f"{what}: chi-square {stat:.1f} >= {crit:.1f} (df {df})"
    return f"{what} chi-square {stat:.2f} < {crit:.2f} (df {df})"


def exact_degrees(x, inv_bw):
    """deg(u) = sum_{v != u} k(u, v) by the plain version, in float64."""
    import torch
    from repro_torch.kernels.kde_rowsum import kernel as rk
    return torch.cat([
        rk.rowsum_plain(x[lo:lo + BATCH], x, "gaussian", inv_bw).double()
        for lo in range(0, x.shape[0], BATCH)]) - 1.0


def edge_law(data, g, deg):
    """Chi-square checks of the main-path sparsifier's own edges against
    the exact law of Alg 5.1, with the plain versions on the card:

    - sources u ~ deg(u) / sum deg: counts per level-1 block against the
      blocks' degree mass;
    - destinations v ~ k(u, .) / deg(u) over v != u, by two randomized
      probability integral transforms, each uniform on [0, 1) exactly when
      every v follows its source's neighbor law: F_u(v-) + r k(u, v) in
      index order (sees a draw from the wrong block or column), and the
      mass of the w with k(u, w) < k(u, v) plus r times the mass of its
      ties, in kernel-value order (sees a law too flat or too sharp);
      each divided by deg(u), r ~ U[0, 1), in PIT_BINS equal bins.

    This reads the block drawn by the Gumbel-max kernel and the in-block
    draw of every edge, which the weight sum cannot see (with exact reads
    every weight is total / (2t) whatever was drawn)."""
    import torch
    from repro_torch.kernels.kde_rowsum.ref import kernel_values
    x, bn = data["sp_x"], data["sp_bs"]
    n, dev = x.shape[0], x.device
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    t = src.numel()
    nb = -(-n // bn)
    blk_mass = torch.zeros(nb, dtype=torch.float64, device=dev)
    blk_mass.index_add_(0, torch.arange(n, device=dev) // bn, deg)
    got = torch.bincount(src // bn, minlength=nb).double()
    texts = [chi2_test(got, t * blk_mass / blk_mass.sum(), "sources")]

    gen = torch.Generator(device=dev).manual_seed(1)
    pit = torch.empty((2, t), dtype=torch.float64, device=dev)
    for lo in range(0, t, BATCH):
        u, v = src[lo:lo + BATCH], dst[lo:lo + BATCH]
        rows = torch.arange(u.numel(), device=dev)
        kv = kernel_values(x[u], x, "gaussian", 1.0 / SP_BW).double()
        kv[rows, u] = 0.0                        # no self edges
        kuv = kv[rows, v][:, None]
        tot = kv.sum(1)
        r = torch.rand((2, u.numel()), generator=gen, device=dev,
                       dtype=torch.float64)
        below_idx = torch.cumsum(kv, dim=1)[rows, v] - kuv[:, 0]
        below_val = torch.where(kv < kuv, kv, 0.0).sum(1)
        ties = torch.where(kv == kuv, kv, 0.0).sum(1)
        pit[0, lo:lo + BATCH] = (below_idx + r[0] * kuv[:, 0]) / tot
        pit[1, lo:lo + BATCH] = (below_val + r[1] * ties) / tot
    for row, what in zip(pit, ("destinations, index order",
                               "destinations, value order")):
        got = torch.histc(row, bins=PIT_BINS, min=0.0, max=1.0).double()
        texts.append(chi2_test(got, torch.full_like(got, t / PIT_BINS),
                               what))
    return "; ".join(texts)


def phase_sampler(data):
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.kernels.kde_sampler import kernel as sk
    t0 = time.perf_counter()
    x = data["sp_x"]
    src = data["ns_src"].cpu().numpy()
    nbr = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=3,
                          device="cuda")
    v, p = nbr.sample(src)
    fresh = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=4,
                            device="cuda")
    before = sk.LAUNCHES["masked_blocksum"]
    p_fresh = fresh.prob_of(src, v)
    assert sk.LAUNCHES["masked_blocksum"] > before, \
        "prob_of did not use the masked-blocksum kernel"
    p_cached = nbr.prob_of(src, v)
    np.testing.assert_allclose(p_fresh, p, rtol=1e-4)
    np.testing.assert_allclose(p_cached, p, rtol=1e-4)
    assert np.all(v != src) and np.all(p > 0) and np.all(np.isfinite(p))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[sampler] frontier {len(src)} at n={x.shape[0]}: prob_of matches "
        f"the realized probabilities (max rel err "
        f"{float(np.max(np.abs(p_fresh - p) / p)):.2e}); {secs:.2f} s")
    return secs


def phase_lra(data):
    import torch
    from repro_torch.core.kernels_fn import laplacian
    from repro_torch.core.lowrank import fkv_lowrank
    from repro_torch.kernels.kde_rowsum import kernel as rk
    ker = laplacian(data["lra_bw"])
    t0 = time.perf_counter()
    res = fkv_lowrank(data["lra_x_np"], ker, rank=LRA_RANK,
                      num_rows=LRA_ROWS, estimator="exact", seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = LRA_N
    assert rk.LAUNCHES["rowsum"] > 0, "row norms did not use the rowsum kernel"
    assert res.kernel_evals == n * n + LRA_ROWS * n, res.kernel_evals
    assert res.u.shape == (LRA_RANK, n)
    return res, secs


def lra_errors(data, res):
    """(FKV, subspace iteration) relative Frobenius errors on the dense K,
    computed in float64 on the card by the plain versions."""
    import torch
    from repro_torch.kernels.kde_sampler.ref import l1_dists
    x = data["lra_x"]
    k = torch.exp(-l1_dists(x, x) / data["lra_bw"]).double()
    fro2 = float((k * k).sum())

    def err(u):                      # u (r, n), orthonormal rows
        u, _ = torch.linalg.qr(u.T)
        r = k - (k @ u) @ u.T
        return float((r * r).sum()) / fro2

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.linalg.qr(torch.randn(k.shape[0], LRA_RANK, generator=gen,
                                    device="cuda", dtype=torch.float64)).Q
    for _ in range(10):
        q = torch.linalg.qr(k @ q).Q
    u_fkv = torch.as_tensor(res.u, device="cuda")
    return err(u_fkv), err(q.T)


def close_scaled(got, want, what: str) -> float:
    """``close`` with the kde_hash kernels' atol: HASH_ATOL times the
    largest |plain value|."""
    return close(got, want, what, HASH_ATOL * float(want.abs().max()))


def hash_layout(x):
    """The hashed layout ``spectral_sparsify(estimator="hash", seed=0)``
    builds over ``x`` (its sampler's ``HashedKDE``), and its cell width."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_hash.ops import build_hash_state
    return build_hash_state(x, gaussian(HS_BW), max_bucket=HS_MAX_BUCKET,
                            seed=HS_LAYOUT_SEED, device=x.device)


def phase_hash_kernels(data, gen):
    """Phase 2, kde_hash part: both weighted kernels against their plain
    versions (every kind, ragged; then the main-path shapes, whose
    columns and weights come from the hash phase's own layout and
    gathers); returns the two report rows."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    dev = torch.device("cuda")
    errs = {"weighted_kv_sum": 0.0, "weighted_kv": 0.0}

    def check(q, x, cols, wgt, kind, inv_bw, beta, tag):
        args = (q, x, cols, wgt, kind, inv_bw, beta)
        errs["weighted_kv"] = max(errs["weighted_kv"], close_scaled(
            hk.weighted_kv_cuda(*args), hk.weighted_kv_plain(*args),
            f"weighted_kv {tag}"))
        errs["weighted_kv_sum"] = max(errs["weighted_kv_sum"], close_scaled(
            hk.weighted_kv_sum_cuda(*args), hk.weighted_kv_sum_plain(*args),
            f"weighted_kv_sum {tag}"))

    # ragged, every kind: d = 19, 784 and x off 16 bytes take the scalar
    # instance, d = 8, 16, 32 the vector one
    for kind, d, aligned in [("gaussian", 19, True), ("exponential", 19, True),
                             ("rational_quadratic", 19, True),
                             ("laplacian", 19, True), ("laplacian", 784, True),
                             ("gaussian", 8, True), ("laplacian", 16, True),
                             ("rational_quadratic", 32, True),
                             ("gaussian", 16, False)]:
        m, t, n = 37, 45, 301
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        flat = torch.randn(n * d + 1, generator=gen, device=dev) * 0.3
        x = (flat[:-1] if aligned else flat[1:]).view(n, d)
        cols = torch.randint(-2, n + 2, (m, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((m, t), generator=gen, device=dev) * 256.0
        inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else \
            1.0 / (0.4 * d ** 0.5)
        plan = hk.weighted_kv_plan(m, n, d, t, x.data_ptr() % 16 == 0)
        check(q, x, cols, wgt, kind, inv_bw, 0.7, f"{kind} d={d} ragged")
        log(f"[kernels] ragged m={m} t={t} d={d} {kind}"
            f"{'' if aligned else ', x off 16 bytes'} [{plan}]: ok")

    x, state, cw = data["hs_x"], data["hs_state"], data["hs_cw"]
    n, d = x.shape
    bn = data["hs_bs"]
    nb = -(-n // bn)
    inv = 1.0 / HS_BW
    rows = []
    # one degree batch (hashed_query) and one edge batch's frontier read
    q = x[:BATCH].contiguous()
    fidx = hops.draw_query_noise(BATCH, HS_NUM_FAR, n, gen, dev)
    qcols, qwgt, _, _ = href.query_gather(q, state, fidx, cw, HS_NUM_FAR, n)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    off = hops.draw_frontier_noise(BATCH, nb, HS_FAR_PER_BLOCK, bn, gen, dev)
    fcols, fwgt, _, _ = href.frontier_gather(src, state, off,
                                             HS_FAR_PER_BLOCK, bn, nb, n)
    fq = x[src].contiguous()
    for name, qq, cols, wgt, line, sum_out in (
            ("weighted_kv_sum", q, qcols, qwgt, 87, True),
            ("weighted_kv", fq, fcols, fwgt, 97, False)):
        kern = hk.weighted_kv_sum_cuda if sum_out else hk.weighted_kv_cuda
        plain = hk.weighted_kv_sum_plain if sum_out else hk.weighted_kv_plain
        args = (qq, x, cols, wgt, "gaussian", inv)
        errs[name] = max(errs[name], close_scaled(kern(*args), plain(*args),
                                                  f"{name} main"))
        m, t = cols.shape
        uniq = torch.unique(cols).numel()
        b_ms, b_by = bound(m * t * (pair_ops("gaussian", d) + 1),
                           4 * (m * d + 2 * m * t + (m if sum_out else m * t)
                                + uniq * d))
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/kde_hash.cu",
            replaces=f"src/repro/kernels/kde_hash/kernel.py:{line}",
            shape=f"m={m} t={t} d={d} gaussian, {uniq} distinct rows",
            ms=timed(lambda: kern(*args), 50),
            device_ms=kernel_device_ms(lambda: kern(*args), "weighted_kv",
                                       50),
            plain_ms=timed(lambda: plain(*args), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        if not sum_out:
            rows[-1]["host_us"] = host_us(lambda: kern(*args), 200)
        gathered = m * t * d * 4
        dms = rows[-1]["device_ms"]
        rate = "not measured" if dms is None else \
            f"{gathered / (dms * 1e-3) / 1e12:.2f} TB/s"
        log(f"[kernels] {name} main [{hk.weighted_kv_plan(m, n, d, t)}]: "
            f"gathers {gathered / 1e6:.1f} MB of x rows through L2 "
            f"({gathered / (uniq * d * 4):.2f}x the distinct rows) at {rate} "
            f"on the card, against the HBM bound's {PEAK_BYTES / 1e12:.2f} "
            f"TB/s over the distinct rows")
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log_row(r)
    return rows


def free_cuda():
    """Hand a phase's freed tensors back to the card before the next."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def decode_bound(q, k, kw, est):
    """bound() of one kde_decode call on this run's data: ``est`` (b, hq,
    nb) is the plain pipeline's step 1 on the same inputs, so its top-P
    selection is the call's."""
    import torch
    from repro_torch.kernels.kde_attention import ref as kref
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    bk, stride, kv = kw["bk"], kw["stride"], kw["kv_valid"]
    nb = s // bk
    sel = kref.top_blocks(kref._group_lse(est, hq // hkv),
                          min(kw["top_p"], nb)).cpu()    # (b, hkv, P)
    blk = torch.arange(nb)
    strided = ((blk[:, None] * bk + torch.arange(0, bk, stride)[None])
               < kv).sum(1)                 # strided keys below kv_valid
    gathered = (kv - blk * bk).clamp(0, bk)     # block keys below kv_valid
    n_str = b * hkv * int(strided.sum())
    n_gat = int(gathered[sel].sum())
    rows = n_str - int(strided[sel].sum()) + 2 * n_gat
    g = hq // hkv
    return bound(g * (n_str * (2 * dh + 4) + n_gat * (4 * dh + 4)),
                 4 * (rows * dh + 2 * b * hq * dh))


def phase_lm_kernels(gen):
    """Phase 2, LM part: the flash kernel against its plain version on the
    card (ragged, scalar-staged, bf16, the prefill shape); the fused KDE
    decode kernel against its plain pipeline (out and its step-1
    estimates, the latter also against block_lse_plain) over the serve
    run's decode steps and at S = 32768 with bench_attention's planted
    keys; the estimate-only block-lse kernel against its plain version;
    returns the two report rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    dev = torch.device("cuda")
    errs = {"flash_attention": 0.0, "kde_decode": 0.0}

    def qkv(b, hq, hkv, sq, skv, dh, dtype=torch.float32):
        # q, k contiguous and v a transposed view: as the model hands them
        q = torch.randn((b, hq, sq, dh), generator=gen, device=dev)
        k = torch.randn((b, hkv, skv, dh), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, dh), generator=gen,
                        device=dev).transpose(1, 2)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def flash_check(q, k, v, bq, bk, tag):
        kp, vp, kw = fops.flash_args(q, k, v, True, bq, bk)
        out, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
        p_out, p_lse = fk.flash_attention_plain(q, kp, vp, **kw)
        inst = fk.instantiation(q, kp, vp)
        if q.dtype == torch.bfloat16:
            e = close(out.float(), p_out.float(), f"flash out {tag}",
                      atol=BF16_ATOL, rtol=0.0)
            close(lse, p_lse, f"flash lse {tag}")
            return e, inst
        e = max(close(out, p_out, f"flash out {tag}"),
                close(lse, p_lse, f"flash lse {tag}"))
        errs["flash_attention"] = max(errs["flash_attention"], e)
        return e, inst

    for kind, shapes in (("ragged", FLASH_RAGGED), ("scalar", FLASH_SCALAR)):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                e, inst = flash_check(*qkv(*shape, dtype=dtype), 64, 64,
                                      f"{shape} {dtype}")
                log(f"[kernels] flash {kind} (b, hq, hkv, sq, skv, dh) = "
                    f"{shape} {str(dtype)[6:]} [{inst}]: max_abs_err "
                    f"{e:.3e}")
    # rows 4 bytes off 16-byte alignment: k / v views into a flat buffer
    # (skv a multiple of the block, so flash_args does not pad them)
    q, _, _ = qkv(1, 4, 2, 256, 256, 64)
    flat = torch.randn(2, 2 * 256 * 64 + 1, generator=gen, device=dev)
    k, v = (t[1:].view(1, 2, 256, 64) for t in flat)
    e, inst = flash_check(q, k, v, 64, 64, "unaligned rows")
    assert inst.endswith("scalar"), inst
    log(f"[kernels] flash unaligned k / v rows (1, 4, 2, 256, 256, 64) "
        f"[{inst}]: max_abs_err {e:.3e}")

    rows = []
    b, hq, hkv, s, _, dh = FLASH_MAIN
    q, k, v = qkv(*FLASH_MAIN)
    e, inst = flash_check(q, k, v, 128, 128, "main")
    log(f"[kernels] flash main {FLASH_MAIN} [{inst}]: max_abs_err {e:.3e}")
    free_cuda()
    kp, vp, kw = fops.flash_args(q, k, v)
    b_ms, b_by = bound(4 * b * hq * dh * s * s / 2,
                       4 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh
                            + b * hq * s))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:67",
        shape=f"b={b} hq={hq} hkv={hkv} s={s} dh={dh} causal f32 [{inst}]",
        ms=timed(lambda: fk.flash_attention_cuda(q, kp, vp, **kw), 5),
        device_ms=kernel_device_ms(
            lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
            "flash_fwd_kernel", 3),
        plain_ms=timed(lambda: fk.flash_attention_plain(q, kp, vp, **kw), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 3)))
    del q, k, v, kp, vp
    free_cuda()

    def decode_inputs(b, hq, hkv, s, dh):
        q = torch.randn((b, hq, dh), generator=gen, device=dev)
        k = torch.randn((b, hkv, s, dh), generator=gen, device=dev) * 0.3
        v = torch.randn((b, hkv, s, dh), generator=gen, device=dev)
        return q, k, v

    def decode_check(q, k, v, kw, tag):
        """Fused kernel vs plain pipeline (out, est), est vs block_lse_plain
        and, at the same kv_valid, the estimate-only kernel vs it."""
        out, est = kk.kde_decode_cuda(q, k, v, with_est=True, **kw)
        p_out, p_est = kk.kde_decode_plain(q, k, v, with_est=True, **kw)
        lse_kw = dict(scale=q.shape[-1] ** -0.5, stride=kw["stride"],
                      kv_valid=kw["kv_valid"], bk=kw["bk"])
        want_est = kk.block_lse_plain(q, k, **lse_kw)
        e = max(close(out, p_out, f"kde_decode out {tag}"),
                close(est, p_est, f"kde_decode est {tag}"),
                close(est, want_est, f"kde_decode est vs block_lse {tag}"))
        got = kk.block_lse_cuda(q, k, **lse_kw)
        e_lse = close(got, want_est, f"block_lse {tag}")
        dead = -(-kw["kv_valid"] // kw["bk"])
        for name, t in (("kde_decode est", est), ("block_lse", got)):
            assert bool((t[..., dead:] == -1e30).all()), f"{name} {tag}"
        errs["kde_decode"] = max(errs["kde_decode"], e)
        return e, e_lse

    b, hq, hkv, s, dh, bk, stride = LSE_SERVE
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    for kv_valid in (1, 300, s - 16):     # early, middle and last steps
        lse_kw = dict(scale=dh ** -0.5, stride=stride, kv_valid=kv_valid,
                      bk=bk)
        got = kk.block_lse_cuda(q, k, **lse_kw)
        close(got, kk.block_lse_plain(q, k, **lse_kw),
              f"block_lse kv={kv_valid}")
        assert bool((got[..., -(-kv_valid // bk):] == -1e30).all())
    for kv_valid in KDE_VALID_SWEEP:
        kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride,
                  kv_valid=kv_valid)
        e, e_lse = decode_check(q, k, v, kw, f"serve kv={kv_valid}")
        log(f"[kernels] kde_decode serve shape kv_valid {kv_valid}: out and "
            f"est max_abs_err {e:.3e}; block_lse (estimate-only kernel) "
            f"{e_lse:.3e}")
    kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride, kv_valid=s - 17)
    b_ms, b_by = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    rows.append(dict(
        name="kde_decode", route="cuda",
        source="src/repro_torch/csrc/kde_attention.cu",
        replaces="src/repro/kernels/kde_attention/kernel.py:40",
        shape=f"b={b} hq={hq} hkv={hkv} S={s} dh={dh} bk={bk} "
              f"stride={stride} top_p={KDE_SERVE_TOP_P} kv_valid={s - 17}",
        ms=timed(lambda: kk.kde_decode_cuda(q, k, v, **kw), 200),
        device_ms=kernel_device_ms(lambda: kk.kde_decode_cuda(q, k, v, **kw),
                                   "kde_decode_kernel", 200),
        plain_ms=timed(lambda: kk.kde_decode_plain(q, k, v, **kw), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"[kernels] kde_decode wrapper host time: "
        f"{host_us(lambda: kk.kde_decode_cuda(q, k, v, **kw), 200):.2f} us a "
        f"call (host clock over 200 calls, no synchronize inside)")
    lse_kw = dict(scale=dh ** -0.5, stride=stride, kv_valid=s - 17, bk=bk)
    lse_ms = timed(lambda: kk.block_lse_cuda(q, k, **lse_kw), 200)
    lse_dev = kernel_device_ms(lambda: kk.block_lse_cuda(q, k, **lse_kw),
                               "block_lse_kernel", 200)
    log(f"[kernels] block_lse (estimate-only kernel, off the decode path) "
        f"serve shape: {lse_ms:.4f} ms a call, device {lse_dev} ms")

    b, hq, hkv, s, dh, bk, stride = LSE_LONG
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    kw = dict(top_p=KDE_LONG_TOP_P, bk=bk, stride=stride, kv_valid=s)
    e, e_lse = decode_check(q, k, v, kw, "S=32768")
    log(f"[kernels] kde_decode S={s} random keys: max_abs_err {e:.3e}; "
        f"block_lse {e_lse:.3e}")
    # bench_attention's peaked mass at yi's heads: planted keys dominate
    # the S-key background
    k = torch.randn((b, hkv, s, dh), generator=gen, device=dev) * 0.05
    qv = q.reshape(b, hkv, hq // hkv, dh).mean(2)
    qv = qv / torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    k[:, :, 50:90] += 8.0 * qv[:, :, None]
    k[:, :, s // 2:s // 2 + 30] += 6.0 * qv[:, :, None]
    e, e_lse = decode_check(q, k, v, kw, "S=32768 planted")
    b_ms, _ = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    kw = dict(top_p=KDE_LONG_TOP_P, bk=bk, stride=stride)
    out = kops.kde_attention(q, k, v, **kw)
    close(out, kops.kde_attention_ref(q, k, v, **kw), "kde_attention S=32768")
    exact = kops.exact_decode_attention(q, k, v)
    dms = kernel_device_ms(lambda: kops.kde_attention(q, k, v, **kw),
                           "kde_decode_kernel", 50)
    log(f"[kernels] kde_decode S={s} (top_p {KDE_LONG_TOP_P}, bk {bk}, "
        f"stride {stride}, planted keys) through ops.kde_attention: kernel "
        f"= plain pipeline (max_abs_err {e:.3e}); device {dms} ms a launch, "
        f"bound {b_ms:.5f} ms; max |kde - exact| / max |exact| = "
        f"{float((out - exact).abs().max() / exact.abs().max()):.4e}")
    del q, k, v, out, exact
    free_cuda()

    b, hq, hkv, s, dh, bk, stride = LSE_XL
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    for kv_valid in (s // 2 + 3, s):
        kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride,
                  kv_valid=kv_valid)
        e, e_lse = decode_check(q, k, v, kw, f"S={s} kv={kv_valid}")
    b_ms, _ = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    dms = kernel_device_ms(lambda: kk.kde_decode_cuda(q, k, v, **kw),
                           "kde_decode_kernel", 50)
    log(f"[kernels] kde_decode S={s} (b {b}, bk {bk}, stride {stride}, "
        f"top_p {KDE_SERVE_TOP_P}; {s // bk} blocks): max_abs_err {e:.3e}; "
        f"block_lse {e_lse:.3e}; device {dms} ms a launch, bound "
        f"{b_ms:.5f} ms")
    del q, k, v
    free_cuda()
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (device "
            f"{r['device_ms']}, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")
    log("[kernels] kde_decode library_ms null: no PyTorch call computes "
        "KDE block selection with attention over the selected blocks")
    return rows


def logit_check(got, want, vocab: int, what: str) -> str:
    """max |got - want| <= LM_LOGIT_REL max |want| over the real vocab, and
    the same argmax on every row; returns the log text."""
    import torch
    got, want = got[..., :vocab].double(), want[..., :vocab].double()
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite logits"
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    assert diff <= LM_LOGIT_REL * top, (what, diff, top)
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    assert same, f"{what}: argmax differs"
    return (f"max |diff| {diff:.3e} <= {LM_LOGIT_REL} x max |logit| "
            f"{top:.4f}; argmax equal on all {got.shape[0]} rows")


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(fn, reps: int):
    """{name: (launches, device us)} of every CUDA kernel (and memset or
    copy) in a torch.profiler trace of ``reps`` calls of ``fn``, after one
    warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, _dev_us(e)) for e in prof.key_averages()
            if _dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")}


def kernel_device_ms(fn, kernel: str, reps: int):
    """Mean device ms per call of ``fn`` in the CUDA kernels whose names
    contain ``kernel`` ("" for all of them), from torch.profiler's kernel
    durations over ``reps`` calls (so the host's cost per call is left
    out); None, printed as not measured, when the trace shows no such
    kernel."""
    hit = [us for name, (_, us) in device_kernels(fn, reps).items()
           if kernel in name]
    return sum(hit) / reps / 1e3 if hit else None


def launches_per_call(fn, reps: int) -> float:
    """Device launches (kernels, memsets, copies) per call of ``fn`` in a
    torch.profiler trace; NaN when the trace shows no device activity."""
    ks = device_kernels(fn, reps)
    return sum(c for c, _ in ks.values()) / reps if ks else float("nan")


def device_profile(fn, top: int = 4):
    """(wall s without the profiler, device s, busy share, the ``top``
    kernels by device time) of one call of ``fn``: the wall time from a
    host clock around a run ending in a synchronize, the device time from
    a ``torch.profiler`` trace of a second run (the sum of the CUDA
    kernels' self time; one stream, so they do not overlap).  A trace that
    shows no device time gives device s 0.0, printed as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if _dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(_dev_us(e) for e in kern) / 1e6
    kern.sort(key=_dev_us, reverse=True)
    names = [(e.key[:60], _dev_us(e) / 1e6, e.count) for e in kern[:top]]
    return wall, busy, busy / wall, names


def profile_text(wall, busy, share, names) -> str:
    if busy == 0.0:
        return (f"wall {wall:.4f} s; device time not measured (the trace "
                f"shows none)")
    return (f"wall {wall:.4f} s, device busy {busy:.4f} s ({share:.1%}; "
            f"idle share {1 - share:.1%}); top kernels: " + "; ".join(
                f"{n} {t:.4f} s x{c}" for n, t, c in names))


def phase_lm_prefill():
    """Phase 7: yi-6b at full width and depth, the flash prefill counted
    and checked against xla."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_prefill_step
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # the reference's param_count leaves out the final norm's d gains
    assert n_params == cfg.param_count() + cfg.d_model, n_params
    log(f"[lm-prefill] {cfg.name} f32 random init on the card: {n_params} "
        f"parameters ({4 * n_params / 1e9:.2f} GB), "
        f"{time.perf_counter() - t0:.2f} s")
    shape = ShapeConfig("prefill_8k", LM_PREFILL_SEQ, LM_PREFILL_BATCH,
                        "prefill")
    batch = make_batch(cfg, shape, 0, 0)
    tokens = LM_PREFILL_SEQ * LM_PREFILL_BATCH
    fk.reset_launches()
    t0 = time.perf_counter()
    flash = make_prefill_step(cfg, impl="flash")(model, batch)
    torch.cuda.synchronize()
    t_flash = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention"]
    assert launches == cfg.num_layers, launches
    t0 = time.perf_counter()
    xla = make_prefill_step(cfg, impl="xla")(model, batch)
    torch.cuda.synchronize()
    t_xla = time.perf_counter() - t0
    text = logit_check(flash[:, -1], xla[:, -1], cfg.vocab_size,
                       "lm-prefill flash vs xla")
    log(f"[lm-prefill] batch {LM_PREFILL_BATCH} x seq {LM_PREFILL_SEQ}: "
        f"flash {t_flash:.3f} s ({tokens / t_flash:.1f} tokens/s, "
        f"{launches} flash launches), xla (chunked) {t_xla:.3f} s "
        f"({tokens / t_xla:.1f} tokens/s); last-position logits: {text}")
    del flash, xla
    free_cuda()
    step = make_prefill_step(cfg, impl="flash")
    log("[lm-prefill] one flash prefill, where the time goes: "
        + profile_text(*device_profile(lambda: step(model, batch))))
    return model, launches, t_flash


def phase_lm_serve(model, gen):
    """Phase 8: the serve driver on the full model, xla then kde."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    from repro_torch.launch import serve
    from repro_torch.train.train_step import (make_decode_step,
                                              make_prefill_step)
    cfg = model.cfg
    args = {a: serve.parser().parse_args(LM_SERVE_ARGS + ["--attention", a])
            for a in ("xla", "kde")}
    b, plen = args["xla"].batch, args["xla"].prompt_len
    batch = make_batch(cfg, ShapeConfig("serve", plen, b, "prefill"), 0,
                       args["xla"].seed)
    want = make_prefill_step(cfg, impl="flash")(model, batch)[:, 0]
    res = {"xla": serve.run_lm(args["xla"], model=model)}
    text = logit_check(res["xla"]["prompt_logits"], want, cfg.vocab_size,
                       "lm-serve xla last prompt step vs flash prefill")
    log(f"[lm-serve] xla: last-prompt-step logits vs the flash prefill of "
        f"the same prompts: {text}")
    del res["xla"]["cache"], want
    free_cuda()
    kk.reset_launches()
    res["kde"] = serve.run_lm(args["kde"], model=model)
    launches = kk.LAUNCHES["kde_decode"]
    steps = plen + args["kde"].gen - 1
    assert launches == cfg.num_layers * steps, (launches, steps)
    assert kk.LAUNCHES["block_lse"] == 0, kk.LAUNCHES
    assert res["kde"]["max_len"] == 544, res["kde"]["max_len"]
    kcfg = dict(top_p=args["kde"].kde_top_p, bk=args["kde"].kde_bk,
                stride=args["kde"].kde_stride, kv_valid=steps)
    for layer in LM_KDE_LAYERS:
        ck = res["kde"]["cache"]["k"][layer]
        cv = res["kde"]["cache"]["v"][layer]
        q = torch.randn((b, cfg.num_heads, cfg.hd), generator=gen,
                        device=ck.device)
        e = close(kops.kde_attention(q, ck, cv, **kcfg),
                  kops.kde_attention_ref(q, ck, cv, **kcfg),
                  f"kde_attention layer {layer} final cache")
        log(f"[lm-serve] kde final cache layer {layer}: kde_attention "
            f"kernel path vs plain pipeline max_abs_err {e:.3e}")
    v = cfg.vocab_size
    a = res["xla"]["prompt_logits"][:, :v].double().cpu().numpy()
    k = res["kde"]["prompt_logits"][:, :v].double().cpu().numpy()
    corr = float(np.mean([np.corrcoef(x1, x2)[0, 1] for x1, x2 in zip(a, k)]))
    agree = float((res["xla"]["tokens"] == res["kde"]["tokens"]).mean())
    for name, r in res.items():
        log(f"[lm-serve] {name}: batch {b}, prompt {plen}, gen "
            f"{args[name].gen}, cache {r['max_len']}: prefill (teacher-"
            f"forced replay) {r['prefill_s']:.3f} s, decode "
            f"{r['decode_s']:.3f} s ({args[name].gen * b / r['decode_s']:.1f}"
            f" tok/s)")
    log(f"[lm-serve] kde: {launches} kde_decode launches = {cfg.num_layers} "
        f"layers x {steps} steps; first generated step's logits, Pearson "
        f"correlation kde vs xla {corr:.6f} (reported, not gated); "
        f"generated tokens equal to xla's: {agree:.3f}")
    # where a decode step's time goes: 8 steps past the run's last
    # position on its cache (544 slots), each attention once
    cache = res["kde"]["cache"]
    cur = torch.as_tensor(res["kde"]["tokens"][:, -1:],
                          device=cache["k"].device)
    step = {name: make_decode_step(cfg, impl=name, kde_cfg=dict(
        top_p=args["kde"].kde_top_p, bk=args["kde"].kde_bk,
        stride=args["kde"].kde_stride)) for name in ("xla", "kde")}

    def steps8(name):
        for pos in range(steps, steps + 8):
            step[name](model, cache, cur, pos)

    walls = {}
    for name in ("xla", "kde"):
        prof = device_profile(lambda: steps8(name))
        walls[name] = [prof[0] / 8]
        log(f"[lm-serve] 8 {name} decode steps (batch {b}, cache 544), "
            f"where the time goes: " + profile_text(*prof))
    # host-bound walls spread with the machine: two more rounds in turns
    for name in ("kde", "xla", "xla", "kde"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps8(name)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / 8)
    mean = {n: sum(w) / len(w) for n, w in walls.items()}
    log(f"[lm-serve] decode step wall over 3 rounds of 8 steps (xla, kde, "
        f"kde, xla, xla, kde): kde {mean['kde'] * 1e3:.2f} ms "
        f"{[round(w * 1e3, 2) for w in walls['kde']]}, xla "
        f"{mean['xla'] * 1e3:.2f} ms {[round(w * 1e3, 2) for w in walls['xla']]}"
        f" (kde / xla {mean['kde'] / mean['xla']:.3f})")
    del res, cache
    free_cuda()
    return launches


def phase_hash(data):
    """Phase 6's counted run: the hashed-KDE sparsifier."""
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    t = 10 * HS_N
    t0 = time.perf_counter()
    g = spectral_sparsify(data["hs_x_np"], gaussian(HS_BW), num_edges=t,
                          estimator="hash", seed=0, batch=BATCH,
                          device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[hash] n={HS_N} d={HS_D} t={t}: {secs:.2f} s, "
        f"{t / secs:.0f} edges/s, kernel_evals={g.kernel_evals}, "
        f"kde_queries={g.kde_queries}, status={g.status}")
    return g, secs


def block_pits(x, bn, src, dst, bw, gen, chunk=8192):
    """(2, t) randomized probability integral transforms of each
    destination v under k(u, .) restricted to v's level-1 block, v != u,
    in float64: F(v-) + r k(u, v) in index order and the mass below
    k(u, v) plus r times its ties in value order, each over the block's
    mass.  Uniform on [0, 1) exactly when the in-block draw follows the
    kernel row; a block whose row underflows to 0 is drawn uniformly over
    its live columns, as the sampler does."""
    import torch
    n, dev = x.shape[0], x.device
    t = src.numel()
    xd = x.double()
    ar = torch.arange(bn, device=dev)
    pit = torch.empty((2, t), dtype=torch.float64, device=dev)
    for lo in range(0, t, chunk):
        u, v = src[lo:lo + chunk], dst[lo:lo + chunk]
        rows = torch.arange(u.numel(), device=dev)
        base = v // bn * bn
        cols = base[:, None] + ar
        live = (cols < n) & (cols != u[:, None])
        kv = torch.exp(-((xd[u][:, None, :] - xd[cols.clamp(max=n - 1)])
                         ** 2).sum(-1) / bw ** 2)
        kv = torch.where(live, kv, 0.0)
        kv = torch.where((kv.sum(1) > 0)[:, None], kv, live.double())
        j = v - base
        kuv = kv[rows, j]
        tot = kv.sum(1)
        r = torch.rand((2, u.numel()), generator=gen, device=dev,
                       dtype=torch.float64)
        below_idx = torch.cumsum(kv, dim=1)[rows, j] - kuv
        below_val = torch.where(kv < kuv[:, None], kv, 0.0).sum(1)
        ties = torch.where(kv == kuv[:, None], kv, 0.0).sum(1)
        pit[0, lo:lo + chunk] = (below_idx + r[0] * kuv) / tot
        pit[1, lo:lo + chunk] = (below_val + r[1] * ties) / tot
    return pit


def hash_edge_law(x, bn, g, bw=HS_BW):
    """Chi-square checks (alpha 1e-3) of the hashed sparsifier's edges:
    sources per level-1 block against the hashed degrees ``g.degrees`` the
    run drew them from, and each destination's in-block PIT (index order,
    value order) against the uniform.  The block a destination was drawn
    from follows the row's hashed block estimates, which the run does not
    keep: that draw is held against the reference on the CPU only
    (tests/test_torch_hash_pipeline.py, shared noise)."""
    import torch
    n, dev = x.shape[0], x.device
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    t = src.numel()
    nb = -(-n // bn)
    deg = torch.as_tensor(g.degrees, dtype=torch.float64, device=dev)
    blk_mass = torch.zeros(nb, dtype=torch.float64, device=dev)
    blk_mass.index_add_(0, torch.arange(n, device=dev) // bn, deg)
    got = torch.bincount(src // bn, minlength=nb).double()
    texts = [chi2_test(got, t * blk_mass / blk_mass.sum(), "sources")]
    gen = torch.Generator(device=dev).manual_seed(1)
    pit = block_pits(x, bn, src, dst, bw, gen)
    for row, what in zip(pit, ("destinations, index order",
                               "destinations, value order")):
        got = torch.histc(row, bins=PIT_BINS, min=0.0, max=1.0).double()
        texts.append(chi2_test(got, torch.full_like(got, t / PIT_BINS),
                               what))
    return "; ".join(texts)


def spectral_error(lap_g, lap, probes: int = 24, seed: int = 1) -> float:
    """The reference bench's spectral error (benchmarks/bench_kde.py):
    max |v^T L_G v / v^T L v - 1| over centred Gaussian probes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((lap.shape[0], probes))
    v -= v.mean(0)
    ratios = np.einsum("ij,ij->j", v, lap_g @ v) / \
        np.einsum("ij,ij->j", v, lap @ v)
    return float(np.abs(ratios - 1.0).max())


def hash_checks(data, g):
    """Checks 1-5 of the hash phase, off the counted run."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_hash.ref import lookup_buckets
    from repro_torch.kernels.kde_rowsum import kernel as rk
    x, bn, n = data["hs_x"], data["hs_bs"], HS_N
    state, cw = data["hs_state"], data["hs_cw"]
    # (1) device hashing parity with the host build, all n rows
    b, hit = lookup_buckets(x, state, cw)
    assert bool(hit.all()), f"{int((~hit).sum())} rows miss their bucket"
    assert bool((b == state.point_bucket).all()), "bucket ids differ"
    log(f"[hash] (1) device hashing reproduces point_bucket for all {n} "
        f"rows: {state.keys.numel()} buckets, "
        f"{int(state.truncated.sum())} truncated at {HS_MAX_BUCKET}")
    # (2) the hashed degrees the run drew its sources from, against the
    # exact degrees
    deg = g.degrees
    exact = torch.cat([
        rk.blocksum_cuda(x[lo:lo + BATCH].contiguous(), x, "gaussian",
                         1.0 / HS_BW, 1.0, bn).double().sum(1)
        for lo in range(0, n, BATCH)]).cpu().numpy() - 1.0
    rel = abs(deg.sum() - exact.sum()) / exact.sum()
    per_row = np.abs(deg - exact) / exact
    log(f"[hash] (2) sum deg_hash {deg.sum():.6e} vs exact "
        f"{exact.sum():.6e}: rel err {rel:.3e} (bound {HS_DEG_RTOL}); "
        f"per-row rel err median {np.median(per_row):.3e}, "
        f"p99 {np.quantile(per_row, 0.99):.3e}")
    assert rel <= HS_DEG_RTOL, rel
    # (3) status and the reference's counter formulas
    t = 10 * n
    drawn = -(-t // BATCH) * BATCH
    nb = -(-n // bn)
    near = int(state.counts[state.point_bucket].sum())
    want = (near + n * HS_NUM_FAR
            + drawn * (HS_MAX_BUCKET + nb * HS_FAR_PER_BLOCK + bn + 1))
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.kernel_evals == want, (g.kernel_evals, want)
    assert g.kde_queries == n + drawn, g.kde_queries
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    log(f"[hash] (3) status {guards.decode_status(g.status)} (no fatal "
        f"flag); kernel_evals {g.kernel_evals} = NEAR {near} + n*{HS_NUM_FAR}"
        f" + drawn*({HS_MAX_BUCKET} + {nb}*{HS_FAR_PER_BLOCK} + {bn} + 1); "
        f"kde_queries {g.kde_queries} = n + drawn")
    # (4) the edge law
    log(f"[hash] (4) edge law of the {g.num_edges} drawn edges: "
        f"{hash_edge_law(x, bn, g)} (alpha 1e-3)")
    # (5) spectral error at the reference bench's spectral config
    xs = np.random.default_rng(0).normal(
        0, SPEC_SIGMA, (SPEC_N, SPEC_D)).astype(np.float32)
    gs = spectral_sparsify(xs, gaussian(SPEC_BW), num_edges=16 * SPEC_N,
                           estimator="hash", seed=0, batch=BATCH,
                           device="cuda")
    xd = torch.as_tensor(xs, device="cuda").double()
    k = torch.exp(-torch.cdist(xd, xd) ** 2 / SPEC_BW ** 2)
    k.fill_diagonal_(0.0)
    lap = (torch.diag(k.sum(1)) - k).cpu().numpy()
    err = spectral_error(gs.laplacian_dense(), lap)
    log(f"[hash] (5) spectral error n={SPEC_N} d={SPEC_D} t={16 * SPEC_N}: "
        f"{err:.6f} (bound {SPEC_BOUND:.6f})")
    assert err <= SPEC_BOUND, err


def hash_breakdown(data):
    """CUDA-event ms of the stages of one hashed edge batch (m = 1024
    frontier rows) on the hash phase's layout: the frontier gather (its
    (m, B far_per_block, max_bucket) collision mask alone too), the
    weighted-kv kernel, the block-sum scatter, and a whole fused edge
    batch."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    from repro_torch.kernels.kde_sampler import ops as sops
    from repro_torch.kernels.kde_sampler.ref import block_views
    x, state, bn = data["hs_x"], data["hs_state"], data["hs_bs"]
    n = x.shape[0]
    nb = -(-n // bn)
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(5)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    off = hops.draw_frontier_noise(BATCH, nb, HS_FAR_PER_BLOCK, bn, gen, dev)
    fidx = (torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
            * bn + off).reshape(BATCH, -1)
    b = state.point_bucket[src]
    mem = state.members[b]
    mvalid = (torch.arange(mem.shape[1], device=dev)[None, :]
              < state.counts[b][:, None])
    cols, wgt, _, _ = href.frontier_gather(src, state, off,
                                           HS_FAR_PER_BLOCK, bn, nb, n)
    kv = hk.weighted_kv_cuda(x[src], x, cols, wgt, "gaussian", 1.0 / HS_BW)
    cdf = torch.linspace(0, 1, n + 1, device=dev)[1:]
    degs = torch.ones(n, device=dev)
    x_sq = torch.sum(x * x, -1)
    views = block_views(x, x_sq, bn)
    noise = sops.draw_edge_noise(BATCH, nb, gen, dev, level1="hash",
                                 num_far=HS_FAR_PER_BLOCK, block_size=bn)
    cfg = dict(kind="gaussian", inv_bw=1.0 / HS_BW, beta=1.0, block_size=bn,
               num_blocks=nb, n=n, level1="hash", num_far=HS_FAR_PER_BLOCK)
    stages = {
        "frontier_gather": lambda: href.frontier_gather(
            src, state, off, HS_FAR_PER_BLOCK, bn, nb, n),
        "far_collide mask": lambda: href._far_collide(fidx, mem, mvalid),
        "weighted_kv kernel": lambda: hk.weighted_kv_cuda(
            x[src], x, cols, wgt, "gaussian", 1.0 / HS_BW),
        "scatter_block_sums": lambda: href.scatter_block_sums(
            kv, cols, src, state, HS_FAR_PER_BLOCK, bn, nb),
        "fused edge batch": lambda: sops.fused_edge_batch(
            x, x_sq, cdf, degs, 1.0 / n, 1.0 / n, *noise, views=views,
            hstate=state, **cfg),
    }
    return {k: timed(fn, 20) for k, fn in stages.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    os.environ["REPRO_CHECKS"] = "1"      # fatal status flags raise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.core.kernels_fn import median_bandwidth
    from repro_torch.data.synthetic_points import (gaussian_clusters,
                                                   mnist_like)
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    phases = {}
    t0 = time.perf_counter()
    phase_build()
    phases["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sp_x_np, _ = gaussian_clusters(n=SP_N, d=SP_D, seed=0)
    lra_x_np = mnist_like(n=LRA_N, d=LRA_D, seed=0)
    lra_x = torch.as_tensor(lra_x_np, device=dev)
    lra_bw = median_bandwidth(lra_x, ord=1)
    rng = np.random.default_rng(0)
    hs_x_np, _ = gaussian_clusters(n=HS_N, d=HS_D, seed=0)
    hs_x = torch.as_tensor(hs_x_np, device=dev)
    hs_state, hs_cw = hash_layout(hs_x)
    data = dict(
        hs_x_np=hs_x_np, hs_x=hs_x, hs_state=hs_state, hs_cw=hs_cw,
        hs_bs=max(int(np.sqrt(HS_N)), 16),
        sp_x_np=sp_x_np, sp_x=torch.as_tensor(sp_x_np, device=dev),
        sp_bs=max(int(np.sqrt(SP_N)), 16),
        ns_src=torch.as_tensor(rng.choice(SP_N, NS_FRONTIER, replace=False),
                               device=dev),
        lra_x_np=lra_x_np, lra_x=lra_x, lra_bw=lra_bw,
        lra_xs=(lra_x * 2.0).contiguous())   # laplacian squaring constant
    log(f"[setup] data made; laplacian median bandwidth {lra_bw:.4f}")
    rows = phase_kernels(data, gen) + phase_hash_kernels(data, gen) + \
        phase_lm_kernels(gen)
    phases["kernels"] = time.perf_counter() - t0

    rk.reset_launches()
    sk.reset_launches()
    g, phases["sparsify"] = phase_sparsify(data)
    phases["sampler"] = phase_sampler(data)
    res, phases["lra"] = phase_lra(data)
    launches = {**rk.LAUNCHES, **sk.LAUNCHES}
    log(f"[main path] launches {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"

    rk.reset_launches()
    sk.reset_launches()
    hk.reset_launches()
    g_hash, phases["hash"] = phase_hash(data)
    hash_launches = dict(hk.LAUNCHES)
    log(f"[hash path] launches {hash_launches}")
    want = {"weighted_kv_sum": HS_N // BATCH,
            "weighted_kv": -(-10 * HS_N // BATCH)}
    assert hash_launches == want, (hash_launches, want)
    launches.update(hash_launches)

    t0 = time.perf_counter()
    deg = exact_degrees(data["sp_x"], 1.0 / SP_BW)
    log(f"[sparsify] edge law of the {g.num_edges} drawn edges: "
        f"{edge_law(data, g, deg)} (alpha 1e-3)")
    half = float(deg.sum()) / 2.0
    wsum = float(g.weight.sum())
    rel = abs(wsum - half) / half
    log(f"[sparsify] sums consistent: sum(w) = {wsum:.6e}, total kernel "
        f"mass / 2 = {half:.6e}, rel err {rel:.2e} (bound {MASS_RTOL})")
    assert rel <= MASS_RTOL, rel
    e_fkv, e_svd = lra_errors(data, res)
    log(f"[lra] n={LRA_N} d={LRA_D} rank {LRA_RANK}: relative Frobenius "
        f"error FKV {e_fkv:.6e}, subspace iteration {e_svd:.6e} (bound "
        f"{LRA_FACTOR}x); fkv_lowrank {phases['lra']:.2f} s")
    assert e_fkv <= LRA_FACTOR * e_svd, (e_fkv, e_svd)
    phases["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hash_checks(data, g_hash)
    phases["hash checks"] = time.perf_counter() - t0
    log("[hash] one edge batch, ms by stage (CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in hash_breakdown(data).items()))
    del data, g, g_hash, res, deg
    free_cuda()

    # the LM phases run in IEEE f32: no TF32 in any matmul
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    t0 = time.perf_counter()
    model, launches["flash_attention"], _ = phase_lm_prefill()
    phases["lm-prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["kde_decode"] = phase_lm_serve(model, gen)
    phases["lm-serve"] = time.perf_counter() - t0
    del model
    free_cuda()

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("[phases] " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()))
    log(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("device_ms", "host_us") if k in r}
        for r in rows]}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
