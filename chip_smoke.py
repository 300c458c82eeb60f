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
               (``torch.cdist`` + elementwise + sum) with CUDA events.
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
7. report   -- a ``{"kernels": [...]}`` line, the card line from
               nvidia-smi, and a last line ``{"ok": true, "device": ...}``.

Launch counters are set to 0 just before phase 3 and read just after
phase 5, and set to 0 again just before phase 6 and read just after its
sparsifier returns, so the comparisons and timings of phase 2 and the
checks do not count.  Each kernel's ``launches`` is its count from the
run of its own path.

``bound_ms`` is the least time the card could take for a kernel's work at
its main-path shape: the larger of (bytes of every input read once and
every output written once) / 3.35 TB/s and (FP32 operations) / 67 TFLOP/s
(H100 SXM data sheet, non-tensor f32).  Operations are counted per
(query, dataset row) pair: 2d + 6 for the L2 kinds (d FMAs of the cross
term, the distance assembly, the scale, exp and the accumulate) and
3d + 3 for the laplacian (subtract, |.|, add per coordinate; scale, exp,
accumulate); the kde_hash kernels add one multiply by the weight per
pair and read each distinct gathered row of x once (x is 16 MB and stays
in the 50 MB L2).
"""
from __future__ import annotations

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


def close(got, want, what: str, atol: float = ATOL) -> float:
    """Assert |got - want| <= atol + RTOL |want| everywhere; return the
    max abs error."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > atol + RTOL * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} values outside rtol {RTOL} / atol "
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

    # ragged shapes, every kind
    for kind, d in [("gaussian", 19), ("exponential", 19),
                    ("rational_quadratic", 19), ("laplacian", 19),
                    ("laplacian", 784)]:
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
        plain_ms=timed(lambda: rk.blocksum_plain(q, x, "gaussian", inv, 1.0,
                                                 bn), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: cdist_blocks(q), 5)))

    src = data["ns_src"]
    q = x[src].contiguous()
    own = (src // bn).to(torch.int32)
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
        plain_ms=timed(lambda: sk.masked_blocksum_plain(
            q, x, own, "gaussian", inv, 1.0, bn), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=timed(cdist_masked, 3)))

    src = src[:BATCH]
    q = x[src].contiguous()
    own = (src // bn).to(torch.int32)
    m = q.shape[0]
    g = gumbel((m, nb), gen, dev)
    got = sk.sample_block_cuda(q, x, own, g, "gaussian", inv, 1.0, bn)
    want = sk.sample_block_plain(q, x, own, g, "gaussian", inv, 1.0, bn)
    check_blk(got[0], want[3], g, "sample_block main")
    pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
    errs["sample_block"] = max(errs["sample_block"],
                               close(got[3], want[3], "sample_block main"),
                               close(got[2], want[2], "sample_block tot main"),
                               close(got[1], pb, "sample_block p main"))
    b_ms, b_by = bound(m * n * pair_ops("gaussian", d) + 3 * m * nb,
                       4 * (m * d + n * d + m + 2 * m * nb + 3 * m))
    rows.append(dict(
        name="sample_block", route="cuda",
        source="src/repro_torch/csrc/kde_sampler.cu",
        replaces="src/repro/kernels/kde_sampler/kernel.py:129",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: sk.sample_block_cuda(q, x, own, g, "gaussian", inv,
                                              1.0, bn), 20),
        plain_ms=timed(lambda: sk.sample_block_plain(
            q, x, own, g, "gaussian", inv, 1.0, bn), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


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

    for kind, d in [("gaussian", 19), ("exponential", 19),
                    ("rational_quadratic", 19), ("laplacian", 19),
                    ("laplacian", 784)]:
        m, t, n = 37, 45, 301
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        x = torch.randn(n, d, generator=gen, device=dev) * 0.3
        cols = torch.randint(0, n + 2, (m, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((m, t), generator=gen, device=dev) * 256.0
        inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else \
            1.0 / (0.4 * d ** 0.5)
        check(q, x, cols, wgt, kind, inv_bw, 0.7, f"{kind} d={d} ragged")
        log(f"[kernels] ragged m={m} t={t} d={d} {kind}: ok")

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
            plain_ms=timed(lambda: plain(*args), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


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
    rows = phase_kernels(data, gen) + phase_hash_kernels(data, gen)
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

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("[phases] " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()))
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
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
