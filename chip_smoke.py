#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and continues):

1. build    -- compile the CUDA kernels from ``src/repro_torch/csrc`` with
               nvcc (one process per source, started together) and print
               the build seconds and ptxas register / spill lines.
2. kernels  -- every kernel against its plain PyTorch version on the card:
               all four kernel kinds on ragged shapes (m=37, n=301, d=19,
               bn=70; laplacian also at d=784) and each kernel at its
               main-path shape; floats within rtol 2e-4 / atol 1e-5 (the
               reference's own kernel tolerance), drawn blocks equal except
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
6. report   -- a ``{"kernels": [...]}`` line, the card line from
               nvidia-smi, and a last line ``{"ok": true, "device": ...}``.

Launch counters are set to 0 just before phase 3 and read just after
phase 5, so the comparisons and timings of phase 2 do not count.

``bound_ms`` is the least time the card could take for a kernel's work at
its main-path shape: the larger of (bytes of every input read once and
every output written once) / 3.35 TB/s and (FP32 operations) / 67 TFLOP/s
(H100 SXM data sheet, non-tensor f32).  Operations are counted per
(query, dataset row) pair: 2d + 6 for the L2 kinds (d FMAs of the cross
term, the distance assembly, the scale, exp and the accumulate) and
3d + 3 for the laplacian (subtract, |.|, add per coordinate; scale, exp,
accumulate).
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


def close(got, want, what: str) -> float:
    """Assert |got - want| <= ATOL + RTOL |want| everywhere; return the
    max abs error."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} values outside rtol {RTOL} / atol {ATOL}"
        f" (max abs err {float(err.max()):.3e})")
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
    data = dict(
        sp_x_np=sp_x_np, sp_x=torch.as_tensor(sp_x_np, device=dev),
        sp_bs=max(int(np.sqrt(SP_N)), 16),
        ns_src=torch.as_tensor(rng.choice(SP_N, NS_FRONTIER, replace=False),
                               device=dev),
        lra_x_np=lra_x_np, lra_x=lra_x, lra_bw=lra_bw,
        lra_xs=(lra_x * 2.0).contiguous())   # laplacian squaring constant
    log(f"[setup] data made; laplacian median bandwidth {lra_bw:.4f}")
    rows = phase_kernels(data, gen)
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
