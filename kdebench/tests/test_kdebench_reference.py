"""The reference's arithmetic against brute force at tiny sizes: degrees,
sums of k^2 and k^3, the graph numbers and their laws, row norms, the sketch's factor, TF32 rounding, the chi-square z
scores and the work counts the roofline takes."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import kdebench_testing  # noqa: F401  (the import path)
from kdebench import roofline
from kdebench.reference import lra, precision, sparsify


def _points(n, d, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g) * scale


@pytest.mark.parametrize("n,d,bw", [(37, 3, 0.7), (130, 16, 1.0),
                                    (64, 5, 2.5)])
def test_sweep_against_the_dense_kernel_matrix(n, d, bw):
    x = _points(n, d)
    xn = x.double().numpy()
    d2 = ((xn[:, None, :] - xn[None, :, :]) ** 2).sum(-1)
    k = np.exp(-d2 / bw ** 2)
    np.fill_diagonal(k, 0.0)
    sw = sparsify.sweep(x, 1.0 / bw ** 2, block=16)
    np.testing.assert_allclose(sw["deg"].numpy(), k.sum(1), rtol=1e-12)
    np.testing.assert_allclose(sw["ksq"].numpy(), (k * k).sum(1),
                               rtol=1e-12)
    np.testing.assert_allclose(sw["kcube"].numpy(), (k ** 3).sum(1),
                               rtol=1e-12)
    bins = np.arange(n) * sparsify.BINS // n
    want = np.zeros((n, sparsify.BINS))
    np.add.at(want.T, bins, k.T)
    np.testing.assert_allclose(sw["bin"].numpy(), want, rtol=1e-12,
                               atol=1e-300)
    tf = sparsify.sweep(x, 1.0 / bw ** 2, tf32=True, block=16)
    assert float((tf["deg"] - sw["deg"]).abs().max()) > 0


def test_graph_numbers_on_an_exact_graph_and_a_broken_one():
    """A graph drawn by the exact law reads small; the same graph with one
    weight doubled, a self-loop, its sources all in the first bin, its
    neighbors uniform or its draws repeated does not."""
    x = _points(512, 4)
    inv = 1.0
    sw = sparsify.sweep(x, inv)
    t = 20000
    g = sparsify.control_graph(x, inv, t, seed=3, sw=sparsify.sweep(
        x, inv))       # f64-exact law up to TF32 rows: near the exact one
    res = sparsify.graph_numbers(x, sw, [g], t, inv)
    assert res["edge_gap"] == 0 and res["deg_rel"] == 0.0
    assert res["wgt_rel"] < 1e-4
    assert res["src_z"] < 6 and res["nbr_z"] < 5 and res["blk_z"] < 5
    assert 0.5 < res["dup_ratio"] < 1.5

    def broken(**kw):
        b = dict(g, **{k: g[k].copy() for k in ("src", "dst", "weight")})
        for key, fix in kw.items():
            fix(b[key])
        return sparsify.graph_numbers(x, sw, [b], t, inv)

    assert broken(weight=lambda w: w.__setitem__(7, 2 * w[7]))[
        "wgt_rel"] > 0.99
    loop = dict(g, dst=g["dst"].copy())
    loop["dst"][5] = g["src"][5]
    assert math.isnan(sparsify.graph_numbers(x, sw, [loop], t,
                                             inv)["wgt_rel"])
    assert broken(src=lambda s: s.fill(0))["src_z"] > 100
    rng = np.random.default_rng(1)
    uni = dict(g, dst=rng.integers(0, 512, t))
    uni["dst"] = np.where(uni["dst"] == g["src"], (uni["dst"] + 1) % 512,
                          uni["dst"])
    assert sparsify.graph_numbers(x, sw, [uni], t, inv)["nbr_z"] > 20
    assert sparsify.graph_numbers(x, sw, [uni], t, inv)["blk_z"] > 20
    rep = dict(g, src=np.tile(g["src"][:t // 2], 2),
               dst=np.tile(g["dst"][:t // 2], 2))
    assert sparsify.graph_numbers(x, sw, [rep], t, inv)["dup_ratio"] > 1.5


@pytest.mark.parametrize("key", ["nbr_z", "blk_z"])
def test_law_z_is_about_standard_normal_under_the_exact_law(key):
    """Edges drawn from P(u, v) = k(u, v) / sum(deg) directly, in float64:
    the z scores of their mean kernel value and bin share over 40
    graphs."""
    x = _points(300, 3, seed=5)
    inv = 0.5
    sw = sparsify.sweep(x, inv)
    k = sparsify.kernel_rows(x, torch.arange(300), inv).flatten()
    gen = torch.Generator().manual_seed(8)
    zs = []
    for _ in range(40):
        e = torch.multinomial(k, 5000, replacement=True, generator=gen)
        g = dict(src=(e // 300).numpy(), dst=(e % 300).numpy(),
                 weight=np.full(5000, float(sw["deg"].sum()) / 10000),
                 degrees=sw["deg"].numpy())
        zs.append(sparsify.graph_numbers(x, sw, [g], 5000, inv)[key])
    assert 0.4 < float(np.mean(zs)) < 1.2 and max(zs) < 4.5


@pytest.mark.parametrize("n,d,bw", [(40, 784, 150.0), (90, 20, 6.0)])
def test_row_norms_and_factor_against_dense(n, d, bw):
    x = torch.rand((n, d), generator=torch.Generator().manual_seed(2))
    xn = x.double().numpy()
    k = np.exp(-np.abs(xn[:, None, :] - xn[None, :, :]).sum(-1) / bw)
    norms = lra.row_norms(x, 1.0 / bw, block=7)
    np.testing.assert_allclose(norms.numpy(), (k * k).sum(1), rtol=1e-12)
    p = norms / norms.sum()
    idx = torch.arange(0, n, 3)
    sk = lra.sketch(x, idx, p, 1.0 / bw)
    want = k[idx.numpy()] / np.sqrt(len(idx) * p.numpy()[idx.numpy()])[:, None]
    np.testing.assert_allclose(sk.numpy(), want, rtol=1e-12)
    u = lra.factor(sk, 3)
    _, _, vt = np.linalg.svd(want, full_matrices=False)
    proj = u.numpy() @ vt[:3].T
    np.testing.assert_allclose(np.abs(np.linalg.det(proj)), 1.0, atol=1e-8)
    e, o = lra.call_numbers(x, p, idx.numpy(), u.numpy(), 1.0 / bw)
    assert e < 1e-12 and o < 1e-12
    bad = u.numpy().copy()
    bad[1] = bad[0]
    assert lra.call_numbers(x, p, idx.numpy(), bad, 1.0 / bw)[1] > 0.5


def test_rows_z_reads_the_law():
    p = torch.linspace(1.0, 3.0, 500, dtype=torch.float64)
    p = p / p.sum()
    g = torch.Generator().manual_seed(4)
    good = torch.multinomial(p, 20000, replacement=True, generator=g)
    flat = torch.randint(0, 500, (20000,), generator=g)
    assert abs(lra.rows_z(p, good)) < 6
    assert lra.rows_z(p, flat) > 50


def test_round_tf32_against_bit_arithmetic():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5e-3,
                      3.0 + 2 ** -10 + 2 ** -12, 0.0, 1e30],
                     dtype=torch.float32)
    got = precision.round_tf32(x)
    xn = x.numpy().view(np.uint32).astype(np.uint64)
    lsb = (xn >> 13) & 1
    want = ((xn + 0xFFF + lsb) & 0xFFFFE000).astype(np.uint32).view(
        np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == 1.0 and got[2] == 1.0 + 2 ** -9   # ties to even
    r = precision.round_tf32(_points(1000, 1).float())
    bits = r.numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()


def test_chi2_z():
    c = torch.tensor([10.0, 10.0, 10.0, 10.0])
    assert precision.chi2_z(c, c) == pytest.approx(-3 / math.sqrt(6))


@pytest.mark.parametrize("name", ["gauss262k_gaussian",
                                  "mnist70k_laplacian"])
def test_operation_counts_and_least_time(name):
    """Each configuration's operations a kernel evaluation are the kernel
    table's count at its width: 2d + 6 gaussian, 3d + 3 laplacian."""
    from kdebench_testing import BENCH
    import json
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    d, kind = conf["data"]["d"], conf["kernel"]["kind"]
    want = {"gaussian": 2 * d + 6, "laplacian": 3 * d + 3}[kind]
    assert conf["kernel"]["ops_per_eval"] == want
    evals = 70000 ** 2 + 500 * 70000
    assert roofline.least_seconds(evals, want, 1.0) == \
        pytest.approx(evals * want / 67e12)
    assert roofline.least_seconds(10, want, 3.35e12) == 1.0


def test_program_counts_the_work_the_roofline_takes():
    """The evaluations the sparsifier reports are n^2 + drawn (n + bs + 1),
    the count the kernel table uses; the LRA's n^2 + rows n."""
    from kdebench_testing import LRA, SPARSIFY, run_small
    r = run_small(SPARSIFY, trace=True, seconds=0.2)
    n, bs, batch = 2048, 45, 1024
    t = 16 * n
    drawn = -(-t // batch) * batch
    per_edge = (n * n + drawn * (n + bs + 1)) / t
    assert r["metrics"]["kernel_evals_per_edge"]["value"] == \
        pytest.approx(per_edge)
    r = run_small(LRA, trace=True, seconds=0.2)
    assert r["metrics"]["kernel_evals_per_lra"]["value"] == 600 ** 2 + \
        100 * 600
