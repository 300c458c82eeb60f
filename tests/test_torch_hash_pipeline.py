"""The port's hashed-KDE path as a whole -- ``spectral_sparsify(estimator=
"hash")`` and ``NeighborSampler(level1="hash")`` -- against the JAX
reference on the CPU (the reference's jnp path), plus the edge-law check
``chip_smoke.py`` applies to the card's run and the port's import rule.

The NEAR counts depend only on the bucket layout, which both sides build
bit for bit, so the eval counters must match exactly.  One edge batch fed
the reference's own noise must draw the same edges.
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sparsify import spectral_sparsify as jsparsify
from repro.kernels.kde_hash import ops as jhops
from repro.kernels.kde_sampler import ops as jops
from repro_torch.convert import hash_state_from_reference
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling.edge import NeighborSampler
from repro_torch.core.sampling.vertex import approximate_degrees
from repro_torch.core.sparsify import spectral_sparsify
from repro_torch.ft import guards as tg
from repro_torch.kernels.kde_sampler import ops as tops

ROOT = Path(__file__).resolve().parents[1]
N, BW, BATCH = 2048, 1.0, 1024
T = 10 * N


def _points(label, n=N):
    """Negative coordinates, and a density that falls with the row index
    (so level-1 blocks carry unequal degree mass)."""
    rng = np.random.default_rng(stats.derive_seed("torch_hash_pipeline",
                                                  label))
    scale = 0.4 + np.arange(n)[:, None] / n
    return (rng.normal(-0.3, 0.5, (n, 8)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def sparsified():
    """One hashed sparsifier run on each side over the same points."""
    x = _points("sp")
    ref = jsparsify(x, jgaussian(BW), num_edges=T, estimator="hash", seed=0,
                    batch=BATCH)
    port = spectral_sparsify(x, gaussian(BW), num_edges=T, estimator="hash",
                             seed=0, batch=BATCH, device="cpu")
    return x, ref, port


def test_hash_sparsify_counters_match_reference(sparsified):
    """``kernel_evals`` and ``kde_queries`` equal the reference's exactly,
    and the reference's formula: the degree queries' realized NEAR reads
    and FAR samples (``est.evals``, no longer dropped) plus, per drawn
    edge, one hashed level-1 read, one exact level-2 row and one pair."""
    x, ref, port = sparsified
    assert port.kernel_evals == ref.kernel_evals
    assert port.kde_queries == ref.kde_queries == N + 20 * BATCH
    nbr = NeighborSampler(x, gaussian(BW), level1="hash", seed=2,
                          device="cpu")
    st = nbr.hash_estimator.state
    near = int(st.counts[st.point_bucket].sum())
    bs = max(int(np.sqrt(N)), 16)
    nb = -(-N // bs)
    drawn = 20 * BATCH
    assert port.kernel_evals == (near + N * 64
                                 + drawn * (128 + nb * 2 + bs + 1))
    assert not port.status & tg.FATAL
    assert port.status & tg.BUCKET_OVERFLOW


def test_hash_edge_batch_matches_reference():
    """One hashed edge batch fed the reference's noise (``k_u, k_fwd``;
    ``k_l1, k_rest``; ``k_blk, k_in`` -- the reference's split order):
    u and v identical, weights and probabilities at rtol 1e-4, counter
    words equal."""
    x = _points("batch", n=700)
    n, bs, nf, batch = 700, 26, 2, 96
    nb = -(-n // bs)
    jk = jgaussian(BW)
    jstate, _ = jhops.build_hash_state(x, jk, max_bucket=32, seed=11)
    tstate = hash_state_from_reference(jstate, device="cpu")
    deg = np.random.default_rng(0).uniform(1.0, 3.0, n)
    prefix = np.cumsum(deg)
    cdf = (prefix / prefix[-1]).astype(np.float32)
    degs = deg.astype(np.float32)
    key = jax.random.PRNGKey(stats.derive_seed("torch_hash_pipeline", "eb"))
    xj = jnp.asarray(x)
    cfg = dict(kind="gaussian", inv_bw=1.0 / BW, beta=1.0, block_size=bs,
               num_blocks=nb, n=n, level1="hash", num_far=nf)
    *want, rword = jops.fused_edge_batch(
        xj, jnp.sum(xj * xj, -1), jnp.asarray(cdf), jnp.asarray(degs),
        1.0 / prefix[-1], 1e-3, key, jstate, batch=batch, pairwise=None,
        s=16, exact=False, use_pallas=False, interpret=False, bm=32, **cfg)
    k_u, k_fwd = jax.random.split(key)
    k_l1, k_rest = jax.random.split(k_fwd)
    k_blk, k_in = jax.random.split(k_rest)
    noise = [torch.as_tensor(np.array(a)) for a in (
        jax.random.uniform(k_u, (batch,)),
        jax.random.randint(k_l1, (batch, nb, nf), 0, bs),
        jax.random.uniform(k_blk, (batch,)),
        jax.random.uniform(k_in, (batch,)))]
    noise[1] = noise[1].long()
    tx = torch.as_tensor(x)
    *got, word = tops.fused_edge_batch(
        tx, (tx * tx).sum(-1), torch.as_tensor(cdf), torch.as_tensor(degs),
        1.0 / prefix[-1], 1e-3, *noise, hstate=tstate, s=16, exact=False,
        **cfg)
    for name, a, b in zip(("u", "v"), got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    np.testing.assert_array_equal(word.numpy(),
                                  np.asarray(rword).astype(np.int64))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hash_edge_law_rejects_wrong_draws(sparsified):
    """The hash phase's edge-law check, here on the CPU run: the degrees
    the run drew its sources from (``SparseGraph.degrees``) are the
    sampler's hashed degrees -- those a fresh sampler of the same seed
    computes, at rtol 2e-4 (the CPU's plain sums may round differently
    from one allocation to the next; the card's kernel sums in a fixed
    order); the check passes the true draws and fails a source law that
    ignores the degrees, an off-by-one in-block draw (index order) and an
    in-block draw from k(u, .)^0.8 (value order)."""
    cs = _chip_smoke()
    x, _, g = sparsified
    tx, bn = torch.as_tensor(x), max(int(np.sqrt(N)), 16)
    np.testing.assert_allclose(g.degrees, approximate_degrees(
        NeighborSampler(tx, gaussian(BW), level1="hash", seed=2,
                        device="cpu").hash_estimator), rtol=2e-4)
    cs.hash_edge_law(tx, bn, g, BW)

    rng = np.random.default_rng(0)
    uniform_src = dataclasses.replace(g, src=rng.integers(0, N, T))
    with pytest.raises(AssertionError, match="sources"):
        cs.hash_edge_law(tx, bn, uniform_src, BW)

    off_by_one = dataclasses.replace(
        g, dst=np.where(g.dst % bn > 0, g.dst - 1, g.dst))
    with pytest.raises(AssertionError, match="index order"):
        cs.hash_edge_law(tx, bn, off_by_one, BW)

    u, v = torch.as_tensor(g.src), torch.as_tensor(g.dst)
    cols = (v // bn * bn)[:, None] + torch.arange(bn)
    live = (cols < N) & (cols != u[:, None])
    cols = cols.clamp(max=N - 1)
    kv = torch.exp(-((tx[u][:, None, :] - tx[cols]) ** 2).sum(-1) / BW ** 2)
    kv = torch.where(live, kv ** 0.8, 0.0)
    pick = torch.multinomial(kv, 1, generator=torch.Generator().manual_seed(
        0))[:, 0]
    flat = dataclasses.replace(g, dst=cols[torch.arange(T), pick].numpy())
    with pytest.raises(AssertionError, match="value order"):
        cs.hash_edge_law(tx, bn, flat, BW)


def test_hash_sampler_prob_of_reproduces_sample():
    """``NeighborSampler(level1="hash")``: ``prob_of`` on the frontier
    ``sample`` drew from reuses the cached hashed level-1 sums and returns
    the realized probabilities to 1e-6 relative; a second ``sample`` on
    the same frontier draws from the cache; evals count the hashed read
    once."""
    x = _points("nbr", n=900)
    nbr = NeighborSampler(x, gaussian(BW), level1="hash", seed=5,
                          device="cpu")
    src = np.random.default_rng(3).integers(0, 900, 300)
    v, p = nbr.sample(src)
    np.testing.assert_allclose(nbr.prob_of(src, v), p, rtol=1e-6)
    v2, p2 = nbr.sample(src)
    np.testing.assert_allclose(nbr.prob_of(src, v2), p2, rtol=1e-6)
    assert np.all(v != src) and np.all(p > 0)
    bs, nb = nbr.block_size, nbr.num_blocks
    assert nbr.evals == 300 * (128 + nb * 2) + 4 * 300 * bs
    assert nbr.device_counters["evals"] == nbr.evals
    assert nbr.device_counters["far_samples"] == 300 * nb * 2


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    """No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` (or ``jaxlib``) or anything of the reference package
    ``repro``, at any depth of the module (function-level imports
    included)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
