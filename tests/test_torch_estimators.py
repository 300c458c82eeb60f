"""The port's remaining estimators (``GridHBE``, ``MultiLevelKDE`` with the
tree-mode neighbor sampler, ``RobustEstimator``) against the JAX
reference on the same numpy inputs.

``GridHBE`` and the tree descent draw from ``np.random.default_rng(seed)``
on both sides in the same order, so the same seed gives the same buckets,
FAR samples and branch draws: floats at rtol 1e-5, indices exactly except
where a uniform lies within 1e-5 of the split it is compared with.  The
robust chain's counters are functions of the layouts and the escalation
pattern, so they compare exactly; its values compare where its stages are
deterministic (a NEAR-only hash stage, the exact stage).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core.kde.base import ExactKDE as JExactKDE
from repro.core.kde.base import make_estimator as jmake_estimator
from repro.core.kde.hbe import GridHBE as JGridHBE
from repro.core.kde.multilevel import MultiLevelKDE as JMultiLevelKDE
from repro.core.kernels_fn import gaussian as jgaussian
from repro.core.sampling.edge import NeighborSampler as JNeighborSampler
from repro.core.sampling.edge import \
    shared_level1_estimator as jshared_level1_estimator
from repro.core.sampling import vertex as jvertex
from repro.ft import guards as jguards
from repro_torch.core import MultiLevelKDE
from repro_torch.core.kde.base import ExactKDE, make_estimator
from repro_torch.core.kde.hbe import GridHBE
from repro_torch.core.kernels_fn import gaussian
from repro_torch.core.sampling import vertex as tvertex
from repro_torch.core.sampling.edge import (NeighborSampler,
                                            shared_level1_estimator)
from repro_torch.ft import guards as tguards

RTOL = 1e-5


def _data(label, n=300, d=5, scale=0.8):
    rng = np.random.default_rng(stats.derive_seed("torch_estimators", label))
    return rng.normal(0.0, scale, (n, d)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------- #
# GridHBE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", [
    dict(),                                        # the defaults
    dict(max_bucket=4, num_far_samples=16),        # truncated buckets
    dict(cell_width=50.0, num_far_samples=8),      # one bucket: degenerate
    dict(num_hash_dims=2, num_far_samples=0),      # NEAR only
])
def test_grid_hbe_matches_reference(case):
    """The same seed gives the same grid (hash dims, shift), the same
    buckets and FAR draws: estimates at rtol 1e-5 and ``evals`` exactly,
    over two query batches (the generator's state carries across)."""
    x = _data(("hbe", tuple(sorted(case.items()))))
    rng = np.random.default_rng(1)
    y = np.concatenate([x[:5], rng.normal(0, 1.0, (4, 5))]).astype(
        np.float32)
    ref = JGridHBE(x, jgaussian(1.0), seed=3, **case)
    port = GridHBE(x, gaussian(1.0), seed=3, device="cpu", **case)
    np.testing.assert_array_equal(port.hash_dims, ref.hash_dims)
    np.testing.assert_array_equal(port.shift, ref.shift)
    for batch in (y, y[::-1].copy()):
        want = np.asarray(ref.query(jnp.asarray(batch)))
        got = port.query(_t(batch)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
        assert port.evals == ref.evals


def test_grid_hbe_factory_and_shared_level1():
    """``make_estimator("grid_hbe")`` builds a ``GridHBE`` with the
    factory's seed, and ``shared_level1_estimator`` gives a standalone one
    over the sampler's dataset (never the sampler's blocks), as the
    reference does."""
    x = _data("hbe-factory", n=120)
    est = make_estimator("grid_hbe", x, gaussian(1.0), seed=4,
                         device="cpu")
    ref = jmake_estimator("grid_hbe", x, jgaussian(1.0), seed=4)
    assert isinstance(est, GridHBE)
    np.testing.assert_allclose(est.query(_t(x[:6])).numpy(),
                               np.asarray(ref.query(jnp.asarray(x[:6]))),
                               rtol=RTOL)
    nbr = NeighborSampler(x, gaussian(1.0), exact_blocks=True, device="cpu")
    shared = shared_level1_estimator(nbr, "grid_hbe", seed=4)
    jnbr = JNeighborSampler(x, jgaussian(1.0), exact_blocks=True)
    jshared = jshared_level1_estimator(jnbr, "grid_hbe", seed=4)
    assert type(shared).__name__ == type(jshared).__name__ == "GridHBE"
    assert shared is not nbr.blocks
    assert shared.device == nbr.device


# --------------------------------------------------------------------- #
# MultiLevelKDE and tree mode
# --------------------------------------------------------------------- #
N_TREE, LEAF = 256, 32


def _trees(x, seed=0):
    jk, tk = jgaussian(1.0), gaussian(1.0)
    jt = JMultiLevelKDE(jnp.asarray(x), jk,
                        lambda xs, s: JExactKDE(xs, jk), leaf_size=LEAF,
                        seed=seed)
    tt = MultiLevelKDE(x, tk, lambda xs, s: ExactKDE(xs, tk, device="cpu"),
                       leaf_size=LEAF, seed=seed, device="cpu")
    return jt, tt


def test_multilevel_segments_and_evals_match_reference():
    """Same dyadic build (depth, node set, node seeds), the same segment
    estimates at rtol 1e-5 and the same ``evals`` after the same
    queries."""
    x = _data("tree-build", n=300)
    seeds = {}

    def factory(xs, s):
        seeds[(len(seeds), xs.shape[0])] = s
        return ExactKDE(xs, gaussian(1.0), device="cpu")

    jseeds = {}

    def jfactory(xs, s):
        jseeds[(len(jseeds), xs.shape[0])] = s
        return JExactKDE(xs, jgaussian(1.0))

    tt = MultiLevelKDE(x, gaussian(1.0), factory, leaf_size=20, seed=5,
                       device="cpu")
    jt = JMultiLevelKDE(jnp.asarray(x), jgaussian(1.0), jfactory,
                        leaf_size=20, seed=5)
    assert seeds == jseeds and tt.depth == jt.depth
    assert set(tt._nodes) == set(jt._nodes)
    y = x[:7]
    for lo, hi in [(0, 300), (0, 150), (150, 300), (75, 150), (281, 300)]:
        np.testing.assert_allclose(
            tt.segment_query(_t(y), lo, hi).numpy(),
            np.asarray(jt.segment_query(jnp.asarray(y), lo, hi)),
            rtol=RTOL)
        assert tt.children(lo, hi) == jt.children(lo, hi)
        assert tt.is_leaf(lo, hi) == jt.is_leaf(lo, hi)
    assert tt.evals == jt.evals == 7 * (300 + 150 + 150 + 75 + 19)


def _margins(tree, x, src, seed):
    """Per source, the smallest distance between a uniform of the
    reference's stream and the split it is compared with, along the
    port's own path (``depth`` branch uniforms, then the leaf draw's)."""
    rng = np.random.default_rng(seed)
    kv_of = gaussian(1.0).pairwise
    out = []
    for s in src:
        s = int(s)
        q = torch.as_tensor(x[s][None, :])
        lo, hi, margin = 0, tree.n, np.inf
        while not tree.is_leaf(lo, hi):
            (l0, l1), (r0, r1) = tree.children(lo, hi)
            a = float(tree.segment_query(q, l0, l1)[0])
            b = float(tree.segment_query(q, r0, r1)[0])
            a = max(a - 1.0, 1e-12) if l0 <= s < l1 else a
            b = max(b - 1.0, 1e-12) if r0 <= s < r1 else b
            pa = a / max(a + b, 1e-30)
            u = rng.uniform()
            margin = min(margin, abs(u - pa))
            lo, hi = (l0, l1) if u <= pa else (r0, r1)
        kv = kv_of(q, torch.as_tensor(x[lo:hi]))[0].numpy()
        kv[np.arange(lo, hi) == s] = 0.0
        cdf = np.cumsum(kv / kv.sum())
        u = rng.random()
        margin = min(margin, float(np.min(np.abs(cdf - u))))
        out.append(margin)
    return np.asarray(out)


def test_tree_mode_draws_match_reference():
    """``NeighborSampler(mode="tree")`` over ``ExactKDE`` nodes: the same
    seed gives the same neighbors (except where a uniform lies within
    1e-5 of its split), realized probabilities at rtol 1e-5, ``prob_of``
    at rtol 1e-5, and the same ``evals``."""
    x = _data("tree-draw", n=N_TREE, d=4, scale=0.6)
    jt, tt = _trees(x)
    jn = JNeighborSampler(x, jgaussian(1.0), mode="tree", tree=jt, seed=11)
    tn = NeighborSampler(x, gaussian(1.0), mode="tree", tree=tt, seed=11,
                         device="cpu")
    src = np.random.default_rng(2).integers(0, N_TREE, 24)
    jv, jq = jn.sample(src)
    tv, tq = tn.sample(src)
    dst = (src + 1 + np.arange(len(src)) * 7) % N_TREE
    np.testing.assert_allclose(tn.prob_of(src, dst),
                               np.asarray(jn.prob_of(src, dst)), rtol=RTOL)
    assert tn.evals == jn.evals
    near = _margins(tt, x, src, 11) < 1e-5
    same = np.asarray(jv) == tv
    assert np.all(same | near), (np.asarray(jv), tv)
    np.testing.assert_allclose(tq[same], np.asarray(jq)[same], rtol=RTOL)


def test_tree_mode_sample_exact_and_law():
    """Tree-mode ``sample_exact`` (host rejection rounds over the tree's
    own draws) matches the reference's draws under the same seed, and the
    tree's draws follow k(u, .) / deg(u) (chi-square over the neighbors
    of one source, alpha 1e-3)."""
    x = _data("tree-law", n=N_TREE, d=3, scale=0.5)
    jt, tt = _trees(x, seed=2)
    jn = JNeighborSampler(x, jgaussian(1.0), mode="tree", tree=jt, seed=4)
    tn = NeighborSampler(x, gaussian(1.0), mode="tree", tree=tt, seed=4,
                         device="cpu")
    src = np.arange(0, N_TREE, 37)
    np.testing.assert_array_equal(tn.sample_exact(src, rounds=3),
                                  np.asarray(jn.sample_exact(src, rounds=3)))
    assert tn.evals == jn.evals
    draws = 2000
    v, _ = tn.sample(np.full(draws, 5))
    k = gaussian(1.0).pairwise(_t(x[5:6]), _t(x))[0].numpy().astype(
        np.float64)
    k[5] = 0.0
    expected = draws * k / k.sum()
    keep = expected >= 5.0
    counts = np.bincount(v, minlength=N_TREE)
    obs = np.append(counts[keep], counts[~keep].sum())
    exp_ = np.append(expected[keep], expected[~keep].sum())
    chi = stats.chi2_statistic(obs, exp_)
    assert chi < stats.chi2_critical(len(obs) - 1), chi


def test_tree_mode_refusals():
    """Tree mode needs its tree, and the blocked engine's entries refuse
    it, as the reference's asserts do."""
    x = _data("tree-refuse", n=64, d=2)
    with pytest.raises(ValueError, match="MultiLevelKDE"):
        NeighborSampler(x, gaussian(1.0), mode="tree", device="cpu")
    _, tt = _trees(_data("tree-refuse-2", n=64, d=2))
    tn = NeighborSampler(x, gaussian(1.0), mode="tree", tree=tt,
                         device="cpu")
    with pytest.raises(ValueError, match="blocked"):
        tn.walk(np.arange(2), 2)
    with pytest.raises(ValueError, match="blocked"):
        tn.blocks
    with pytest.raises(ValueError):
        NeighborSampler(x, gaussian(1.0), mode="spiral", device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_positive_array_samplers_bitwise(seed):
    """``sample_from_positive_array`` and ``tree_descent_sample`` are the
    reference's host numpy: equal draws under the same generator seed."""
    a = np.random.default_rng(seed).random(37) ** 3
    np.testing.assert_array_equal(
        tvertex.sample_from_positive_array(a, 500,
                                           np.random.default_rng(seed)),
        jvertex.sample_from_positive_array(a, 500,
                                           np.random.default_rng(seed)))
    tr, jr = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [tvertex.tree_descent_sample(a, tr) for _ in range(200)] == \
        [jvertex.tree_descent_sample(a, jr) for _ in range(200)]


# --------------------------------------------------------------------- #
# RobustEstimator
# --------------------------------------------------------------------- #
def test_robust_clean_path_matches_reference_counters():
    """tests/test_chaos.py's clean path: the chain stops at its hash
    stage, builds no other stage, and counts the same ``evals`` (realized
    NEAR reads of the same layout + the FAR budget); the ``evals`` setter
    resets to 0 and refuses anything else."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((160, 3)).astype(np.float32)
    kw = dict(seed=0, stage_kw={"hash": {"max_bucket": 64,
                                         "num_far_samples": 32}})
    ref = jguards.RobustEstimator(x, jgaussian(1.0), **kw)
    port = tguards.RobustEstimator(x, gaussian(1.0), device="cpu", **kw)
    jv = np.asarray(ref.query(jnp.asarray(x[:24])))
    tv = port.query(_t(x[:24])).numpy()
    assert np.all(np.isfinite(tv)) and np.all(tv > 0) and np.all(jv > 0)
    assert port.escalations == ref.escalations == {"stratified": 0,
                                                   "exact": 0}
    assert set(port._stages) == set(ref._stages) == {"hash"}
    assert port.retries == ref.retries == 0
    assert port.evals == ref.evals > 0
    port.evals = 0
    assert port.evals == 0
    with pytest.raises(ValueError, match="reset to 0"):
        port.evals = 3


def test_robust_escalation_matches_reference():
    """A NEAR-only hash stage (``num_far_samples`` 0) returns exactly 0 for
    queries far from every bucket; they are retried, then escalated
    through the stratified stage (0 again) to the exact one.  The
    escalation and retry counters equal the reference's, the near rows
    keep their hash values and the far rows the exact stage's (both
    deterministic: rtol 1e-5)."""
    x = _data("robust-esc", n=200, d=3, scale=0.5)
    far = (x[:5] + 40.0).astype(np.float32)
    y = np.concatenate([x[:6], far, x[6:9]])
    kw = dict(seed=1, stage_kw={"hash": {"num_far_samples": 0}})
    ref = jguards.RobustEstimator(x, jgaussian(1.0), **kw)
    port = tguards.RobustEstimator(x, gaussian(1.0), device="cpu", **kw)
    want = np.asarray(ref.query(jnp.asarray(y)))
    got = port.query(_t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-30)
    assert port.escalations == ref.escalations == {"stratified": 5,
                                                   "exact": 5}
    assert port.retries == ref.retries == 10
    assert set(port._stages) == set(ref._stages)
    assert port.evals == ref.evals
    assert np.all(got[6:11] == 0.0) and np.all(got[:6] > 0)


def test_robust_factory_degrees_and_shared():
    """tests/test_chaos.py's factory case: ``make_estimator("robust")``
    builds the wrapper, and its Algorithm 4.3 degrees over the staged
    chain are within 35% of the truth on average; ``shared_level1_
    estimator(estimator="robust")`` gives a standalone wrapper."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((96, 3)).astype(np.float32)
    est = make_estimator("robust", x, gaussian(1.0), seed=0, device="cpu")
    assert isinstance(est, tguards.RobustEstimator)
    degs = est.degrees(batch=48)
    k = gaussian(1.0).pairwise(_t(x), _t(x)).numpy().astype(np.float64)
    truth = k.sum(1) - 1.0
    rel = np.abs(degs / np.maximum(truth, 1e-9) - 1)
    assert rel.mean() < 0.35, rel.mean()
    nbr = NeighborSampler(x, gaussian(1.0), device="cpu")
    shared = shared_level1_estimator(nbr, "robust", seed=0)
    assert isinstance(shared, tguards.RobustEstimator)
    assert shared.device == nbr.device
