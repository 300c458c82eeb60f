"""The bf16 rowsum and blocksum on the tensor-core tile, on the CPU: the
plans that route them there, and a plain torch model of the tile's
arithmetic and summation order (``kde_rowsum.kernel.mma_sums_model``:
k-steps of 16 products, quad sums, at m <= 64 the two warp halves added in
a fixed order, the rowsum's warp-a-row reduce).

The model is held to the JAX reference's kernel values,
``_tile_kernel_values(precision="bf16")`` summed by row and by block,
within ``bf16_flip_slack`` plus the card tests' rtol 2e-4 / atol 1e-5:
two correct summation orders can read neighbouring entries of the bf16
exp table only where the slack is nonzero.  The kernels themselves run
only on the card (``tests/test_torch_cuda.py -k mma_rowsum``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.kernels.kde_rowsum.kernel import _tile_kernel_values
from repro_torch.kernels.kde_rowsum import kernel as trk
from repro_torch.kernels.kde_sampler import kernel as tsk
from repro_torch.kernels.kde_sampler.ref import bf16_flip_slack

RTOL, ATOL = 2e-4, 1e-5
L2 = ["gaussian", "exponential", "rational_quadratic"]
KINDS = L2 + ["laplacian"]
WIDTHS = [8, 16, 19, 32, 784]

_values = jax.jit(_tile_kernel_values, static_argnums=(2, 3, 4, 5, 6))


def _args(kind, d):
    return kind, 1.0 / (0.5 * d ** 0.5), 0.7 if kind == "rational_quadratic" \
        else 1.0


# --------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_plans_take_the_tensor_core_tile(kind, d, aligned):
    """At bf16, ``blocksum_plan`` and ``rowsum_plan`` take the tensor-core
    tile (``MMA`` + the padded d) exactly where ``sample_block_plan(...,
    precision="bf16")`` does, with ``group_for``'s groups; elsewhere the
    f32 plan's deep or generic tile.  The rowsum's split is the f32
    wide tile's (128-column chunks, 2 CTAs an SM).  The laplacian has no
    bf16 instance: ``kind_args`` refuses it before any plan."""
    if kind == "laplacian":
        with pytest.raises(ValueError, match="L2 kernels only"):
            trk.kind_args(kind, 1.0, 1.0, "bf16")
        return
    sp = tsk.sample_block_plan(300, 5000, d, 70, aligned, precision="bf16")
    bp = trk.blocksum_plan(300, 5000, d, 70, aligned, precision="bf16")
    f32 = trk.blocksum_plan(300, 5000, d, 70, aligned)
    if sp.instance >= tsk.MMA:
        assert bp == sp
        assert bp.instance == tsk.MMA + (16 if d <= 16 else 32)
        assert bp.group == tsk.group_for(bp.tiles, bp.nb, 132)
        assert bp._replace(instance=f32.instance) == f32
    else:
        assert bp == f32 and bp.instance < tsk.MMA
    rp, cols = trk.rowsum_plan(300, 5000, d, aligned, precision="bf16")
    rf, fcols = trk.rowsum_plan(300, 5000, d, aligned)
    assert rp.instance == bp.instance
    assert (rp._replace(instance=rf.instance), cols) == (rf, fcols)


def test_bf16_plans_at_the_main_path_shapes():
    """The bench_kde sweep's largest batch (m 64, n 1,048,576, d 16)
    splits into 256 blocks of 4096 columns on the tensor-core tile, one
    short query tile; the bf16 sparsifier's degrees (m 1024, n 65,536,
    bn 256) run 8 blocks a CTA over 8 query tiles, as the f32 wide tile."""
    plan, cols = trk.rowsum_plan(64, 1048576, 16, precision="bf16")
    assert (plan.instance, plan.tiles, plan.nb, cols) == (
        tsk.MMA + 16, 1, 256, 4096)
    plan = trk.blocksum_plan(1024, 65536, 16, 256, precision="bf16")
    assert (plan.instance, plan.tiles, plan.nb, plan.group) == (
        tsk.MMA + 16, 8, 256, 8)
    assert trk.blocksum_plan(1024, 65536, 16, 256).instance == 16


# --------------------------------------------------------------------- #
# the tile's summation order against the reference
# --------------------------------------------------------------------- #
def _reference_sums(q, x, kind, inv_bw, beta, bn):
    """Row sums and (m, ceil(n / bn)) block sums of the reference's bf16
    kernel values, in float64."""
    kv = np.asarray(_values(jnp.asarray(q), jnp.asarray(x), kind, inv_bw,
                            beta, 128, "bf16")).astype(np.float64)
    n = kv.shape[1]
    blocks = np.pad(kv, ((0, 0), (0, -n % bn))).reshape(kv.shape[0], -1,
                                                        bn).sum(-1)
    return kv.sum(1), blocks


def _within(got, want, slack, what):
    got = got.double().numpy()
    err = np.abs(got - want)
    bad = err > ATOL + RTOL * np.abs(want) + slack.numpy()
    assert not bad.any(), (what, int(bad.sum()), float(err.max()))
    assert np.isfinite(got).all()


def _hold_model_to_reference(q, x, kind, inv_bw, beta, bn):
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    rows, blocks = _reference_sums(q, x, kind, inv_bw, beta, bn)
    slack = bf16_flip_slack(tq, tx, kind, inv_bw)
    _within(trk.mma_sums_model(tq, tx, kind, inv_bw, beta), rows,
            slack.sum(1), "rowsum")
    _within(trk.mma_sums_model(tq, tx, kind, inv_bw, beta, bn), blocks,
            bf16_flip_slack(tq, tx, kind, inv_bw, bn), "blocksum")


def _points(label, shape, scale=0.5, offset=0.0):
    rng = np.random.default_rng(stats.derive_seed("torch_rowsum_mma",
                                                  label))
    return (offset + rng.normal(0, scale, shape)).astype(np.float32)


# (m, n, d, bn): short tiles (m <= 64: the warp halves split the columns),
# a full tile, a full and a short one in one call, one-column and ragged
# blocks, every padded width (d = 8 zero-padded to one k-step, 32 two)
MODEL_SHAPES = [(37, 3000, 16, 70), (64, 3000, 8, 256), (1, 700, 32, 1),
                (65, 2000, 32, 70), (129, 1500, 16, 256), (100, 600, 8, 1)]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
@pytest.mark.parametrize("kind", L2)
def test_mma_model_matches_reference(kind, shape):
    """The tile's order (model) against the reference's row and block sums
    of ``_tile_kernel_values(precision="bf16")``, within the flip slack,
    for every L2 kind at short and full query tiles."""
    m, n, d, bn = shape
    label = f"{kind}-{m}-{n}-{d}-{bn}"
    q = _points(label + "q", (m, d), 0.3)
    x = _points(label + "x", (n, d), 0.3)
    kind, inv_bw, beta = _args(kind, d)
    _hold_model_to_reference(q, x, kind, inv_bw, beta, bn)


@pytest.mark.parametrize("offset", [4.0, 30.0, 300.0])
@pytest.mark.parametrize("d,m", [(16, 40), (32, 150), (8, 64)])
@pytest.mark.parametrize("kind", L2)
def test_mma_model_on_cancelling_inputs(kind, d, m, offset):
    """Inputs built for cancellation: a common offset large against a 0.5
    spread (qq + xx - 2c keeps a few bits of the norms) and queries that
    are dataset rows (d2 = 0 against themselves).  The k-step model of the
    cross term stays within the flip slack of the reference."""
    n, bn = 1000, 70
    label = f"cancel-{kind}-{d}-{m}-{offset}"
    x = _points(label, (n, d), 0.5, offset)
    rng = np.random.default_rng(stats.derive_seed("torch_rowsum_mma",
                                                  label + "src"))
    q = x[rng.integers(0, n, m)]
    kind, inv_bw, beta = _args(kind, d)
    _hold_model_to_reference(q, x, kind, inv_bw, beta, bn)


@pytest.mark.parametrize("kind", ["gaussian", "exponential"])
def test_mma_model_one_column_blocks_are_the_plain_values(kind):
    """One-column blocks of the model are single kernel values: equal to
    the plain version's (``blocksum_plain``) wherever the flip slack is
    0, so the model's epilogue is the policy's arithmetic."""
    q = torch.from_numpy(_points("one-q", (70, 16), 0.3))
    x = torch.from_numpy(_points("one-x", (500, 16), 0.3))
    kind, inv_bw, beta = _args(kind, 16)
    got = trk.mma_sums_model(q, x, kind, inv_bw, beta, 1)
    want = trk.blocksum_plain(q, x, kind, inv_bw, beta, 1, "bf16")
    slack = bf16_flip_slack(q, x, kind, inv_bw)
    assert torch.equal(got[slack == 0], want[slack == 0])
    assert int((slack == 0).sum()) > 0.9 * slack.numel()


def test_mma_model_short_and_full_tiles_agree():
    """In a short tile the warp halves sum the even and the odd 16-column
    pairs apart: a row of a 64-row call and the same row of a 65-row call
    (a full tile) sum the same kernel values in two orders, so they agree
    to f32 rounding."""
    q = torch.from_numpy(_points("short-q", (65, 16), 0.3))
    x = torch.from_numpy(_points("short-x", (900, 16), 0.3))
    for bn in (256, None):
        short = trk.mma_sums_model(q[:64], x, "gaussian", 0.5, bn=bn)
        full = trk.mma_sums_model(q, x, "gaussian", 0.5, bn=bn)[:64]
        torch.testing.assert_close(short, full, rtol=1e-6, atol=0.0)
