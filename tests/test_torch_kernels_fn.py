"""The PyTorch port's kernel functions against the JAX reference.

Both sides get the same numpy inputs; each tolerance is stated with the
assertion.  Also holds the port's import-hygiene check: nothing under
``src/repro_torch`` (nor ``chip_smoke.py``) may import JAX or the
reference package.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stats
from repro.core import kernels_fn as jk
from repro_torch import convert
from repro_torch.core import kernels_fn as tk

ROOT = Path(__file__).resolve().parents[1]
KINDS = [("gaussian", {}), ("exponential", {}), ("laplacian", {}),
         ("rational_quadratic", {"beta": 0.7})]


def _points(*labels, shape=(37, 19), scale=0.6):
    rng = np.random.default_rng(stats.derive_seed("torch_kernels_fn",
                                                  *labels))
    return rng.normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("name,kw", KINDS)
def test_pairwise_matches_reference(name, kw):
    """k(x, y) blocks agree to f32 rounding of the same formula (rtol
    2e-5, atol 1e-6: the two frameworks sum the dot products and the L1
    terms in different orders); the metadata is identical."""
    x, y = _points(name, "x"), _points(name, "y", shape=(29, 19))
    ref = jk.make_kernel(name, bandwidth=1.7, **kw)
    port = tk.make_kernel(name, bandwidth=1.7, **kw)
    # jitted: one compile instead of one per primitive
    want = np.asarray(jax.jit(ref.pairwise)(jnp.asarray(x), jnp.asarray(y)))
    got = port.pairwise(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert (port.name, port.bandwidth, port.beta, port.kde_exponent) == \
        (ref.name, ref.bandwidth, ref.beta, ref.kde_exponent)
    if ref.squaring_constant is None:
        assert port.squaring_constant is None
    else:
        assert port.squaring_constant == pytest.approx(ref.squaring_constant)


@pytest.mark.parametrize("name,kw", KINDS)
def test_pairs_matches_reference(name, kw):
    """Aligned k(x_i, y_i): rtol 2e-5 / atol 1e-6 (f32 rounding)."""
    x, y = _points(name, "px"), _points(name, "py")
    ref = jk.make_kernel(name, bandwidth=2.3, **kw)
    port = convert.kernel_from_reference(ref.name, ref.bandwidth, ref.beta)
    want = np.asarray(jax.jit(ref.pairs)(jnp.asarray(x), jnp.asarray(y)))
    got = port.pairs(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gaussian", "exponential", "laplacian",
                                  "rational_quadratic"])
def test_squared_kernel_dataset_matches_reference(name):
    """cX is the same scaling (exact up to one f32 multiply), and the
    squaring identity k(x,y)^2 = k(cx, cy) holds on the port (rtol 1e-4:
    the scaled distances round differently); the rational quadratic
    kernel has no squaring constant on either side."""
    x = _points(name, "sq")
    ref = jk.make_kernel(name, bandwidth=1.3)
    port = tk.make_kernel(name, bandwidth=1.3)
    if ref.squaring_constant is None:
        with pytest.raises(ValueError):
            jk.squared_kernel_dataset(ref, jnp.asarray(x))
        with pytest.raises(ValueError):
            tk.squared_kernel_dataset(port, torch.as_tensor(x))
        return
    want = np.asarray(jk.squared_kernel_dataset(ref, jnp.asarray(x)))
    xt = torch.as_tensor(x)
    got = tk.squared_kernel_dataset(port, xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    k = port.matrix(xt).double()
    np.testing.assert_allclose(port.matrix(got).double().numpy(),
                               (k * k).numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("ord_", [1, 2])
def test_median_bandwidth_matches_reference_without_subsample(ord_):
    """Below ``sample`` points neither side subsamples, so the medians
    agree (rtol 1e-5: f32 distance rounding)."""
    x = _points("median", ord_, shape=(120, 7))
    want = jk.median_bandwidth(jnp.asarray(x), ord=ord_)
    got = tk.median_bandwidth(torch.as_tensor(x), ord=ord_)
    assert got == pytest.approx(want, rel=1e-5)


def test_convert_helpers():
    """The state carried across: dataset tensor, kernel parameters and a
    PrefixCDF built from numpy weights."""
    x = _points("convert", shape=(11, 3))
    xt = convert.dataset_from_numpy(x, device="cpu")
    assert xt.dtype == torch.float32 and xt.device.type == "cpu"
    np.testing.assert_array_equal(xt.numpy(), x)
    cdf = convert.degrees_from_numpy(np.arange(1.0, 12.0), seed=3,
                                     device="cpu")
    assert cdf.total == pytest.approx(66.0)
    ker = convert.kernel_from_reference("rational_quadratic", 2.0, 0.5)
    assert (ker.name, ker.bandwidth, ker.beta) == ("rational_quadratic",
                                                   2.0, 0.5)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_never_imports_jax_or_reference():
    """No file of the port package, nor chip_smoke.py, imports jax or the
    reference package ``repro`` (``repro_torch`` itself is fine)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [str(p.relative_to(ROOT)) for p in files
           if _FORBIDDEN.search(p.read_text())]
    assert not bad, f"forbidden imports in {bad}"
