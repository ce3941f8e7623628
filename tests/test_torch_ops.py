"""Port parity: rendering ops of aonerf_torch against aonerf.ops (CPU, fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops import encoding as jenc
from aonerf.ops import math as jmath
from aonerf.ops import sampling as jsamp
from aonerf_torch.ops import encoding, sampling
from aonerf_torch.ops import math as tmath

torch.set_num_threads(1)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    return o, d


@pytest.mark.parametrize("min_deg,max_deg", [(0, 10), (0, 4), (2, 2)])
def test_pos_enc(min_deg, max_deg):
    x = np.random.default_rng(0).uniform(-6, 6, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jenc.pos_enc(jnp.asarray(x), min_deg, max_deg))
    got = encoding.pos_enc(torch.from_numpy(x), min_deg, max_deg).numpy()
    assert got.shape == want.shape
    assert encoding.pos_enc_dim(3, min_deg, max_deg) == want.shape[-1]
    # Same float32 phases; sin implementations differ by a few ULP at |phase|
    # up to 2^9 * 6.
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_psnr_math():
    a, b = np.random.default_rng(1).uniform(size=(2, 4, 4, 3)).astype(np.float32)
    mse_j = jmath.img2mse(jnp.asarray(a), jnp.asarray(b))
    mse_t = tmath.img2mse(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(mse_t), float(mse_j), rtol=1e-6)
    np.testing.assert_allclose(
        float(tmath.mse2psnr(mse_t)), float(jmath.mse2psnr(mse_j)), rtol=1e-6
    )


@pytest.mark.parametrize("n", [9, 65, 128, 193])
def test_linspace_matches_jax_bitwise(n):
    want = np.asarray(jnp.linspace(0.0, 1.0 - 2.0**-32, n, dtype=jnp.float32))
    np.testing.assert_array_equal(sampling.linspace_f32(0.0, 1.0 - 2.0**-32, n), want)


@pytest.mark.parametrize("num_samples,lindisp", [(8, False), (64, False), (16, True)])
def test_sample_along_rays(num_samples, lindisp):
    o, d = _rays(6, 0)
    tj, cj = jsamp.sample_along_rays(jnp.asarray(o), jnp.asarray(d), num_samples, 2.0, 6.0, False, lindisp)
    tt, ct = sampling.sample_along_rays(torch.from_numpy(o), torch.from_numpy(d), num_samples, 2.0, 6.0, False, lindisp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6, rtol=0)


def _bins_weights(b, n, seed):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (b, n)), axis=-1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (b, n - 1)).astype(np.float32)
    weights[0] = 0.0  # all-zero row: the eps padding path
    weights[1, 3:] = 0.0  # flat cdf tail
    return bins, weights


@pytest.mark.parametrize("n,num_samples", [(8, 16), (63, 128)])
def test_sorted_piecewise_constant_pdf(n, num_samples):
    bins, weights = _bins_weights(5, n, n)
    want = np.asarray(
        jsamp.sorted_piecewise_constant_pdf(jnp.asarray(bins), jnp.asarray(weights), num_samples, False)
    )
    got = sampling.sorted_piecewise_constant_pdf(
        torch.from_numpy(bins), torch.from_numpy(weights), num_samples, False
    ).numpy()
    # Identical bin selection; cumsum order may differ by an ULP of the cdf.
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(np.diff(got, axis=-1) >= 0)


def test_pdf_u_near_one_clamps_to_last_bin():
    """u_max = 1 - 2^-32 rounds to 1.0 in fp32: both indices clamp to N-1."""
    bins, weights = _bins_weights(4, 10, 3)
    got = sampling.sorted_piecewise_constant_pdf(
        torch.from_numpy(bins), torch.from_numpy(weights), 12, False
    ).numpy()
    want = np.asarray(
        jsamp.sorted_piecewise_constant_pdf(jnp.asarray(bins), jnp.asarray(weights), 12, False)
    )
    np.testing.assert_array_equal(got[:, -1], bins[:, -1])
    np.testing.assert_array_equal(want[:, -1], bins[:, -1])


def test_pdf_u_on_cdf_value():
    """Uniform weights put cdf values exactly on the u grid: the bracketing
    must pick the same bins as the JAX selection (last cdf <= u)."""
    bins = np.tile(np.linspace(2.0, 6.0, 9, dtype=np.float32), (2, 1))
    weights = np.full((2, 8), 0.25, np.float32)
    want = np.asarray(
        jsamp.sorted_piecewise_constant_pdf(jnp.asarray(bins), jnp.asarray(weights), 9, False)
    )
    got = sampling.sorted_piecewise_constant_pdf(
        torch.from_numpy(bins), torch.from_numpy(weights), 9, False
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_pdf():
    o, d = _rays(5, 4)
    t_coarse = np.sort(np.random.default_rng(5).uniform(2, 6, (5, 9)), -1).astype(np.float32)
    weights = np.random.default_rng(6).uniform(0, 1, (5, 9)).astype(np.float32)
    mids = 0.5 * (t_coarse[:, 1:] + t_coarse[:, :-1])
    tj, cj = jsamp.sample_pdf(
        jnp.asarray(mids), jnp.asarray(weights[:, 1:-1]), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_coarse), 16, False,
    )
    tt, ct = sampling.sample_pdf(
        torch.from_numpy(mids), torch.from_numpy(weights[:, 1:-1]), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_coarse), 16, False,
    )
    assert tt.shape == (5, 25)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=0)
