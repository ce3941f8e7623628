"""Port parity: the randomized sampling of aonerf_torch fed JAX's own draws.

JAX's PRNG streams cannot be reproduced in torch, so each test draws with
jax.random exactly as the JAX function does and hands the same numbers to
the port through a replaying draws object."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aonerf.ops import sampling as jsamp
from aonerf.ops import sorting as jsort
from aonerf_torch.ops import sampling, sorting
from aonerf_torch.ops.random import Draws

# Both fp32 with the same operations in the same order; 1e-6 covers one ulp
# of t in [2, 6] (4.8e-7).
ATOL = 1e-6


class Replay:
    """Hands out given arrays in order, one list per kind of draw."""

    def __init__(self, uniform=(), exponential=()):
        self._u, self._e = list(uniform), list(exponential)

    def uniform(self, shape):
        u = self._u.pop(0)
        assert tuple(u.shape) == tuple(shape)
        return torch.from_numpy(np.asarray(u))

    def exponential(self, shape):
        e = self._e.pop(0)
        assert tuple(e.shape) == tuple(shape)
        return torch.from_numpy(np.asarray(e))


def _rays(B, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (-4.0 * d).astype(np.float32), d


def test_randomized_sample_along_rays_matches_jax():
    o, d = _rays(16, 0)
    key = jax.random.PRNGKey(3)
    want_t, want_x = jsamp.sample_along_rays(jnp.asarray(o), jnp.asarray(d), 64, 2.0, 6.0, True, False, key=key)
    u = np.array(jax.random.uniform(key, (16, 65), dtype=jnp.float32))
    got_t, got_x = sampling.sample_along_rays(
        torch.from_numpy(o), torch.from_numpy(d), 64, 2.0, 6.0, True, False, draws=Replay(uniform=[u])
    )
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL, rtol=0)


def test_sorted_uniform_matches_jax():
    key = jax.random.PRNGKey(7)
    want = jsort.sorted_uniform(key, (5, 128))
    e = np.array(jax.random.exponential(key, (5, 129), dtype=jnp.float32))
    got = sorting.sorted_uniform(Replay(exponential=[e]), (5, 128))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()


def test_randomized_sample_pdf_matches_jax():
    o, d = _rays(16, 1)
    rng = np.random.default_rng(1)
    t_vals = np.sort(rng.uniform(2.0, 6.0, (16, 65)), axis=-1).astype(np.float32)
    bins = 0.5 * (t_vals[:, 1:] + t_vals[:, :-1])
    # Dyadic weights (k / 64, k >= 1 integers summing to 256 per ray) make the
    # pdf and every partial sum of the cdf exact in fp32. The sorted uniforms
    # still come from a cumsum of 129 exponentials that JAX and torch sum in
    # other orders (a few ulps of u), which the inverse CDF scales by bin width
    # / bin mass (up to ~15x here): 1e-5, the tolerance tests/test_torch_ops.py
    # holds the deterministic sample_pdf to for the same reason.
    k = np.stack([rng.multinomial(256 - 63, [1 / 63] * 63) + 1 for _ in range(16)])
    weights = (k / 64.0).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_t, want_x = jsamp.sample_pdf(
        *map(jnp.asarray, (bins, weights, o, d, t_vals)), 128, True, key=key
    )
    e = np.array(jax.random.exponential(key, (16, 129), dtype=jnp.float32))
    got_t, got_x = sampling.sample_pdf(
        *map(torch.from_numpy, (bins, weights, o, d, t_vals)), 128, True, draws=Replay(exponential=[e])
    )
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5, rtol=0)


def test_draws_repeat_per_step_and_differ_across_steps():
    a = Draws.for_step(0, 5, "cpu").uniform((4, 3))
    b = Draws.for_step(0, 5, "cpu").uniform((4, 3))
    c = Draws.for_step(0, 6, "cpu").uniform((4, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    e = Draws.for_step(1, 0, "cpu").exponential((1000,))
    assert (e > 0).all() and 0.8 < e.mean().item() < 1.2
    idx = Draws.for_step(1, 0, "cpu").randint(10, (100,))
    assert idx.dtype == torch.int64 and idx.min() >= 0 and idx.max() < 10
