"""Port parity at other encoding degrees: ``NeRFMLP`` and the two-level
``NeRF`` of aonerf_torch, built at (min_deg_point, max_deg_point, deg_view),
against flax ``apply`` of aonerf.models at the same degrees with the same
weights, carried by the bridge. The JAX Trainer passes these degrees into
``NeRF`` (``aonerf/train/loop.py``), which hands them to ``NeRFMLP``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRF as JaxNeRF
from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc_dim
from aonerf_torch.utils.bridge import mlp_state_dict_from_flax, nerf_state_dict_from_flax
from tests.test_torch_models import _rays

torch.set_num_threads(1)

# (min_deg_point, max_deg_point, deg_view): encoded widths 51 / 15, 63 / 39
# and 3 / 3 (no encoding: the points and directions themselves)
DEGREES = [(0, 8, 2), (2, 12, 6), (0, 0, 0)]


def _deg(degrees):
    return dict(zip(("min_deg_point", "max_deg_point", "deg_view"), degrees))


@pytest.mark.parametrize("degrees", DEGREES, ids=str)
def test_mlp_matches_flax_at_other_degrees(degrees):
    lo, hi, view = degrees
    P, V = pos_enc_dim(3, lo, hi), pos_enc_dim(3, 0, view)
    rng = np.random.default_rng(sum(degrees))
    x = rng.uniform(-1, 1, (4, 5, P)).astype(np.float32)
    cond = rng.uniform(-1, 1, (4, V)).astype(np.float32)
    jmlp = JaxNeRFMLP(**_deg(degrees))
    params = jax.device_get(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond)))
    want_rgb, want_sigma = jmlp.apply(params, jnp.asarray(x), jnp.asarray(cond))
    mlp = NeRFMLP(device="cpu", **_deg(degrees))
    assert (mlp.min_deg_point, mlp.max_deg_point, mlp.deg_view) == degrees
    # the flax tree's shapes are the port's: pts_0 (P -> 256), pts_5 (256 + P), views_0 (256 + V)
    assert tuple(mlp.pts_0.weight.shape) == (256, P) and tuple(mlp.pts_5.weight.shape) == (256, 256 + P)
    assert tuple(mlp.views_0.weight.shape) == (128, 256 + V)
    mlp.load_state_dict(mlp_state_dict_from_flax(params))
    with torch.no_grad():
        rgb, sigma = mlp(torch.from_numpy(x), torch.from_numpy(cond))
    # tests/test_torch_models.py's tolerance: fp32 products of depth 8 summed
    # in another order (2.2e-7 seen at 63 / 27)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=1e-6, rtol=0)


@pytest.mark.parametrize("degrees", DEGREES, ids=str)
def test_fresh_init_follows_the_degrees(degrees):
    # the same draws a layer as at the default degrees, each of its own fan-in
    a = NeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu", **_deg(degrees))
    b = NeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu", **_deg(degrees))
    P = pos_enc_dim(3, degrees[0], degrees[1])
    bound = np.sqrt(6.0 / (256 + 256 + P))
    w = a.pts_5.weight.detach()
    assert bound * 0.9 < float(w.abs().max()) <= bound
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("white_bkgd", [True, False])
@pytest.mark.parametrize("degrees", DEGREES, ids=str)
def test_nerf_matches_flax_at_other_degrees(degrees, white_bkgd):
    R = 16
    rays = _rays(R, 3)
    jnerf = JaxNeRF(num_coarse_samples=4, num_fine_samples=8, **_deg(degrees))
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    params = jax.device_get(jnerf.init(jax.random.PRNGKey(1), jrays, False, white_bkgd, 2.0, 6.0))
    want = jnerf.apply(params, jrays, False, white_bkgd, 2.0, 6.0)

    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu", **_deg(degrees))
    for mlp in (nerf.coarse_mlp, nerf.fine_mlp):
        assert (mlp.min_deg_point, mlp.max_deg_point, mlp.deg_view) == degrees
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    with torch.no_grad():  # the fused level's plain version on the CPU
        got = nerf({k: torch.from_numpy(v) for k, v in rays.items()}, False, white_bkgd, 2.0, 6.0)
    # tests/test_torch_models.py's tolerances (2e-6, 2e-6, 5e-5 at the
    # default degrees): the fused integrator's log-space transmittance
    # against the reference's cumprod, a few ULP a level, and the fine
    # t-values carry the coarse weights' error through the inverse CDF. The
    # encoding multiplies a t-value's error by its highest frequency,
    # 2^(max_deg_point - 1), 2^9 at the defaults, so the fine level's
    # tolerances scale by that ratio where it is above 1 (x4 at (2, 12, 6),
    # whose fine comp was seen 6.3e-6 off).
    scale = max(1.0, 2.0 ** (degrees[1] - 1 - 9))
    for level, (g, w) in enumerate(zip(got, want)):
        k = scale if level else 1.0
        comp, acc, depth = (x.numpy() for x in g)
        np.testing.assert_allclose(comp, np.asarray(w[0]), atol=2e-6 * k, rtol=0, err_msg=f"comp{level}")
        np.testing.assert_allclose(acc, np.asarray(w[1]), atol=2e-6 * k, rtol=0, err_msg=f"acc{level}")
        assert np.all(np.isfinite(np.asarray(w[2])))
        np.testing.assert_allclose(depth, np.asarray(w[2]), atol=5e-5 * k, rtol=0, err_msg=f"depth{level}")
