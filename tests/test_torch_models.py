"""Port parity: NeRFMLP and the two-level NeRF of aonerf_torch against flax
``apply`` of aonerf.models with the same weights, carried by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRF as JaxNeRF
from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.utils.bridge import (
    MLP_LAYERS,
    mlp_state_dict_from_flax,
    nerf_state_dict_from_flax,
)

torch.set_num_threads(1)


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.2 * rng.standard_normal((R, 3))).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "viewdirs": d}


def test_mlp_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 5, 63)).astype(np.float32)
    cond = rng.uniform(-1, 1, (4, 27)).astype(np.float32)
    jmlp = JaxNeRFMLP()
    params = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
    want_rgb, want_sigma = jmlp.apply(params, jnp.asarray(x), jnp.asarray(cond))
    mlp = NeRFMLP(device="cpu")
    mlp.load_state_dict(mlp_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        rgb, sigma = mlp(torch.from_numpy(x), torch.from_numpy(cond))
    # fp32 matmuls of depth 8 in another summation order (seen: 2.2e-7)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=1e-6, rtol=0)


def test_fresh_init_matches_flax_init_law():
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu")
    w = mlp.pts_5.weight.detach()
    assert tuple(w.shape) == (256, 319)
    bound = np.sqrt(6.0 / (256 + 319))
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound
    assert torch.all(mlp.density.bias == 0.3)
    assert torch.all(mlp.bottleneck.bias == 0.0)
    again = NeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.pts_5.weight, w)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_nerf_matches_flax(white_bkgd):
    R = 16
    rays = _rays(R, 1)
    jnerf = JaxNeRF(num_coarse_samples=4, num_fine_samples=8)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    params = jnerf.init(jax.random.PRNGKey(1), jrays, False, white_bkgd, 2.0, 6.0)
    want = jnerf.apply(params, jrays, False, white_bkgd, 2.0, 6.0)

    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = nerf({k: torch.from_numpy(v) for k, v in rays.items()}, False, white_bkgd, 2.0, 6.0)

    assert len(got) == 2
    # The port's levels use the fused kernel's integrator (log-space
    # transmittance) and the reference's XLA path a cumprod; they agree to a
    # few ULP per level, and the fine t-values inherit the coarse weights'
    # error through the inverse CDF. Seen over 4 seeds: comp/acc <= 8.3e-7,
    # depth (values near 4) <= 1.2e-5.
    for level, (g, w) in enumerate(zip(got, want)):
        comp, acc, depth = (x.numpy() for x in g)
        np.testing.assert_allclose(comp, np.asarray(w[0]), atol=2e-6, rtol=0, err_msg=f"comp{level}")
        np.testing.assert_allclose(acc, np.asarray(w[1]), atol=2e-6, rtol=0, err_msg=f"acc{level}")
        # The reference clips depth into [min, max] of itself after NaN->inf;
        # that is the identity where every depth is finite.
        assert np.all(np.isfinite(np.asarray(w[2])))
        np.testing.assert_allclose(depth, np.asarray(w[2]), atol=5e-5, rtol=0, err_msg=f"depth{level}")


def test_bridge_round_trip():
    """flax tree -> state_dict -> NeRF -> state_dict gives back every flax
    array, transposed to (out, in) and unchanged."""
    rays = {k: jnp.asarray(v) for k, v in _rays(4, 2).items()}
    params = jax.device_get(
        JaxNeRF(num_coarse_samples=4, num_fine_samples=4).init(
            jax.random.PRNGKey(2), rays, False, True, 2.0, 6.0
        )
    )
    nerf = NeRF(num_coarse_samples=4, num_fine_samples=4, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    sd = nerf.state_dict()
    assert len(sd) == 2 * 2 * len(MLP_LAYERS)
    for mlp in ("coarse_mlp", "fine_mlp"):
        for layer in MLP_LAYERS:
            p = params["params"][mlp][layer]
            np.testing.assert_array_equal(sd[f"{mlp}.{layer}.weight"].numpy().T, p["kernel"])
            np.testing.assert_array_equal(sd[f"{mlp}.{layer}.bias"].numpy(), p["bias"])


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from aonerf_torch import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeRF()
    assert default_device("cpu") == torch.device("cpu")
