"""Port parity: the articulated field, its code library and the code
regularization of aonerf_torch against aonerf, with the same weights carried
by the bridge and the same random numbers replayed.

The MLP alone is compared at narrow widths, the two-level field at its fixed
full width on a few rays with 8 + 8 samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import ArticulatedNeRFMLP as JaxArticulatedNeRFMLP
from aonerf.models import CodeLibraryArticulated as JaxCodeLibrary
from aonerf.train.losses import code_regularization as jax_code_regularization
from aonerf_torch.models.articulated import ArticulatedNeRF, ArticulatedNeRFMLP, broadcast_latent
from aonerf_torch.models.codes import CodeLibraryArticulated
from aonerf_torch.train.losses import code_regularization
from aonerf_torch.utils.bridge import (
    articulated_flax_tree,
    articulated_state_dict_from_flax,
    codes_flax_tree,
    codes_state_dict_from_flax,
    mlp_flax_tree,
    mlp_state_dict_from_flax,
)

torch.set_num_threads(1)

NARROW = dict(netdepth=6, netwidth=32, netdepth_deformation=2, netwidth_deformation=16, netdepth_condition=2,
              netwidth_condition=16)
SC, NF = 8, 8


class QueueDraws:
    """A draws object (``ops.random.Draws``'s methods) that hands out given
    arrays in order, each checked against the shape asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a))

    def randint(self, high, shape):
        a = self._next(shape)
        assert (a < high).all()
        return a.to(torch.int64)

    def uniform(self, shape):
        return self._next(shape)

    def exponential(self, shape):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)


def jax_render_draws(render_key, n_rays, sc=SC, nf=NF):
    """The coarse jitter and fine exponentials JAX's two-level field draws
    from ``render_key``."""
    k0, k1 = jax.random.split(render_key, 2)
    return [np.array(jax.random.uniform(k0, (n_rays, sc + 1), dtype=jnp.float32)),
            np.array(jax.random.exponential(k1, (n_rays, nf + 1), dtype=jnp.float32))]


def _latents(rng, n=1, art_dim=32):
    return {"density": rng.standard_normal((n, 128)).astype(np.float32),
            "color": rng.standard_normal((n, 128)).astype(np.float32),
            "articulation": rng.standard_normal((n, art_dim)).astype(np.float32)}


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "viewdirs": d}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _rel(got, want):
    """max abs error / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


def _mlp_inputs(seed, n_lat, enc_after=True):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((4, 5, 3 if enc_after else 63)).astype(np.float32)
    cond = rng.standard_normal((4, 27)).astype(np.float32)
    return pos, cond, _latents(rng, n_lat)


# fp32 on both sides, different summation order: outputs within 1e-4 of their
# largest entry. The warped point goes through sin(2^9 x), which multiplies
# its rounding by 512: measured at these inputs, each side's fp32 output is
# up to 5.2e-5 (sigma) and 5.8e-6 (rgb) of the largest entry away from the
# port's fp64 output, and the two sides up to 6.0e-5 from each other.
MLP_TOL = 1e-4


@pytest.mark.parametrize("latent_dense", [False, True])
@pytest.mark.parametrize("n_lat", [1, 4], ids=["one_code", "per_ray_codes"])
@pytest.mark.parametrize("option", [{}, {"enc_after": False}, {"embed_deg": True}, {"deformation_mlp": False}],
                         ids=["default", "enc_before", "embed_deg", "no_deformation"])
def test_mlp_matches_flax(latent_dense, n_lat, option):
    pos, cond, lat = _mlp_inputs(0, n_lat, option.get("enc_after", True))
    if option.get("embed_deg"):
        lat["articulation_deg"] = lat.pop("articulation")
    jmlp = JaxArticulatedNeRFMLP(latent_dense=latent_dense, **NARROW, **option)
    params = jmlp.init(jax.random.PRNGKey(0), pos, cond, lat)
    want = jmlp.apply(params, pos, cond, lat)
    mlp = ArticulatedNeRFMLP(latent_dense=latent_dense, device="cpu", **NARROW, **option)
    mlp.load_state_dict(mlp_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = mlp(torch.from_numpy(pos), torch.from_numpy(cond), _t(lat))
    for name, g, w in zip(("rgb", "sigma"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= MLP_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("n_lat", [1, 4], ids=["one_code", "per_ray_codes"])
def test_mlp_schedules_agree_on_one_set_of_parameters(n_lat):
    # The same parameters under both schedules, each in fp32, against the
    # concat schedule in fp64: outputs within MLP_TOL, gradients within 2e-4
    # of their largest entry (measured up to 7.7e-5 for either schedule: the
    # deformation layers' gradients come back through sin(2^9 x)).
    pos, cond, lat = _mlp_inputs(1, n_lat)
    concat = ArticulatedNeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu", **NARROW)
    dense = ArticulatedNeRFMLP(latent_dense=True, device="cpu", **NARROW)
    dense.load_state_dict(concat.state_dict())
    exact = ArticulatedNeRFMLP(device="cpu", **NARROW).double()
    exact.load_state_dict(concat.state_dict())
    outs, grads = [], []
    for mlp in (exact, concat, dense):
        dt = next(mlp.parameters()).dtype
        rgb, sigma = mlp(torch.from_numpy(pos).to(dt), torch.from_numpy(cond).to(dt),
                         {k: v.to(dt) for k, v in _t(lat).items()})
        (rgb.square().sum() + sigma.square().sum()).backward()
        outs.append((rgb.detach(), sigma.detach()))
        grads.append(mlp_flax_tree(mlp, grads=True))
    for out, grad in zip(outs[1:], grads[1:]):
        for a, b in zip(out, outs[0]):
            assert _rel(a, b) <= MLP_TOL
        for layer, leaves in grads[0].items():
            for k, g in leaves.items():
                assert _rel(grad[layer][k], g) <= 2e-4, (layer, k, _rel(grad[layer][k], g))


def test_broadcast_latent():
    code = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(broadcast_latent(code[:1], 4), code[:1].expand(4, 3))
    assert torch.equal(broadcast_latent(code, 4), code[[0, 0, 1, 1]])
    with pytest.raises(ValueError, match="does not divide"):
        broadcast_latent(code, 5)


def _nerf_pair(latent_dense, seed=0, **kwargs):
    rays = _rays(8, seed)
    lat = _latents(np.random.default_rng(seed))
    jnerf = JaxArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=latent_dense, **kwargs)
    params = jax.device_get(jnerf.init(jax.random.PRNGKey(seed), rays, False, True, 2.0, 6.0, lat))
    nerf = ArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=latent_dense, device="cpu",
                           **kwargs)
    nerf.load_state_dict(articulated_state_dict_from_flax(params))
    return jnerf, params, nerf, rays, lat


# Full width, fp32 on both sides: rgb and acc to 1e-5, depth to 1e-4 (the
# fine t-values come from the coarse weights through the inverse CDF).
NERF_TOL = {"rgb": 1e-5, "acc": 1e-5, "depth": 1e-4}


def _assert_levels_close(got, want, tol=NERF_TOL):
    for level, (g_level, w_level) in enumerate(zip(got, want)):
        for name, g, w in zip(tol, g_level, w_level):
            err = np.max(np.abs(g.detach().numpy() - np.asarray(w)))
            assert err <= tol[name], (level, name, err)


@pytest.mark.parametrize("latent_dense", [False, True])
@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_nerf_matches_flax(latent_dense, randomized, white_bkgd):
    jnerf, params, nerf, rays, lat = _nerf_pair(latent_dense)
    key = jax.random.PRNGKey(7)
    want = jnerf.apply(params, rays, randomized, white_bkgd, 2.0, 6.0, lat, key=key if randomized else None)
    draws = QueueDraws(jax_render_draws(key, 8)) if randomized else None
    with torch.no_grad():
        got = nerf(_t(rays), randomized, white_bkgd, 2.0, 6.0, _t(lat), draws=draws)
    _assert_levels_close(got, want)


@pytest.mark.parametrize("option", [{"sigma_activation": "relu"}, {"sigma_cap": 0.5},
                                    {"tail_to_background": True}, {"enc_after": False}],
                         ids=["relu", "sigma_cap", "tail_to_background", "enc_before"])
def test_nerf_options_match_flax(option):
    jnerf, params, nerf, rays, lat = _nerf_pair(True, seed=1, **option)
    want = jnerf.apply(params, rays, False, True, 2.0, 6.0, lat)
    with torch.no_grad():
        got = nerf(_t(rays), False, True, 2.0, 6.0, _t(lat))
    tol = NERF_TOL
    if option.get("sigma_activation") == "relu":
        # relu's exact zeros leave flat stretches in the coarse pdf where the
        # inverse CDF is steep: each side's fine depth is up to 2.2e-4 from
        # the port's fp64 render here, the two 4.1e-4 apart
        tol = dict(NERF_TOL, depth=1e-3)
    _assert_levels_close(got, want, tol)


def test_nerf_bridge_round_trips_params_and_grads():
    jnerf, params, nerf, rays, lat = _nerf_pair(True)
    tree = articulated_flax_tree(nerf)["params"]
    for m in ("coarse_mlp", "fine_mlp"):
        for layer, leaves in params["params"][m].items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(tree[m][layer][k], v)
    out = nerf(_t(rays), False, True, 2.0, 6.0, _t(lat))
    (out[1][0].sum() + out[0][0].sum()).backward()
    grads = articulated_flax_tree(nerf, grads=True)["params"]
    assert grads["fine_mlp"]["pts_0"]["kernel"].shape == (63 + 128, 256)
    assert grads["coarse_mlp"]["deform_0"]["kernel"].shape == (3 + 128 + 32, 128)


def test_field_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):  # bf16 runs, and noise_std (tests/test_torch_noise.py)
        ArticulatedNeRF(device="cpu", compute_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="fused_head"):
        ArticulatedNeRFMLP(fused_head=True, device="cpu")
    with pytest.raises(ValueError, match="latent_dense"):
        ArticulatedNeRFMLP(netdepth=5, latent_dense=True, device="cpu")
    with pytest.raises(ValueError, match="sigma_activation"):
        ArticulatedNeRF(sigma_activation="exp", device="cpu")


def test_code_library_matches_flax():
    jlib = JaxCodeLibrary(n_max_objs=3)
    params = jax.device_get(jlib.init(jax.random.PRNGKey(0), jnp.asarray(0), jnp.asarray(0)))
    lib = CodeLibraryArticulated(n_max_objs=3, device="cpu")
    lib.load_state_dict(codes_state_dict_from_flax(params))
    for name, t in codes_flax_tree(lib)["params"].items():
        np.testing.assert_array_equal(t["embedding"], params["params"][name]["embedding"])
    with torch.no_grad():
        np.testing.assert_array_equal(lib.get_interpolated_articulations().numpy(),
                                      jlib.apply(params, method=jlib.get_interpolated_articulations))
        for ii, di, is_test in ((2, 9, False), (1, 17, True), (np.array([0, 2]), np.array([3, 4]), False),
                                (np.array([1, 1]), np.array([0, 18]), True)):
            want = jlib.apply(params, jnp.asarray(ii), jnp.asarray(di), is_test=is_test)
            got = lib(torch.as_tensor(ii), torch.as_tensor(di), is_test=is_test)
            assert set(got) == set(want) == {"density", "color", "articulation"}
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_code_library_init_is_xavier_from_the_generator():
    a = CodeLibraryArticulated(generator=torch.Generator().manual_seed(3), device="cpu")
    b = CodeLibraryArticulated(generator=torch.Generator().manual_seed(3), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        n, c = p.shape
        assert p.abs().max() <= np.sqrt(6.0 / (n + c)), name
    assert a.get_interpolated_articulations().shape == (19, 32)


@pytest.mark.parametrize("n", [1, 3])
def test_code_regularization_matches_jax(n):
    lat = _latents(np.random.default_rng(n), n)
    want = float(jax_code_regularization({k: jnp.asarray(v) for k, v in lat.items()}, weight=1e-4))
    got = code_regularization(_t(lat), weight=1e-4).item()
    # fp32 sums of 3 x 128 terms in two libraries' orders: within 1e-7 of
    # each other for the (1, C) codes of training, 3e-7 (5 ulp) for (3, C)
    np.testing.assert_allclose(got, want, rtol=1e-7 if n == 1 else 3e-7)
    if n == 1:  # a (1, C) code: the mean of |c_j|, not its L2 norm
        np.testing.assert_allclose(got, 1e-4 * sum(np.abs(v).mean() for v in lat.values()), rtol=1e-6)
