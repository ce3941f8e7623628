"""Port parity of ``noise_std``: the sigma noise of randomized renders, fed
JAX's own draws.

JAX's fields split each level's key into the sampling key and a noise key
(``aonerf/models/nerf.py:70-72``, ``articulated.py:349-351``) and add
``uniform(noise_key, raw_sigma.shape) * noise_std`` to raw sigma before the
activation. The tests here draw those numbers with JAX's key splits and hand
them to the port in the order it asks (jitter, noise, exponentials, noise):
the vanilla level (the plain K1s with noise, K2's plain backward from the
noisy ``raw``) and the two-level vanilla loss, the auto-decoder's loss and
gradients, and the auto-encoder's randomized forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import NeRF as JaxNeRF
from aonerf.models.ae import AutoEncoderArticulatedNeRF as JaxAE
from aonerf.models.mlp import NeRFMLP as JaxNeRFMLP
from aonerf.ops import encoding as jencoding
from aonerf.ops import render as jrender
from aonerf.ops.math import img2mse as jimg2mse
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from aonerf_torch.train import step as tstep
from aonerf_torch.utils.bridge import (
    articulated_flax_tree,
    articulated_state_dict_from_flax,
    mlp_flax_tree,
    module_flax_tree,
    nerf_flax_tree,
    nerf_state_dict_from_flax,
)
from tests.test_torch_ae import FORWARD_TOL
from tests.test_torch_articulated import NERF_TOL, QueueDraws, _latents, _t
from tests.test_torch_train import _assert_grads_close
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

NOISE_STD = 1.0
B, SC, NF = 16, 4, 8


def jax_noisy_render_draws(render_key, n_rays, sc, nf, noise_shape):
    """What JAX's two-level field with noise_std > 0 draws from
    ``render_key``, in the port's order: the coarse jitter, the coarse
    noise, the fine exponentials, the fine noise; ``noise_shape(S)`` is the
    shape of a level's raw sigma at S samples."""
    keys = jax.random.split(render_key, 2)
    (k0, n0), (k1, n1) = (jax.random.split(k) for k in keys)
    return [np.array(jax.random.uniform(k0, (n_rays, sc + 1), dtype=jnp.float32)),
            np.array(jax.random.uniform(n0, noise_shape(sc + 1), dtype=jnp.float32)),
            np.array(jax.random.exponential(k1, (n_rays, nf + 1), dtype=jnp.float32)),
            np.array(jax.random.uniform(n1, noise_shape(sc + 1 + nf), dtype=jnp.float32))]


class PortShapedDraws(QueueDraws):
    """QueueDraws whose noise comes in the port's shape: JAX draws a
    level's noise as raw sigma's (R, S, 1), the fused level asks for (R, S);
    the numbers are the same."""

    def noise(self, shape):
        a = self.arrays.pop(0)
        assert a.size == int(np.prod(shape)), (a.shape, shape)
        return torch.from_numpy(np.array(a)).reshape(tuple(shape))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d}


def _jax_nerf_params(rays, seed=0):
    params = JaxNeRF(num_coarse_samples=SC, num_fine_samples=NF).init(
        jax.random.PRNGKey(seed), {k: jnp.asarray(v[:8]) for k, v in rays.items()}, False, True, 2.0, 6.0)
    return jax.tree_util.tree_map(np.array, params)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_noisy_level_and_its_gradient_match_jax(white_bkgd):
    # One level (S = 17) with noise: JAX's NeRFMLP, the noise added to raw
    # sigma, volumetric_rendering; the port's fused level on the CPU (the
    # plain K1s adding the same noise, K2's plain backward from its noisy
    # raw). fp32 both sides: outputs and the noisy raw sigma to 1e-5 (depth
    # 1e-4) of their largest entry, each gradient to 1e-4 of its largest
    # entry (tests/test_torch_train.py's rule for the untroubled layers).
    rays = _rays(B, 1)
    params = _jax_nerf_params(rays)
    mlp_params = {"params": params["params"]["coarse_mlp"]}
    rng = np.random.default_rng(2)
    S = 17
    t = np.sort(rng.uniform(2.0, 6.0, (B, S)), axis=-1).astype(np.float32)
    pts = rays["rays_o"][:, None] + t[..., None] * rays["rays_d"][:, None]
    u = np.array(jax.random.uniform(jax.random.PRNGKey(3), (B, S, 1), dtype=jnp.float32))
    cot = [rng.standard_normal(s).astype(np.float32) for s in ((B, 3), (B,), (B,), (B, S))]

    def jax_level(p):
        raw_rgb, raw_sigma = JaxNeRFMLP().apply(
            p, jencoding.pos_enc(jnp.asarray(pts), 0, 10), jencoding.pos_enc(jnp.asarray(rays["viewdirs"]), 0, 4))
        raw_sigma = raw_sigma + jnp.asarray(u) * NOISE_STD
        comp, acc, weights, depth = jrender.volumetric_rendering(
            jax.nn.sigmoid(raw_rgb), jax.nn.relu(raw_sigma), jnp.asarray(t), jnp.asarray(rays["rays_d"]), white_bkgd)
        return (comp, acc, depth, weights), raw_sigma

    (want, want_raw), vjp = jax.vjp(jax_level, mlp_params)
    want_g = vjp((tuple(jnp.asarray(c) for c in cot), jnp.zeros_like(want_raw)))[0]["params"]

    nerf = NeRF(num_coarse_samples=SC, num_fine_samples=NF, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    mlp = nerf.coarse_mlp
    tt, o, d = (torch.from_numpy(a) for a in (t, rays["rays_o"], rays["rays_d"]))
    args = (fr.kernel_params(mlp), tt, o, d, pos_enc(d, 0, 4), pos_enc(torch.from_numpy(pts), 0, 10), white_bkgd)
    noise = torch.from_numpy(u).reshape(B, S) * NOISE_STD
    with torch.no_grad():
        *_, raw = ft.fused_level_fwd_spill(*args, noise=noise)
        quiet = ft.fused_level_fwd_spill(*args)
    np.testing.assert_allclose(raw[:, 0].numpy(), np.asarray(want_raw).reshape(-1),
                               atol=1e-5 * np.abs(want_raw).max(), rtol=0)
    got = ft.fused_level(*args, noise=noise)
    for name, g, w in zip(("comp", "acc", "depth", "weights"), got, want):
        tol = 1e-4 if name == "depth" else 1e-5
        assert _rel(g.detach().numpy(), w) <= tol, (name, _rel(g.detach().numpy(), w))
    sum(torch.sum(g * torch.from_numpy(c)) for g, c in zip(got, cot)).backward()
    grads = mlp_flax_tree(mlp, grads=True)
    assert sorted(grads) == sorted(want_g)
    for layer in want_g:
        for k in want_g[layer]:
            err = _rel(grads[layer][k], want_g[layer][k])
            assert err <= 1e-4, (layer, k, err)
    # the noise moved raw sigma only
    assert not torch.equal(quiet[-1][:, 0], raw[:, 0]) and torch.equal(quiet[-1][:, 1:], raw[:, 1:])


def test_noisy_two_level_loss_and_grads_match_jax():
    # MSE(coarse) + MSE(fine) of JAX's NeRF(noise_std=1.0) with
    # randomized=True against the port's NeRF through the fused levels on
    # the CPU, the jitter, noise and exponentials of JAX's key: the loss to
    # 1e-5 relative and the gradients by tests/test_torch_train.py's rule
    # (1e-4 of each leaf's largest entry, or twice its layer's stated fp32
    # spread).
    rays = _rays(B, 4)
    target = np.random.default_rng(5).uniform(size=(B, 3)).astype(np.float32)
    params = _jax_nerf_params(rays)
    for m in ("coarse_mlp", "fine_mlp"):  # live gradients at init, as tests/test_torch_train.py
        params["params"][m]["density"]["bias"] = params["params"][m]["density"]["bias"] + 0.3
    model = JaxNeRF(num_coarse_samples=SC, num_fine_samples=NF, noise_std=NOISE_STD)
    key = jax.random.PRNGKey(9)
    batch = {**{k: jnp.asarray(v) for k, v in rays.items()}, "target": jnp.asarray(target)}

    def loss_fn(p):
        out = model.apply(p, batch, True, True, 2.0, 6.0, key=key)
        return jimg2mse(out[0][0], batch["target"]) + jimg2mse(out[1][0], batch["target"])

    want_loss, want_g = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))

    nerf = NeRF(num_coarse_samples=SC, num_fine_samples=NF, device="cpu", noise_std=NOISE_STD)
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    draws = PortShapedDraws(jax_noisy_render_draws(key, B, SC, NF, lambda s: (B, s, 1)))
    tb = {**{k: torch.from_numpy(v) for k, v in rays.items()}, "target": torch.from_numpy(target)}
    params_t = dict(nerf.named_parameters())
    loss, _, grads = tstep.vanilla_loss_and_grads(nerf, params_t, tb, draws, True, True, 2.0, 6.0)
    assert not draws.arrays  # every draw taken, noise included
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for p, g in zip(params_t.values(), grads):
        p.grad = g
    _assert_grads_close(nerf_flax_tree(nerf, grads=True)["params"], want_g["params"], "noisy grads")
    # the same draws without the noise give another loss
    quiet = NeRF(num_coarse_samples=SC, num_fine_samples=NF, device="cpu")
    quiet.load_state_dict(nerf.state_dict())
    d = jax_noisy_render_draws(key, B, SC, NF, lambda s: (B, s, 1))
    loss_q, _, _ = tstep.vanilla_loss_and_grads(quiet, dict(quiet.named_parameters()), tb,
                                                PortShapedDraws([d[0], d[2]]), True, True, 2.0, 6.0)
    assert abs(loss_q.item() - loss.item()) > 1e-4 * loss.item()


def test_noise_is_only_drawn_for_randomized_renders():
    # deterministic renders (validation, test, serving) draw no noise and
    # run K1, as JAX's renderer ignores noise_std without randomized
    rays = {k: torch.from_numpy(v) for k, v in _rays(B, 6).items()}
    nerf = NeRF(num_coarse_samples=SC, num_fine_samples=NF, device="cpu", noise_std=NOISE_STD,
                generator=torch.Generator().manual_seed(0))
    quiet = NeRF(num_coarse_samples=SC, num_fine_samples=NF, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = nerf(rays, False, True, 2.0, 6.0), quiet(rays, False, True, 2.0, 6.0)
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


# The articulated field's gradients below in fp32 against the same in fp64
# (the port's field cast to fp64, the same draws and noise): max abs error /
# max |fp64| of flax's grads and of the port's, the larger, over a layer's
# leaves and both backgrounds, rounded up. Listed are the layers above 1e-4;
# every other leaf is within it. The fine level's deformation MLP and trunk
# are ill-conditioned in fp32 at 16 randomized rays, as in
# tests/test_torch_autodecoder_step.py (the warped point through sin(2^9 x),
# the last sample's distance of 1e10); with the noise the fine density head
# joins them (7.4e-3). flax and the port lie within these of each other.
NOISY_FIELD_SPREAD = {
    "coarse_mlp/pts_0": 1.6e-4,
    "fine_mlp/deform_0": 1.4e-2, "fine_mlp/deform_1": 1.6e-2, "fine_mlp/deform_2": 1.8e-2,
    "fine_mlp/deform_3": 2.2e-2, "fine_mlp/deform_out": 3.2e-2, "fine_mlp/density": 7.5e-3,
    "fine_mlp/pts_0": 4.8e-3, "fine_mlp/pts_1": 3.5e-3, "fine_mlp/pts_2": 4.2e-3, "fine_mlp/pts_3": 3.3e-3,
    "fine_mlp/pts_4": 2.5e-3, "fine_mlp/pts_5": 2.5e-3, "fine_mlp/pts_6": 8.8e-3, "fine_mlp/pts_7": 3.5e-3,
}


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_noisy_articulated_field_loss_and_grads_match_flax(white_bkgd):
    # The auto-decoder's field (latent_dense, softplus density) randomized
    # with noise_std 1.0 on 16 rays and one code: both levels' outputs at
    # tests/test_torch_articulated.py's NERF_TOL, the loss to 1e-5 relative
    # and the gradients of MSE(coarse) + MSE(fine) by the rule of
    # tests/test_torch_autodecoder_step.py (1e-4 of each leaf's largest
    # entry, or twice its layer's fp32 spread, NOISY_FIELD_SPREAD).
    sc = nf = 8
    n_rays = 16
    rng = np.random.default_rng(3)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": (-4.0 * d + 0.05 * rng.standard_normal((n_rays, 3))).astype(np.float32), "rays_d": d,
            "viewdirs": d}
    lat = _latents(rng)
    target = rng.uniform(size=(n_rays, 3)).astype(np.float32)
    jnerf = JaxArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=True, noise_std=NOISE_STD)
    params = jax.device_get(jnerf.init(jax.random.PRNGKey(0), rays, False, True, 2.0, 6.0, lat))
    key = jax.random.PRNGKey(13)

    def loss_fn(p):
        out = jnerf.apply(p, rays, True, white_bkgd, 2.0, 6.0, lat, key=key)
        return jimg2mse(out[0][0], target) + jimg2mse(out[1][0], target), out

    (want_loss, want_out), want_g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    nerf = ArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=True, noise_std=NOISE_STD,
                           device="cpu")
    nerf.load_state_dict(articulated_state_dict_from_flax(params))
    draws = PortShapedDraws(jax_noisy_render_draws(key, n_rays, sc, nf, lambda s: (n_rays, s, 1)))
    out = nerf(_t(rays), True, white_bkgd, 2.0, 6.0, _t(lat), draws=draws)
    assert not draws.arrays
    for level, (g_level, w_level) in enumerate(zip(out, want_out)):
        for name, g, w in zip(NERF_TOL, g_level, w_level):
            err = np.max(np.abs(g.detach().numpy() - np.asarray(w)))
            assert err <= NERF_TOL[name], (level, name, err)
    loss = sum(torch.mean((o[0] - torch.from_numpy(target)) ** 2) for o in out)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    got = articulated_flax_tree(nerf, grads=True)["params"]
    for m, layers in want_g["params"].items():
        for layer, leaves in layers.items():
            tol = max(1e-4, 2 * NOISY_FIELD_SPREAD.get(f"{m}/{layer}", 0.0))
            for k, w in leaves.items():
                err = _rel(got[m][layer][k], w)
                assert err <= tol, (m, layer, k, err, tol)


SRC_HW = (48, 64)


def test_noisy_ae_forward_matches_flax():
    # The auto-encoder's randomized forward with noise_std 1.0 (the field's
    # fp32 raw sigma plus JAX's noise draws, the jitter and exponentials of
    # the same key) against flax, at tests/test_torch_ae.py's published
    # tolerances; the latents and the state do not see the noise.
    tol = FORWARD_TOL["published"]
    n_rays = 24
    model = AutoEncoderArticulatedNeRF(num_coarse_samples=8, num_fine_samples=8, latent_dense=True,
                                       noise_std=NOISE_STD, generator=torch.Generator().manual_seed(2), device="cpu")
    tree = module_flax_tree(model)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": (-4.0 * d + 0.3 * rng.standard_normal((n_rays, 3))).astype(np.float32), "rays_d": d,
            "viewdirs": d}
    src = np.random.default_rng(1).uniform(-1, 1, (1, 3, *SRC_HW)).astype(np.float32)
    deg = np.float32(np.deg2rad(37.0))
    key = jax.random.PRNGKey(11)
    jmodel = JaxAE(num_coarse_samples=8, num_fine_samples=8, latent_dense=True, noise_std=NOISE_STD)
    jlevels, _, jstate = jax.device_get(jax.jit(
        lambda p, r, s, dg, k: jmodel.apply(p, r, s, dg, True, True, 2.0, 6.0, key=k))(
        tree, {k: jnp.asarray(v) for k, v in rays.items()}, jnp.asarray(src), jnp.asarray(deg), key))
    draws = PortShapedDraws(jax_noisy_render_draws(key, n_rays, 8, 8, lambda s: (n_rays, s, 1)))
    with torch.no_grad():
        levels, _, state = model({k: torch.from_numpy(v) for k, v in rays.items()}, torch.from_numpy(src),
                                 torch.tensor(deg), True, True, 2.0, 6.0, draws=draws)
    assert not draws.arrays
    np.testing.assert_allclose(state.numpy(), jstate, atol=1e-5, rtol=0)
    for level, jlevel in zip(levels, jlevels):
        for name, got, want in zip(("rgb", "acc", "depth"), level, jlevel):
            np.testing.assert_allclose(got.numpy(), want, atol=tol[name], rtol=0, err_msg=name)
