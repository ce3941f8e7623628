"""Port parity: the auto-encoder's modules of aonerf_torch against aonerf
(the joint-state decoder, the degree embedding, the whole AE forward at the
published widths on a 64x48 source image, the opacity losses and the masked
photometric loss, values and gradients), with the port's weights carried to
flax by the bridge."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models.ae import AutoEncoderArticulatedNeRF as JaxAE
from aonerf.models.joint_state import JointStateDecoder as JaxJointStateDecoder
from aonerf.train import losses as jlosses
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.joint_state import JointStateDecoder
from aonerf_torch.train import losses
from aonerf_torch.utils.bridge import flax_leaves, module_flax_tree, module_state_dict_from_flax

torch.set_num_threads(2)

SC, NF = 8, 8
N_RAYS = 24
SRC_HW = (48, 64)


def _ae(**kwargs):
    return AutoEncoderArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True,
                                      generator=torch.Generator().manual_seed(2), device="cpu", **kwargs)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "viewdirs": d}


def test_joint_state_decoder_matches_flax():
    # a 32 -> 64 -> 32 -> 1 MLP in fp32 on both sides: within 1e-6
    dec = JointStateDecoder(generator=torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 32)).astype(np.float32)
    tree = module_flax_tree(dec)
    assert {p: v.shape for p, v in flax_leaves(tree["params"])} == {
        ("Dense_0", "kernel"): (32, 64), ("Dense_0", "bias"): (64,), ("Dense_1", "kernel"): (64, 32),
        ("Dense_1", "bias"): (32,), ("Dense_2", "kernel"): (32, 1), ("Dense_2", "bias"): (1,)}
    want = np.asarray(JaxJointStateDecoder().apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _half_degree_rad(deg: float) -> np.float32:
    """An fp32 angle whose fp32 product with 180/pi is exactly ``deg``."""
    k = np.float32(180.0 / np.pi)
    r = np.float32(deg) / k
    while np.float32(r * k) != np.float32(deg):
        r = np.nextafter(r, np.float32(np.inf) if r * k < deg else np.float32(-np.inf), dtype=np.float32)
    return r


def test_deg_code_rounds_half_to_even_and_clips():
    model = _ae()
    tree = module_flax_tree(model)
    angles = np.array([0.0, np.deg2rad(30.0), np.deg2rad(44.4), _half_degree_rad(12.5), _half_degree_rad(13.5),
                       _half_degree_rad(89.5), np.deg2rad(90.0), np.deg2rad(120.0), -0.3, np.deg2rad(-0.4)],
                      np.float32)
    with torch.no_grad():
        got = torch.stack([model.deg_code(torch.tensor(a)) for a in angles]).numpy()
    jmodel = JaxAE(num_coarse_samples=SC, num_fine_samples=NF)
    want = np.stack([np.asarray(jmodel.apply(tree, jnp.asarray(a), method=jmodel.deg_code)) for a in angles])
    table = model.deg_embedding.weight.detach().numpy()
    rows = [0, 30, 44, 12, 14, 90, 90, 90, 0, 0]  # 12.5 -> 12 and 13.5 -> 14 (half to even), 89.5 -> 90
    np.testing.assert_array_equal(got, table[rows])
    np.testing.assert_array_equal(want, table[rows])


# The AE's deterministic forward against the port in fp64, max abs error
# of JAX's fp32 and of the port's, the larger: the latents up to 1.5e-5 of
# their largest entry (the encoder's instance norm over 2x2 maps), the state
# 3.1e-6; published, rgb 2.0e-5, acc 3.1e-5, depth 1.2e-4; with relu's
# flat pdf (fine samples placed by near-zero coarse weights) rgb 1.1e-3,
# acc 1.7e-3, depth 5.7e-3. Held: latents 1e-4 of the largest entry, the
# state 1e-5, each level's outputs twice the spread, rounded up.
FORWARD_TOL = {
    "published": {"rgb": 1e-4, "acc": 1e-4, "depth": 5e-4},
    "raw_code_relu": {"rgb": 2.5e-3, "acc": 4e-3, "depth": 1.2e-2},
}


@pytest.mark.parametrize("option", [{}, {"embed_deg": False, "sigma_activation": "relu"}],
                         ids=["published", "raw_code_relu"])
def test_ae_forward_matches_flax(option, request):
    tol = FORWARD_TOL[request.node.callspec.id]
    model = _ae(**option)
    tree = module_flax_tree(model)
    rays = _rays(N_RAYS, 0)
    src = np.random.default_rng(1).uniform(-1, 1, (1, 3, *SRC_HW)).astype(np.float32)
    deg = np.float32(np.deg2rad(37.0))
    jmodel = JaxAE(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True, **option)
    jlevels, jlatents, jstate = jax.device_get(jax.jit(
        lambda p, r, s, d: jmodel.apply(p, r, s, d, False, True, 2.0, 6.0))(
        tree, {k: jnp.asarray(v) for k, v in rays.items()}, jnp.asarray(src), jnp.asarray(deg)))
    trays = {k: torch.from_numpy(v) for k, v in rays.items()}
    with torch.no_grad():
        levels, latents, state = model(trays, torch.from_numpy(src), torch.tensor(deg), False, True, 2.0, 6.0)
        exact = copy.deepcopy(model).double()
        _, latents64, _ = exact({k: v.double() for k, v in trays.items()}, torch.from_numpy(src).double(),
                                torch.tensor(deg), False, True, 2.0, 6.0)
    assert sorted(latents) == sorted(jlatents)
    assert ("articulation_deg" in latents) == option.get("embed_deg", True)
    for k in latents:
        scale = latents64[k].abs().max().item()
        np.testing.assert_allclose(latents[k].numpy(), jlatents[k], atol=1e-4 * scale, rtol=0, err_msg=k)
    assert state.shape == jstate.shape == (1, 1)
    np.testing.assert_allclose(state.numpy(), jstate, atol=1e-5, rtol=0)
    assert len(levels) == len(jlevels) == 2
    for level, jlevel in zip(levels, jlevels):
        for name, got, want in zip(("rgb", "acc", "depth"), level, jlevel):
            np.testing.assert_allclose(got.numpy(), want, atol=tol[name], rtol=0, err_msg=name)
    assert 0.05 < float(np.mean(jlevels[1][1])) < 0.95  # rays that hit and rays that miss


def test_ae_bridge_round_trips_the_whole_tree():
    model = _ae()
    tree = module_flax_tree(model)
    assert sorted(tree["params"]) == ["deg_embedding", "encoder", "field", "joint_state_decoder"]
    jmodel = JaxAE(num_coarse_samples=SC, num_fine_samples=NF)
    shapes = jax.eval_shape(lambda key, rays, src, deg: jmodel.init(key, rays, src, deg, False, True, 2.0, 6.0),
                            jax.random.PRNGKey(0), {k: jnp.zeros((8, 3)) for k in ("rays_o", "rays_d", "viewdirs")},
                            jnp.zeros((1, 3, *SRC_HW)), jnp.asarray(0.5))
    assert {p: v.shape for p, v in flax_leaves(tree["params"])} == {
        p: tuple(v.shape) for p, v in flax_leaves(shapes["params"])}
    back = module_state_dict_from_flax(tree)
    assert list(back) == list(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def _loss_inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    accs = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(2)]
    for acc in accs:  # saturated rays, whose clipped probability has no gradient
        acc[:3] = (0.0, 1.0, 1.0)
    mask = rng.uniform(size=n) < 0.4
    pred = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return accs, mask, pred, target


OPACITY = {
    "mse": (jlosses.opacity_loss_mse, losses.opacity_loss_mse, {}),
    "bce": (jlosses.opacity_loss_bce, losses.opacity_loss_bce, {"opacity_lambda": 0.05}),
    "bce_prob": (jlosses.opacity_loss_bce_prob, losses.opacity_loss_bce_prob, {"opacity_lambda": 0.5}),
    "autorf": (jlosses.opacity_loss_autorf, losses.opacity_loss_autorf, {}),
}


@pytest.mark.parametrize("name", list(OPACITY))
@pytest.mark.parametrize("seed", [0, 1])
def test_opacity_losses_match_jax(name, seed):
    # values to 1e-6 relative and gradients to 1e-6 of their largest entry
    # (means of 64 fp32 terms); no acc lies within rounding of bce_prob's
    # clip ends 0.01 and 0.99, where the two clips could split a tie
    jfn, tfn, kw = OPACITY[name]
    accs, mask, _, _ = _loss_inputs(seed)
    assert all(np.abs(a - 0.01).min() > 1e-6 and np.abs(a - 0.99).min() > 1e-6 for a in accs)
    want, jgrads = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(mask), **kw))([jnp.asarray(a) for a in accs])
    t_accs = [torch.from_numpy(a).requires_grad_() for a in accs]
    got = tfn(t_accs, torch.from_numpy(mask), **kw)
    grads = torch.autograd.grad(got, t_accs, allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for g, jg in zip(grads, jgrads):
        g = np.zeros(mask.shape, np.float32) if g is None else g.numpy()  # autorf never reads the fine level's fg
        np.testing.assert_allclose(g, np.asarray(jg), atol=1e-6 * max(np.abs(jg).max(), 1e-30), rtol=0)
    if name == "bce_prob":  # saturated rays get no gradient
        assert all(np.all(g.numpy()[:3] == 0) for g in grads)


@pytest.mark.parametrize("all_background", [False, True])
def test_masked_mse_matches_jax(all_background):
    _, mask, pred, target = _loss_inputs(3)
    if all_background:  # the denominator's floor of 1
        mask = np.zeros_like(mask)
    want, jg = jax.value_and_grad(jlosses.masked_mse)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.masked_mse(p, torch.from_numpy(target), torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, [p])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7, rtol=0)
    assert (got.item() == 0) == all_background
