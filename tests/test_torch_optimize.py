"""Port parity: test-time code optimization of aonerf_torch against
aonerf's ``optimize_codes``, with a trained-looking field's weights bridged
and every random number replayed (the codes' normals, then each step's
batch and render draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.ops.math import img2mse
from aonerf.train import optimize as joptimize
from aonerf.train import step as jstep
from aonerf_torch.data import sapien_multi as sm
from aonerf_torch.data import synthetic
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.train import optimize
from aonerf_torch.utils.bridge import articulated_state_dict_from_flax
from tests.test_torch_articulated import QueueDraws, jax_render_draws
from tests.test_torch_sapien_multi import jax_batch_draws

torch.set_num_threads(2)

B, SC, NF, WH = 16, 8, 8, (16, 12)
N_STEPS, LR = 3, 1e-2


def _step_keys(key, s):
    """(sample_key, render_key) of JAX's code optimization step ``s``."""
    return jax.random.split(jax.random.fold_in(jax.random.split(key)[1], s))


def jax_optimize_draws(key, shape, n_steps=N_STEPS):
    """Everything JAX's optimize_codes draws from ``key`` over ``n_steps``:
    the two codes' normals, then each step's batch and render draws."""
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    arrays = [np.array(jax.random.normal(k, (1, 128))) for k in (k1, k2)]
    for s in range(n_steps):
        sample_key, render_key = _step_keys(key, s)
        arrays += jax_batch_draws(sample_key, *shape, B) + jax_render_draws(render_key, B, SC, NF)
    return QueueDraws(arrays)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = synthetic.generate_multi_scene(str(tmp_path_factory.mktemp("multi")), img_wh=WH, n_instances=2,
                                          degrees=(0, 10, 20), n_images=2)
    bufs = sm.SapienMultiDataset(root, split="train", img_wh=WH).device_buffers()
    for k in ("rgb", "mask", "c2w"):  # instance 1 only, as the Trainer restricts them
        bufs[k] = bufs[k][1:2]
    jmodel = JaxArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True)
    rng = np.random.default_rng(0)
    art_table = (0.3 * rng.standard_normal((10, 32))).astype(np.float32)
    lat = {"density": jnp.zeros((1, 128)), "color": jnp.zeros((1, 128)), "articulation": jnp.asarray(art_table[:1])}
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 8)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d},
                                        False, True, 2.0, 6.0, lat))
    key = jax.random.PRNGKey(17)
    codes, history = joptimize.optimize_codes(
        jmodel, params, jnp.asarray(art_table), {k: jnp.asarray(v) for k, v in bufs.items()}, key, n_steps=N_STEPS,
        lr=LR, batch_size=B, inner_steps=1,
    )
    return {"bufs": bufs, "params": params, "art_table": art_table, "key": key, "jmodel": jmodel,
            "codes": jax.device_get(codes), "history": history}


def _port_run(setup, n_steps):
    model = ArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True, device="cpu")
    model.load_state_dict(articulated_state_dict_from_flax(setup["params"]))
    bufs = {k: torch.from_numpy(v) for k, v in setup["bufs"].items()}
    draws = jax_optimize_draws(setup["key"], bufs["c2w"].shape[:3] + (WH[0] * WH[1],), n_steps)
    codes, history = optimize.optimize_codes(model, torch.from_numpy(setup["art_table"]), bufs, draws,
                                             n_steps=n_steps, lr=LR, batch_size=B, inner_steps=1)
    assert not draws.arrays  # every replayed number was asked for, in order
    return model, codes, history


def _jax_loss(setup, codes, s):
    """JAX's code-optimization loss and fine PSNR at step ``s`` for the given
    codes (train/optimize.py's loss_fn, on that step's batch and draws)."""
    sample_key, render_key = _step_keys(setup["key"], s)
    batch = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in setup["bufs"].items()}, sample_key, B)
    latents = {"density": jnp.asarray(codes["density"]), "color": jnp.asarray(codes["color"]),
               "articulation": jnp.atleast_2d(jnp.asarray(setup["art_table"])[batch["articulation_id"]])}
    out = setup["jmodel"].apply(setup["params"], batch, True, True, 2.0, 6.0, latents, key=render_key)
    loss1 = img2mse(out[1][0], batch["target"])
    reg = 1e-4 * (jnp.linalg.norm(latents["density"]) + jnp.linalg.norm(latents["color"]))
    return float(img2mse(out[0][0], batch["target"]) + loss1 + reg), float(-10.0 * jnp.log10(loss1))


def test_optimize_codes_matches_jax(setup):
    model, codes, history = _port_run(setup, N_STEPS)
    for n, p in model.named_parameters():  # the field stays frozen, and trainable afterwards
        assert p.requires_grad, n
    state = model.state_dict()
    for name, w in articulated_state_dict_from_flax(setup["params"]).items():
        assert torch.equal(state[name], w), name
    want = setup["history"]
    assert len(history["loss"]) == len(want["loss"]) == N_STEPS
    # From the same start the first step's loss and fine PSNR agree to 1e-5
    # relative (fp32 both sides). Adam's first steps are sign-like: a code
    # entry whose gradient is near 0 and differs in sign moves by up to 2 lr
    # a step, and the trajectories part (at this seed one density entry
    # flips in step 0), so the codes are held to 2 lr a step and each later
    # step's loss to JAX's loss at the port's own codes (next test).
    np.testing.assert_allclose(history["loss"][0], want["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(history["psnr1"][0], want["psnr1"][0], rtol=1e-5)
    for k in ("density", "color"):
        assert codes[k].shape == (1, 128)
        np.testing.assert_allclose(codes[k].numpy(), setup["codes"][k], atol=2 * LR * N_STEPS, rtol=0, err_msg=k)


@pytest.mark.parametrize("s", range(1, N_STEPS))
def test_each_step_loss_is_jax_loss_at_the_port_codes(setup, s):
    # the port's codes after s steps, and step s's loss and fine PSNR from
    # them, against JAX's loss function at those codes: 1e-5 relative
    _, codes, _ = _port_run(setup, s)
    _, _, history = _port_run(setup, s + 1)
    want_loss, want_psnr1 = _jax_loss(setup, {k: v.numpy() for k, v in codes.items()}, s)
    np.testing.assert_allclose(history["loss"][s], want_loss, rtol=1e-5)
    np.testing.assert_allclose(history["psnr1"][s], want_psnr1, rtol=1e-5)


def test_init_codes_are_scaled_normals():
    draws = QueueDraws([np.ones((1, 4), np.float32), -np.ones((1, 4), np.float32)])
    codes = optimize.init_codes(draws, obj_code_dim=4)
    assert torch.equal(codes["density"], torch.full((1, 4), 0.01))
    assert torch.equal(codes["color"], torch.full((1, 4), -0.01))
