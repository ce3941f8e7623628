"""Port parity: the auto-encoder's first-step loss and every leaf's gradient
(encoder, field, joint-state decoder, degree embedding) against
``jax.value_and_grad`` of aonerf's ``_ae_loss_fn``, from the same weights,
batch and draws, for the photometric loss over fg pixels and over all
pixels and two opacity losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops.math import mse2psnr as jax_mse2psnr
from aonerf.train import step as jstep
from aonerf.train import step_ae as jstep_ae
from aonerf_torch.ops.math import mse2psnr
from aonerf_torch.train import step as tstep
from aonerf_torch.train import step_ae as tstep_ae
from aonerf_torch.utils.bridge import module_flax_tree
from tests.test_torch_ae_step import (
    B,
    PSNR_ATOL,
    WH,
    draw_shape,
    jax_leaves,
    jax_model,
    jax_step_draws,
    port_leaves,
    port_model,
    scene_buffers,
)
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

# The first step's gradients in fp32 against the port in fp64 (same batch
# and draws): max abs error / max |fp64| of JAX's and of the port's, the
# larger, over the leaves of a layer or stage and the three variants below,
# measured at 2 significant digits. Listed are those above 1e-4; every
# other leaf (the coarse rgb head, the joint-state decoder) is within 1e-4.
# The encoder inherits the field's ill-conditioning (sin(2^9 x) of the
# warped point; tests/test_torch_autodecoder_step.py) through the density
# and color codes; JAX's articulation head stands out: a ReLU in its layer4
# lies within fp32 rounding of 0, so JAX's fp32 takes the other one-sided
# derivative (central differences of the port in fp64 give the port's
# value, -0.0974, at h <= 1e-6, and JAX's, -0.334, one side at h >= 1e-4).
FP32_SPREAD = {
    "encoder.conv1": 0.074, "encoder.layer1": 0.082, "encoder.layer2": 0.1, "encoder.layer3": 0.11,
    "encoder.color_layer4": 0.0057, "encoder.color_fc": 0.0045, "encoder.density_layer4": 0.091,
    "encoder.density_fc": 0.042, "encoder.articulation_layer4": 0.39, "encoder.articulation_fc": 0.0002,
    "coarse_mlp.deform_0": 0.025, "coarse_mlp.deform_1": 0.024, "coarse_mlp.deform_2": 0.028,
    "coarse_mlp.deform_3": 0.032, "coarse_mlp.deform_out": 0.02, "coarse_mlp.pts_0": 0.023,
    "coarse_mlp.pts_1": 0.021, "coarse_mlp.pts_2": 0.025, "coarse_mlp.pts_3": 0.027, "coarse_mlp.pts_4": 0.016,
    "coarse_mlp.pts_5": 0.017, "coarse_mlp.pts_6": 0.011, "coarse_mlp.pts_7": 0.017, "coarse_mlp.density": 0.00019,
    "coarse_mlp.bottleneck": 0.0058, "coarse_mlp.views_0": 0.0042, "coarse_mlp.views_1": 0.013,
    "coarse_mlp.views_2": 0.002, "coarse_mlp.views_3": 0.0014, "fine_mlp.deform_0": 0.064,
    "fine_mlp.deform_1": 0.061, "fine_mlp.deform_2": 0.055, "fine_mlp.deform_3": 0.034,
    "fine_mlp.deform_out": 0.071, "fine_mlp.pts_0": 0.048, "fine_mlp.pts_1": 0.036, "fine_mlp.pts_2": 0.032,
    "fine_mlp.pts_3": 0.03, "fine_mlp.pts_4": 0.018, "fine_mlp.pts_5": 0.011, "fine_mlp.pts_6": 0.022,
    "fine_mlp.pts_7": 0.018, "fine_mlp.density": 0.00064, "fine_mlp.bottleneck": 0.0049,
    "fine_mlp.views_0": 0.0068, "fine_mlp.views_1": 0.0068, "fine_mlp.views_2": 0.0065, "fine_mlp.views_3": 0.013,
    "fine_mlp.rgb": 0.00021, "deg_embedding": 0.047,
}
# The same errors as ||error|| / ||fp64|| per leaf: at most 0.081 (JAX's
# articulation layer4), so a gradient off by a factor (0.5 or more) fails.
FRO_TOL = 0.2
# the first step's loss parts, relative (tests/test_torch_ae_step.py)
PARTS_RTOL = {"loss": 1e-4, "loss0": 1e-4, "loss1": 1e-4, "loss_state": 4e-4, "opacity_loss": 5e-5}


def _group(name: str) -> str:
    """A parameter's layer or stage, the key of FP32_SPREAD."""
    parts = name.split(".")
    if parts[0] == "encoder":
        return ".".join(parts[:2])
    return ".".join(p for p in parts[:-1] if p != "field")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return scene_buffers(tmp_path_factory.mktemp("multi"))


@pytest.mark.parametrize("photometric,opacity_loss", [("masked", "bce_prob"), ("full", "bce_prob"),
                                                       ("masked", "mse")])
def test_first_step_loss_and_grads_match_jax(scene, photometric, opacity_loss):
    # The loss parts within PARTS_RTOL; each leaf's max abs error / max |JAX|
    # at most max(1e-4, twice its layer's spread) (each side lies within the
    # spread of the exact value) and ||error|| / ||JAX|| at most FRO_TOL.
    bufs = scene
    model = port_model()
    params = jax.tree_util.tree_map(jnp.asarray, module_flax_tree(model))
    base_key = jax.random.PRNGKey(5)
    loss_fn = jstep_ae._ae_loss_fn(jax_model(), True, 2.0, 6.0, True, 0.5, opacity_loss=opacity_loss,
                                   photometric=photometric)
    sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, 0))
    jbatch = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in bufs.items()}, sample_key, B, src_hw=WH[::-1])
    (want_loss, want_parts), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, render_key)

    draws = jax_step_draws(base_key, 0, draw_shape(bufs))
    batch = tstep.sample_multi_batch({k: torch.from_numpy(v) for k, v in bufs.items()}, draws, B, src_hw=WH[::-1])
    named = dict(model.named_parameters())
    loss, parts, grads = tstep_ae.ae_loss_and_grads(model, named, batch, draws, True, True, 2.0, 6.0, 0.5,
                                                    opacity_loss=opacity_loss, photometric=photometric)
    assert not draws.arrays  # every draw consumed, in JAX's order
    got_parts = dict(zip(PARTS_RTOL, (loss, *parts)))
    for (k, rtol), w in zip(PARTS_RTOL.items(), (want_loss, *want_parts)):
        np.testing.assert_allclose(got_parts[k].item(), float(w), rtol=rtol, err_msg=k)
    for k, w in zip(("loss0", "loss1"), want_parts):  # as the step reports them
        np.testing.assert_allclose(mse2psnr(got_parts[k]).item(), float(jax_mse2psnr(w)), atol=PSNR_ATOL, rtol=0)
    got, want = port_leaves(model, grads), jax_leaves(jax.device_get(want_g))
    assert set(got) == set(want) == set(named)
    for name, w in want.items():
        tol = max(1e-4, 2 * FP32_SPREAD.get(_group(name), 0.0))
        scale = np.abs(w).max() + 1e-30
        err = np.abs(got[name] - w).max() / scale
        fro = np.linalg.norm(got[name] - w) / (np.linalg.norm(w) + 1e-30)
        assert err <= tol and fro <= FRO_TOL, (name, err, tol, fro)
    # the degree embedding gets a gradient in the batch's degree row only
    row = int(round(np.rad2deg(float(jbatch["deg"]))))
    table = got["deg_embedding.weight"]
    assert np.abs(np.delete(table, row, axis=0)).max() == 0 < np.abs(table[row]).max()
