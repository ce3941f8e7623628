"""Port parity: the data-parallel train steps on 2 gloo ranks against
aonerf's on a 2-device mesh of conftest's host devices, fed the same draws.

  vanilla:      ``make_vanilla_train_step`` with the batch's rays over the
                mesh; the port's ranks each take their rows of the whole
                batch's draws (JAX's, of ``fold_in(base_key, 0)``)
  auto-decoder: ``make_autodecoder_device_train_step(mesh=, sharded_views=)``
                with replicated and with view-sharded buffers (3 views over
                2 ranks: the cyclic pad); rank d draws what JAX's device d
                draws from ``fold_in(fold_in(base_key, 0), d)``, from its
                local view slice when sharded; and the host-batched
                ``make_autodecoder_train_step`` on one batch given to every
                rank against JAX's on one device
  auto-encoder: ``make_ae_device_train_step(mesh=, sharded_views=)`` the
                same way, each rank encoding its own view; and the
                host-batched ``make_ae_train_step`` on one batch given to
                every rank (its rows split over them, the masked
                photometric loss over the whole batch's foreground) against
                JAX's on one device; one encode-reuse group (a full step,
                then a field-only step) on view-sharded buffers, held to the
                ranks' own contributions only

Both sides run with an optimizer that keeps the gradients it is given
(all-reduced) and moves nothing, so the gradients themselves are compared,
by the rule of ``tests/test_torch_train.py``,
``tests/test_torch_autodecoder_step.py`` and ``tests/test_torch_ae_grads.py``:
each leaf's max abs error / max |JAX| at most max(1e-4, twice its layer's
fp32 spread at these batches, DDP_SPREAD), ||error|| / ||JAX|| at most the
auto-encoder file's FRO_TOL, the loss parts within LOSS_RTOL. Both ranks
hold the same gradients bit for bit, and those are the sum of what each rank
computes alone (its rows' weighted share, or its average share).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import CodeLibraryArticulated as JaxCodeLibrary
from aonerf.parallel import make_mesh, replicated_sharding, shard_batch, shard_multi_buffers
from aonerf.train import step as jstep
from aonerf.train import step_ae as jstep_ae
from aonerf_torch.data import sapien_multi as sm
from aonerf_torch.data import synthetic
from aonerf_torch.train import step as tstep
from aonerf_torch.utils.bridge import module_flax_tree, module_state_dict_from_flax
from tests import test_torch_ae_grads as ae_grads
from tests import test_torch_autodecoder_step as ad_step
from tests import test_torch_train as vanilla
from tests.test_torch_articulated import jax_render_draws
from tests.test_torch_ae_step import WH as AE_WH
from tests.test_torch_ae_step import jax_model, port_model, scene_buffers
from tests.test_torch_sapien_multi import jax_batch_draws
from tests import torch_ddp_worker as worker
from tests.torch_ddp_worker import run_ranks
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WORLD = 2
LOSS_PARTS = ("loss", "loss_reg", "loss_state", "opacity_loss")  # sums over the ranks
JAX_CASES = ("vanilla", "autodecoder_replicated", "autodecoder_sharded", "autodecoder_host", "ae_replicated",
             "ae_sharded", "ae_host")
CASES = JAX_CASES + ("ae_reuse",)
B, SC, NF = 16, 8, 8  # the articulated steps' rays a rank and samples
AD_WH = (16, 12)
BASE_KEY = 5
VANILLA_B = 32


# Each case's gradients in fp32 against the port's in fp64 (the same
# batches and draws, each rank's contribution summed; the vanilla levels
# through the plain versions): max abs error / max |fp64| of JAX's 2-device
# step and of the port's 2-rank step, the larger, over the leaves of a layer
# or stage, rounded up at 2 significant digits (tools/torch_ddp_spreads.py).
# Listed are those above 5e-5; every other leaf is within 4.9e-5. The
# ill-conditioning is the one the one-device files state: sin(2^9 x) of the
# (warped) points, densities within rounding of 0 times the last sample's
# 1e10 distance, ReLU masks that flip with the summation order, and the
# encoder's layer4 ReLUs (tests/test_torch_ae_grads.py).
DDP_SPREAD = {
    "vanilla": {
        "coarse_mlp.pts_0": 0.0023, "coarse_mlp.pts_1": 0.0033, "coarse_mlp.pts_2": 0.0058,
        "coarse_mlp.pts_3": 0.00092, "coarse_mlp.pts_4": 0.0068, "fine_mlp.bottleneck": 0.00037,
        "fine_mlp.density": 0.00022, "fine_mlp.pts_0": 0.011, "fine_mlp.pts_1": 0.033, "fine_mlp.pts_2": 0.0074,
        "fine_mlp.pts_3": 0.034, "fine_mlp.pts_4": 0.0026, "fine_mlp.pts_5": 0.002, "fine_mlp.pts_6": 0.0089,
        "fine_mlp.pts_7": 0.0023, "fine_mlp.views_0": 0.0024,
    },
    "autodecoder_replicated": {
        "coarse_mlp.bottleneck": 0.00097, "coarse_mlp.deform_0": 0.0043, "coarse_mlp.deform_1": 0.0035,
        "coarse_mlp.deform_2": 0.0037, "coarse_mlp.deform_3": 0.0033, "coarse_mlp.deform_out": 0.0035,
        "coarse_mlp.density": 0.00013, "coarse_mlp.pts_0": 0.008, "coarse_mlp.pts_1": 0.0095,
        "coarse_mlp.pts_2": 0.029, "coarse_mlp.pts_3": 0.0028, "coarse_mlp.pts_4": 0.0022,
        "coarse_mlp.pts_5": 0.0029, "coarse_mlp.pts_6": 0.0021, "coarse_mlp.pts_7": 0.0019,
        "coarse_mlp.views_0": 0.0033, "coarse_mlp.views_1": 0.00023, "coarse_mlp.views_2": 0.0011,
        "embedding_instance_appearance": 0.0014, "embedding_instance_articulation": 0.021,
        "embedding_instance_shape": 0.028, "fine_mlp.bottleneck": 0.0018, "fine_mlp.deform_0": 0.065,
        "fine_mlp.deform_1": 0.048, "fine_mlp.deform_2": 0.081, "fine_mlp.deform_3": 0.051,
        "fine_mlp.deform_out": 0.069, "fine_mlp.pts_0": 0.022, "fine_mlp.pts_1": 0.032, "fine_mlp.pts_2": 0.02,
        "fine_mlp.pts_3": 0.018, "fine_mlp.pts_4": 0.011, "fine_mlp.pts_5": 0.016, "fine_mlp.pts_6": 0.012,
        "fine_mlp.pts_7": 0.049, "fine_mlp.views_0": 0.0017, "fine_mlp.views_1": 0.0046,
        "fine_mlp.views_2": 0.00075, "fine_mlp.views_3": 0.0022,
    },
    "autodecoder_sharded": {
        "coarse_mlp.deform_0": 0.014, "coarse_mlp.deform_1": 0.0093, "coarse_mlp.deform_2": 0.014,
        "coarse_mlp.deform_3": 0.011, "coarse_mlp.deform_out": 0.0094, "coarse_mlp.pts_0": 0.014,
        "coarse_mlp.pts_1": 0.016, "coarse_mlp.pts_2": 0.012, "coarse_mlp.pts_3": 0.013,
        "coarse_mlp.pts_4": 0.0069, "coarse_mlp.pts_5": 0.013, "coarse_mlp.pts_6": 0.0049,
        "coarse_mlp.pts_7": 0.015, "embedding_instance_appearance": 0.00037,
        "embedding_instance_articulation": 0.011, "embedding_instance_shape": 0.0081,
        "fine_mlp.bottleneck": 0.00033, "fine_mlp.deform_0": 0.0039, "fine_mlp.deform_1": 0.0034,
        "fine_mlp.deform_2": 0.0036, "fine_mlp.deform_3": 0.0047, "fine_mlp.deform_out": 0.0089,
        "fine_mlp.density": 0.00019, "fine_mlp.pts_0": 0.019, "fine_mlp.pts_1": 0.017, "fine_mlp.pts_2": 0.067,
        "fine_mlp.pts_3": 0.0023, "fine_mlp.pts_4": 0.0062, "fine_mlp.pts_5": 0.0042, "fine_mlp.pts_6": 0.00056,
        "fine_mlp.pts_7": 0.00069, "fine_mlp.views_0": 0.00071, "fine_mlp.views_1": 0.00022,
        "fine_mlp.views_2": 0.00083, "fine_mlp.views_3": 0.00012,
    },
    "autodecoder_host": {
        "coarse_mlp.bottleneck": 0.00011, "coarse_mlp.deform_0": 0.00096, "coarse_mlp.deform_1": 0.0011,
        "coarse_mlp.deform_2": 0.0015, "coarse_mlp.deform_3": 0.00086, "coarse_mlp.deform_out": 0.0011,
        "coarse_mlp.pts_0": 0.011, "coarse_mlp.pts_1": 0.023, "coarse_mlp.pts_2": 0.04,
        "coarse_mlp.pts_3": 0.00076, "coarse_mlp.pts_4": 0.0014, "coarse_mlp.pts_5": 0.00027,
        "coarse_mlp.pts_6": 0.0017, "coarse_mlp.pts_7": 7.6e-05, "coarse_mlp.views_1": 0.00026,
        "embedding_instance_appearance": 0.00041, "embedding_instance_articulation": 0.0054,
        "embedding_instance_shape": 0.0046, "fine_mlp.bottleneck": 0.00081, "fine_mlp.deform_0": 0.014,
        "fine_mlp.deform_1": 0.011, "fine_mlp.deform_2": 0.019, "fine_mlp.deform_3": 0.0098,
        "fine_mlp.deform_out": 0.0075, "fine_mlp.density": 5.3e-05, "fine_mlp.pts_0": 0.006,
        "fine_mlp.pts_1": 0.0048, "fine_mlp.pts_2": 0.0041, "fine_mlp.pts_3": 0.0045, "fine_mlp.pts_4": 0.0033,
        "fine_mlp.pts_5": 0.003, "fine_mlp.pts_6": 0.0065, "fine_mlp.pts_7": 0.0026, "fine_mlp.views_0": 0.00076,
        "fine_mlp.views_1": 0.00075, "fine_mlp.views_2": 0.00049, "fine_mlp.views_3": 0.0015,
    },
    "ae_replicated": {
        "coarse_mlp.bottleneck": 0.0054, "coarse_mlp.deform_0": 0.029, "coarse_mlp.deform_1": 0.028,
        "coarse_mlp.deform_2": 0.049, "coarse_mlp.deform_3": 0.022, "coarse_mlp.deform_out": 0.016,
        "coarse_mlp.density": 8.6e-05, "coarse_mlp.pts_0": 0.014, "coarse_mlp.pts_1": 0.0097,
        "coarse_mlp.pts_2": 0.011, "coarse_mlp.pts_3": 0.0079, "coarse_mlp.pts_4": 0.0068,
        "coarse_mlp.pts_5": 0.0099, "coarse_mlp.pts_6": 0.0055, "coarse_mlp.pts_7": 0.0066,
        "coarse_mlp.views_0": 0.0045, "coarse_mlp.views_1": 0.0033, "coarse_mlp.views_2": 0.013,
        "coarse_mlp.views_3": 5.3e-05, "deg_embedding": 0.08, "encoder.articulation_fc": 0.00016,
        "encoder.articulation_layer4": 0.37, "encoder.color_fc": 0.0035, "encoder.color_layer4": 0.077,
        "encoder.conv1": 0.055, "encoder.density_fc": 0.036, "encoder.density_layer4": 0.17,
        "encoder.layer1": 0.074, "encoder.layer2": 0.072, "encoder.layer3": 0.078, "fine_mlp.bottleneck": 0.0027,
        "fine_mlp.deform_0": 0.055, "fine_mlp.deform_1": 0.052, "fine_mlp.deform_2": 0.039,
        "fine_mlp.deform_3": 0.047, "fine_mlp.deform_out": 0.066, "fine_mlp.density": 0.00026,
        "fine_mlp.pts_0": 0.0098, "fine_mlp.pts_1": 0.0082, "fine_mlp.pts_2": 0.011, "fine_mlp.pts_3": 0.0096,
        "fine_mlp.pts_4": 0.0067, "fine_mlp.pts_5": 0.0058, "fine_mlp.pts_6": 0.0069, "fine_mlp.pts_7": 0.0069,
        "fine_mlp.rgb": 0.00013, "fine_mlp.views_0": 0.0028, "fine_mlp.views_1": 0.0083,
        "fine_mlp.views_2": 0.0021, "fine_mlp.views_3": 0.0026, "joint_state_decoder.Dense_1": 6.4e-05,
        "joint_state_decoder.Dense_2": 5.8e-05,
    },
    "ae_sharded": {
        "coarse_mlp.bottleneck": 0.0063, "coarse_mlp.deform_0": 0.076, "coarse_mlp.deform_1": 0.055,
        "coarse_mlp.deform_2": 0.059, "coarse_mlp.deform_3": 0.077, "coarse_mlp.deform_out": 0.062,
        "coarse_mlp.pts_0": 0.011, "coarse_mlp.pts_1": 0.012, "coarse_mlp.pts_2": 0.0091,
        "coarse_mlp.pts_3": 0.0074, "coarse_mlp.pts_4": 0.0066, "coarse_mlp.pts_5": 0.0094,
        "coarse_mlp.pts_6": 0.011, "coarse_mlp.pts_7": 0.0065, "coarse_mlp.views_0": 0.0045,
        "coarse_mlp.views_1": 0.0039, "coarse_mlp.views_2": 0.013, "deg_embedding": 0.09,
        "encoder.articulation_fc": 0.00018, "encoder.articulation_layer4": 0.4, "encoder.color_fc": 0.0097,
        "encoder.color_layer4": 0.13, "encoder.conv1": 0.059, "encoder.density_fc": 0.068,
        "encoder.density_layer4": 0.081, "encoder.layer1": 0.064, "encoder.layer2": 0.08, "encoder.layer3": 0.086,
        "fine_mlp.bottleneck": 0.015, "fine_mlp.deform_0": 0.039, "fine_mlp.deform_1": 0.037,
        "fine_mlp.deform_2": 0.021, "fine_mlp.deform_3": 0.019, "fine_mlp.deform_out": 0.012,
        "fine_mlp.density": 0.00023, "fine_mlp.pts_0": 0.011, "fine_mlp.pts_1": 0.011, "fine_mlp.pts_2": 0.0094,
        "fine_mlp.pts_3": 0.0074, "fine_mlp.pts_4": 0.0059, "fine_mlp.pts_5": 0.0047, "fine_mlp.pts_6": 0.0084,
        "fine_mlp.pts_7": 0.0074, "fine_mlp.rgb": 8e-05, "fine_mlp.views_0": 0.015, "fine_mlp.views_1": 0.0078,
        "fine_mlp.views_2": 0.021, "fine_mlp.views_3": 0.0025, "joint_state_decoder.Dense_0": 5.5e-05,
        "joint_state_decoder.Dense_1": 8e-05, "joint_state_decoder.Dense_2": 5.3e-05,
    },
    "ae_host": {
        "coarse_mlp.bottleneck": 0.002, "coarse_mlp.deform_0": 0.065, "coarse_mlp.deform_1": 0.068,
        "coarse_mlp.deform_2": 0.07, "coarse_mlp.deform_3": 0.084, "coarse_mlp.deform_out": 0.055,
        "coarse_mlp.density": 8.2e-05, "coarse_mlp.pts_0": 0.011, "coarse_mlp.pts_1": 0.01,
        "coarse_mlp.pts_2": 0.014, "coarse_mlp.pts_3": 0.013, "coarse_mlp.pts_4": 0.0095,
        "coarse_mlp.pts_5": 0.0062, "coarse_mlp.pts_6": 0.0062, "coarse_mlp.pts_7": 0.013,
        "coarse_mlp.views_0": 0.0013, "coarse_mlp.views_1": 0.0052, "coarse_mlp.views_2": 0.0037,
        "coarse_mlp.views_3": 8.2e-05, "deg_embedding": 0.053, "encoder.articulation_fc": 0.00011,
        "encoder.articulation_layer4": 0.046, "encoder.color_fc": 0.0022, "encoder.color_layer4": 0.0044,
        "encoder.conv1": 0.018, "encoder.density_fc": 0.035, "encoder.density_layer4": 0.056,
        "encoder.layer1": 0.044, "encoder.layer2": 0.04, "encoder.layer3": 0.05, "fine_mlp.bottleneck": 0.0037,
        "fine_mlp.deform_0": 0.042, "fine_mlp.deform_1": 0.032, "fine_mlp.deform_2": 0.027,
        "fine_mlp.deform_3": 0.028, "fine_mlp.deform_out": 0.015, "fine_mlp.density": 0.00039,
        "fine_mlp.pts_0": 0.022, "fine_mlp.pts_1": 0.012, "fine_mlp.pts_2": 0.015, "fine_mlp.pts_3": 0.014,
        "fine_mlp.pts_4": 0.013, "fine_mlp.pts_5": 0.0071, "fine_mlp.pts_6": 0.0058, "fine_mlp.pts_7": 0.0067,
        "fine_mlp.rgb": 0.0002, "fine_mlp.views_0": 0.0034, "fine_mlp.views_1": 0.012, "fine_mlp.views_2": 0.00073,
        "fine_mlp.views_3": 0.00013,
    },
}

# The loss parts' relative error against the port in fp64 (same tool), the
# larger of JAX's and the port's, held at twice that and at least 1e-6.
LOSS_RTOL = {
    "vanilla": {"loss": 1e-6},
    "autodecoder_replicated": {"loss": 1e-6, "loss_reg": 1e-6},
    "autodecoder_sharded": {"loss": 1e-6, "loss_reg": 1e-6},
    "autodecoder_host": {"loss": 1e-6, "loss_reg": 1e-6},
    "ae_replicated": {"loss": 6.7e-5, "loss_state": 8e-5, "opacity_loss": 7.6e-5},
    "ae_sharded": {"loss": 2.1e-5, "loss_state": 2.4e-4, "opacity_loss": 7.7e-6},
    "ae_host": {"loss": 1.4e-4, "loss_state": 2.3e-5, "opacity_loss": 1.7e-4},
}


def capture():
    """An optax transformation whose state is the last gradients it was
    given and whose update is zero."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _vanilla_draws():
    """What JAX's vanilla step 0 draws for the whole batch: the indices, the
    coarse jitter, the fine exponentials."""
    sample_key, render_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), 0))
    idx = np.array(jax.random.randint(sample_key, (VANILLA_B,), 0, vanilla.N_RAYS)).astype(np.int64)
    return [idx] + jax_render_draws(render_key, VANILLA_B, vanilla.SC, vanilla.NF)


def _mesh(devices):
    return make_mesh(n_data=WORLD, devices=devices[:WORLD])


def _port_names(tree, prefix):
    """A flax gradient tree as {port parameter name: array}; ``prefix`` a
    tuple names the auto-decoder's {'model', 'codes'} groups."""
    if isinstance(prefix, tuple):
        return {**_port_names(tree["model"], prefix[0]), **_port_names(tree["codes"], prefix[1])}
    return {n: t.numpy() for n, t in module_state_dict_from_flax(tree, prefix).items()}


def _jax_grads(step, params, buffers, mesh, prefix):
    state = jax.device_put(jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), capture()),
                           replicated_sharding(mesh))
    state, metrics = step(state, buffers, jax.random.PRNGKey(BASE_KEY))
    return _port_names(jax.device_get(state.opt_state), prefix), {k: float(v) for k, v in metrics.items()}


def rank_sum(kind, args, **extra):
    """The case run in this process once for each rank, the collectives
    left out (each rank's own weighted or averaged contribution), summed
    over the ranks: what the all-reduce gives."""
    from unittest import mock

    from aonerf_torch.parallel import distributed

    total = None
    for r in range(WORLD):
        with mock.patch.object(distributed, "world_size", lambda: WORLD), \
                mock.patch.object(distributed, "rank", lambda r=r: r), \
                mock.patch.object(distributed, "all_reduce_sum_", lambda tensors: None):
            res = worker.CASES[kind](**args, **extra)
        if total is None:
            total = res
        else:
            total["grads"] = {n: None if g is None else total["grads"][n] + g for n, g in res["grads"].items()}
            total["metrics"] = {k: v + res["metrics"][k] if k in LOSS_PARTS else v
                                for k, v in total["metrics"].items()}
    return total


def _rank_draws(shape, batch, render):
    """What each device of the mesh draws in the articulated DDP step 0:
    fold_in(fold_in(base_key, 0), d), its ids and pixels over ``shape``
    (its local buffers), then its render's."""
    key = jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), 0)
    out = []
    for d in range(WORLD):
        sample_key, render_key = jax.random.split(jax.random.fold_in(key, d))
        out.append(jax_batch_draws(sample_key, *shape, batch) + render(render_key))
    return out


def _check(got, want, tol_of, what, fro_tol=None):
    assert set(got) == set(want), what
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        tol = tol_of(name)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err <= tol, (what, name, err, tol)
        if fro_tol is not None:
            fro = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert fro <= fro_tol, (what, name, fro)


def _same_on_both_ranks(results, case):
    a, b = (r[case]["grads"] for r in results)
    for n in a:
        assert (a[n] is None and b[n] is None) or np.array_equal(a[n], b[n]), (case, n)
    assert results[0][case]["metrics"] == results[1][case]["metrics"], case


def build_cases(mktemp, devices):
    """Every case: [(name, worker kind, worker args)] and {name: (JAX's
    gradients by port name, JAX's metrics)}; ``mktemp(name)`` gives a new
    directory."""
    mesh = _mesh(devices)
    cases, want = [], {}

    # vanilla: test_torch_train's weights and buffers, the batch's rays over
    # the mesh, one fp32 ray tile (16 rays) a rank
    model, params, nerf, buffers = vanilla._setup()
    step = jstep.make_vanilla_train_step(model, capture(), True, 2.0, 6.0, batch_size=VANILLA_B, donate=False)
    want["vanilla"] = _jax_grads(step, params, shard_batch(mesh, buffers), mesh, "")
    cases.append(("vanilla", "vanilla_step", dict(
        state_dict=nerf.state_dict(), sc=vanilla.SC, nf=vanilla.NF, buffers=buffers, batch_size=VANILLA_B,
        draws=_vanilla_draws())))

    # the auto-decoder on 3 views a (instance, articulation)
    root = synthetic.generate_multi_scene(str(mktemp("multi")), img_wh=AD_WH, n_instances=2,
                                          degrees=(0, 10, 20), n_images=3)
    bufs = sm.SapienMultiDataset(root, split="train", img_wh=AD_WH).device_buffers()
    jmodel = JaxArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True)
    jlib = JaxCodeLibrary()
    k0 = jax.random.PRNGKey(0)
    codes = jlib.init(k0, jnp.asarray(0), jnp.asarray(0))
    lat = {k: jnp.atleast_2d(v) for k, v in jlib.apply(codes, jnp.asarray(0), jnp.asarray(0)).items()}
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 8)
    fields = jmodel.init(k0, {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d}, False, True, 2.0, 6.0, lat)
    ad_params = jax.device_get({"model": fields, "codes": codes})
    state_dict = {**module_state_dict_from_flax(ad_params["model"], "model."),
                  **module_state_dict_from_flax(ad_params["codes"], "codes.")}
    hw = AD_WH[0] * AD_WH[1]
    for sharded in (False, True):
        name = f"autodecoder_{'sharded' if sharded else 'replicated'}"
        step = jstep.make_autodecoder_device_train_step(jmodel, jlib, capture(), True, 2.0, 6.0, batch_size=B,
                                                        donate=False, mesh=mesh, sharded_views=sharded)
        placed = shard_multi_buffers(mesh, bufs) if sharded else jax.device_put(bufs, replicated_sharding(mesh))
        want[name] = _jax_grads(step, ad_params, placed, mesh, ("model.", "codes."))
        n_v = bufs["c2w"].shape[2]
        shape = bufs["c2w"].shape[:2] + (-(-n_v // WORLD) if sharded else n_v, hw)
        cases.append((name, "autodecoder_step", dict(
            state_dict=state_dict, sc=SC, nf=NF, buffers=bufs, batch_size=B, sharded=sharded,
            draws=_rank_draws(shape, B, lambda k: jax_render_draws(k, B, SC, NF)))))

    # the host-batched auto-decoder step: one batch of 2 x 16 rays over the ranks
    host_b = WORLD * B
    jbatch = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in bufs.items()}, jax.random.PRNGKey(9), host_b)
    step = jstep.make_autodecoder_train_step(jmodel, jlib, capture(), True, 2.0, 6.0, donate=False)
    state = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, ad_params), capture())
    state, metrics = step(state, jbatch, jax.random.PRNGKey(BASE_KEY))
    want["autodecoder_host"] = (_port_names(jax.device_get(state.opt_state), ("model.", "codes.")),
                                {k: float(v) for k, v in metrics.items()})
    cases.append(("autodecoder_host", "autodecoder_host_step", dict(
        state_dict=state_dict, sc=SC, nf=NF, batch={k: np.asarray(v) for k, v in jax.device_get(jbatch).items()},
        draws=jax_render_draws(jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), 0), host_b, SC, NF))))

    # the auto-encoder (the port's model from seed 0 on both sides) on 64x48
    ae_bufs = scene_buffers(mktemp("multi64"))
    ae_params = module_flax_tree(port_model())
    hw = AE_WH[0] * AE_WH[1]
    for sharded in (False, True):
        name = f"ae_{'sharded' if sharded else 'replicated'}"
        step = jstep_ae.make_ae_device_train_step(jax_model(), capture(), True, 2.0, 6.0, img_wh=AE_WH,
                                                  batch_size=B, donate=False, mesh=mesh, sharded_views=sharded)
        placed = (shard_multi_buffers(mesh, ae_bufs) if sharded
                  else jax.device_put(ae_bufs, replicated_sharding(mesh)))
        want[name] = _jax_grads(step, ae_params, placed, mesh, "")
        n_v = ae_bufs["c2w"].shape[2]
        shape = ae_bufs["c2w"].shape[:2] + (n_v // WORLD if sharded else n_v, hw)
        cases.append((name, "ae_step", dict(
            sc=SC, nf=NF, buffers=ae_bufs, img_wh=AE_WH, batch_size=B, sharded=sharded,
            draws=_rank_draws(shape, B, lambda k: jax_render_draws(k, B, SC, NF)))))

    # one encode-reuse group (a full step, a field-only step) on view-sharded
    # buffers, numbers of the port's own (no JAX counterpart is compared)
    rng = np.random.default_rng(11)
    local = ae_bufs["c2w"].shape[:2] + (ae_bufs["c2w"].shape[2] // WORLD,)

    def render(n):
        return [rng.uniform(size=(n, SC + 1)).astype(np.float32), rng.exponential(size=(n, NF + 1)).astype(np.float32)]

    reuse = [[[np.int64(rng.integers(0, k)) for k in local] + [rng.integers(0, hw, B)] + render(B),
              [rng.integers(0, hw, B)] + render(B)] for _ in range(WORLD)]
    cases.append(("ae_reuse", "ae_reuse_steps", dict(sc=SC, nf=NF, buffers=ae_bufs, img_wh=AE_WH, batch_size=B,
                                                     sharded=True, draws=reuse)))

    # the host-batched auto-encoder step: one batch of 2 x 16 rays over the ranks
    host_b = WORLD * B
    key = jax.random.PRNGKey(7)
    jbatch = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in ae_bufs.items()}, key, host_b,
                                      src_hw=AE_WH[::-1])
    batch = {k: np.asarray(v) for k, v in jax.device_get(jbatch).items()}
    step = jstep_ae.make_ae_train_step(jax_model(), capture(), True, 2.0, 6.0, donate=False, photometric="masked")
    state = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, ae_params), capture())
    state, metrics = step(state, jbatch, jax.random.PRNGKey(BASE_KEY))
    want["ae_host"] = (_port_names(jax.device_get(state.opt_state), ""), {k: float(v) for k, v in metrics.items()})
    render_key = jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), 0)
    cases.append(("ae_host", "ae_host_step", dict(sc=SC, nf=NF, batch=batch, photometric="masked",
                                                  draws=jax_render_draws(render_key, host_b, SC, NF))))

    return cases, want


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    """The JAX side of every case, the port's 2-rank run of all of them in
    one launch, and each case's sum of the ranks' own contributions
    computed in this process."""
    cases, want = build_cases(tmp_path_factory.mktemp, devices)
    got = run_ranks(cases, WORLD)
    local = {name: rank_sum(kind, args) for name, kind, args in cases}
    return want, got, local, cases


def group(name: str) -> str:
    """A parameter's layer or stage: coarse_mlp.pts_0, embedding_instance_shape,
    encoder.layer1 (the key of DDP_SPREAD)."""
    parts = name.split(".")
    if parts[0] == "encoder":
        return ".".join(parts[:2])
    return ".".join(p for p in parts[:-1] if p not in ("model", "codes", "field"))


@pytest.mark.parametrize("case", CASES)
def test_step_is_the_sum_of_the_ranks_contributions(setup, case):
    # The all-reduce adds each rank's own contribution (weighted by its rows,
    # or averaged) and nothing else: the two ranks' gradients equal bit for
    # bit the sum of what each rank computes alone, run in this process.
    _, got, local, _ = setup
    _same_on_both_ranks(got, case)
    for name, g in local[case]["grads"].items():
        assert (g is None) == (got[0][case]["grads"][name] is None), name
        if g is not None:
            np.testing.assert_array_equal(got[0][case]["grads"][name], g, err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_step_matches_jax_mesh(setup, case):
    # Against JAX's step on the 2-device mesh: the loss parts within
    # LOSS_RTOL, each gradient leaf within max(1e-4, twice its layer's
    # DDP_SPREAD) of JAX's largest entry and, as the auto-encoder's file
    # holds it, within FRO_TOL in norm.
    want, got, _, _ = setup
    jgrads, jm = want[case]
    res = got[0][case]
    for k, rtol in LOSS_RTOL[case].items():
        np.testing.assert_allclose(res["metrics"][k], jm[k], rtol=rtol, err_msg=f"{case} {k}")
    spread = DDP_SPREAD[case]
    _check({n: g for n, g in res["grads"].items() if g is not None}, jgrads,
           lambda n: max(1e-4, 2 * spread.get(group(n), 0.0)), case, fro_tol=ae_grads.FRO_TOL)


def test_rank_streams_differ_and_fold_keeps_one_rank():
    # a rank's stream is its own; one rank (fold None) draws what a plain step draws
    a = tstep.Draws.for_step(3, 7, "cpu", fold=0).uniform((4,))
    b = tstep.Draws.for_step(3, 7, "cpu", fold=1).uniform((4,))
    c = tstep.Draws.for_step(3, 7, "cpu").uniform((4,))
    d = tstep.Draws.for_step(3, 7, "cpu").uniform((4,))
    assert not torch.equal(a, b) and not torch.equal(a, c) and torch.equal(c, d)


def test_ragged_rows_over_three_ranks_are_the_one_device_step(setup):
    # Rows split unevenly: the vanilla batch of 64 over 3 ranks in whole ray
    # tiles (32, 16, 16 rows), the host-batched auto-encoder's 32 rays as
    # 11, 11, 10; weighted by their shares and summed, the gradients are the
    # one-rank step's but for the order of the sums over rows: each leaf
    # within 1e-5 of its largest entry (measured: 6.1e-7 for the vanilla
    # step), the loss within 1e-6.
    rng = np.random.default_rng(0)
    n, b = vanilla.N_RAYS, 64
    _, _, nerf, buffers = vanilla._setup()
    draws = [rng.integers(0, n, b).astype(np.int64), rng.uniform(size=(b, vanilla.SC + 1)).astype(np.float32),
             rng.exponential(size=(b, vanilla.NF + 1)).astype(np.float32)]
    host = [c for c in setup[3] if c[0] == "ae_host"]
    cases = [("vanilla", "vanilla_step", dict(state_dict=nerf.state_dict(), sc=vanilla.SC, nf=vanilla.NF,
                                              buffers=buffers, batch_size=b, draws=draws))] + host
    three, one = run_ranks(cases, 3), run_ranks(cases, 1)[0]
    for name, _, _ in cases:
        got, want = three[0][name], one[name]
        assert all(np.array_equal(r[name]["grads"][k], got["grads"][k]) for r in three for k in got["grads"])
        np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-6, err_msg=name)
        for k, w in want["grads"].items():
            err = np.abs(got["grads"][k] - w).max() / np.abs(w).max()
            assert err <= 1e-5, (name, k, err)
