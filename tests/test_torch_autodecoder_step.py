"""Port parity: whole auto-decoder train steps of aonerf_torch against
aonerf's ``make_autodecoder_device_train_step``, on a 16x12 multi scene at
the field's full width, fed the same random draws; and the port's
multi-step against single steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import CodeLibraryArticulated as JaxCodeLibrary
from aonerf.train import step as jstep
from aonerf.train.lr import log_lerp_lr as jax_lr
from aonerf_torch.data import sapien_multi as sm
from aonerf_torch.data import synthetic
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.models.codes import CodeLibraryArticulated
from aonerf_torch.train import step as tstep
from aonerf_torch.train.optim import OptState
from aonerf_torch.train.step import TrainState
from aonerf_torch.utils.bridge import (
    articulated_flax_tree,
    articulated_state_dict_from_flax,
    codes_flax_tree,
    codes_state_dict_from_flax,
)
from tests.test_torch_articulated import QueueDraws, jax_render_draws
from tests.test_torch_sapien_multi import jax_batch_draws

torch.set_num_threads(2)

B, SC, NF, WH = 16, 8, 8, (16, 12)
LR = 1e-3
SCHEDULE = dict(lr_init=LR, lr_final=1e-5, max_steps=1000, lr_delay_steps=0)
N_STEPS = 3


def jax_step_draws(base_key, step, shape):
    """Everything JAX's auto-decoder device step draws at ``step``: the ids
    and pixels, then the coarse jitter and the fine exponentials."""
    sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, step))
    return QueueDraws(jax_batch_draws(sample_key, *shape, B) + jax_render_draws(render_key, B, SC, NF))


def _leaves(tree):
    """{'model'|'codes'}/module/.../leaf -> float64 array."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            out[prefix] = np.asarray(node, np.float64)

    walk("", tree)
    return out


def _port_tree(model, lib, grads=False):
    return {"model": articulated_flax_tree(model, grads), "codes": codes_flax_tree(lib, grads)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = synthetic.generate_multi_scene(str(tmp_path_factory.mktemp("multi")), img_wh=WH, n_instances=2,
                                          degrees=(0, 10, 20), n_images=2)
    bufs = sm.SapienMultiDataset(root, split="train", img_wh=WH).device_buffers()
    jmodel = JaxArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True)
    jlib = JaxCodeLibrary()
    key = jax.random.PRNGKey(0)
    codes = jlib.init(key, jnp.asarray(0), jnp.asarray(0))
    lat = {k: jnp.atleast_2d(v) for k, v in jlib.apply(codes, jnp.asarray(0), jnp.asarray(0)).items()}
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 8)
    model = jmodel.init(key, {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d}, False, True, 2.0, 6.0, lat)
    params = jax.device_get({"model": model, "codes": codes})
    tx = jstep.make_adam(**SCHEDULE)
    jfn = jstep.make_autodecoder_device_train_step(
        jmodel, jlib, tx, True, 2.0, 6.0, batch_size=B, donate=False, lr_fn=functools.partial(jax_lr, **SCHEDULE)
    )
    base_key = jax.random.PRNGKey(5)
    jbuf = {k: jnp.asarray(v) for k, v in bufs.items()}
    jstate = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    trajectory = []  # (state before the step, its metrics, params after it)
    for s in range(N_STEPS):
        before = jax.device_get(jstate)
        jstate, m = jfn(jstate, jbuf, base_key)
        trajectory.append((before, {k: float(v) for k, v in m.items()}, jax.device_get(jstate.params)))
    return {"bufs": bufs, "params": params, "base_key": base_key, "trajectory": trajectory,
            "jmodel": jmodel, "jlib": jlib}


def _flax_leaf(tree, name):
    """The leaf of a {'model', 'codes'} flax tree for a port parameter name,
    in the port's layout."""
    group, *path, attr = name.split(".")
    node = tree[group]["params"]
    for k in path:
        node = node[k]
    if group == "codes":
        return np.asarray(node["embedding"])
    return np.asarray(node["kernel"]).T if attr == "weight" else np.asarray(node["bias"])


def _port_state_from_jax(jstate, state):
    """The port's TrainState of a JAX TrainState (step, params, Adam count
    and moments), written into the port's parameters."""
    adam = jstate.opt_state[0]
    names = list(state.params)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(torch.from_numpy(np.array(_flax_leaf(jstate.params, n))))
    moments = [[torch.from_numpy(np.array(_flax_leaf(tree, n))) for n in names] for tree in (adam.mu, adam.nu)]
    return TrainState(step=int(jstate.step), params=state.params,
                      opt_state=OptState(count=int(adam.count), slots={"mu": moments[0], "nu": moments[1]}))


def _port(params, bufs):
    model = ArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True, device="cpu")
    model.load_state_dict(articulated_state_dict_from_flax(params["model"]))
    lib = CodeLibraryArticulated(device="cpu")
    lib.load_state_dict(codes_state_dict_from_flax(params["codes"]))
    tx = tstep.make_adam(**SCHEDULE)
    state = tstep.create_train_state(nn.ModuleDict({"model": model, "codes": lib}), tx)
    return model, lib, tx, state, {k: torch.from_numpy(v) for k, v in bufs.items()}


# The first step's gradients in fp32 against the same in fp64 (the port's
# field and codes cast to fp64, same batch and draws): max abs error / max
# |fp64| of JAX's grads and of the port's, the larger, over the leaves of a
# layer or code table, rounded up. Listed are those above 1e-4; every other
# leaf (the density and rgb heads) is within 4.1e-5. Most layers are
# ill-conditioned in fp32 at 16 randomized rays: the warped point goes
# through sin(2^9 x), the last sample's distance of 1e10 multiplies a
# density within rounding of 0, and ReLU masks within rounding of 0 flip
# with the summation order.
FP32_SPREAD = {
    "embedding_instance_appearance": 9e-4, "embedding_instance_articulation": 4.8e-3,
    "embedding_instance_shape": 6.9e-3,
    "coarse_mlp/bottleneck": 1.3e-3, "coarse_mlp/deform_0": 6.9e-3, "coarse_mlp/deform_1": 5.2e-3,
    "coarse_mlp/deform_2": 9.7e-3, "coarse_mlp/deform_3": 6.5e-3, "coarse_mlp/deform_out": 1.1e-2,
    "coarse_mlp/pts_0": 4.8e-3, "coarse_mlp/pts_1": 5.6e-3, "coarse_mlp/pts_2": 1.8e-2, "coarse_mlp/pts_3": 2.7e-3,
    "coarse_mlp/pts_4": 2.2e-3, "coarse_mlp/pts_5": 2.9e-3, "coarse_mlp/pts_6": 2.6e-3, "coarse_mlp/pts_7": 1.5e-3,
    "coarse_mlp/views_0": 1.1e-3, "coarse_mlp/views_1": 1.2e-3, "coarse_mlp/views_2": 6.1e-4,
    "coarse_mlp/views_3": 2.8e-3,
    "fine_mlp/bottleneck": 8e-4, "fine_mlp/deform_0": 5.3e-3, "fine_mlp/deform_1": 5.3e-3, "fine_mlp/deform_2": 5.2e-3,
    "fine_mlp/deform_3": 6.1e-3, "fine_mlp/deform_out": 5.1e-3, "fine_mlp/pts_0": 8.6e-3, "fine_mlp/pts_1": 7.1e-3,
    "fine_mlp/pts_2": 1.3e-2, "fine_mlp/pts_3": 2.3e-3, "fine_mlp/pts_4": 1.5e-3, "fine_mlp/pts_5": 4e-3,
    "fine_mlp/pts_6": 2.1e-3, "fine_mlp/pts_7": 4.5e-3, "fine_mlp/views_0": 9.1e-4, "fine_mlp/views_1": 6.1e-4,
    "fine_mlp/views_2": 4.3e-4, "fine_mlp/views_3": 1.1e-3,
}


def test_first_step_grads_match_jax(setup):
    # The first step's loss and gradients, before either update, against
    # jax.value_and_grad of the same loss on the same batch and draws: the
    # loss to 1e-5 relative, each leaf's max abs error / max |JAX| at most
    # 1e-4, or, on a layer of FP32_SPREAD, twice its spread (each of the two
    # lies within the spread of the exact value).
    params, bufs, key = setup["params"], setup["bufs"], setup["base_key"]
    jmodel, jlib = setup["jmodel"], setup["jlib"]
    loss_fn = jstep._autodecoder_loss_fn(jmodel, jlib, True, 2.0, 6.0, True, 1e-4)
    sample_key, render_key = jax.random.split(jax.random.fold_in(key, 0))
    batch = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in bufs.items()}, sample_key, B)
    (want_loss, (_, _, want_reg)), want_g = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, render_key)

    model, lib, tx, state, tbuf = _port(params, bufs)
    draws = jax_step_draws(key, 0, bufs["c2w"].shape[:3] + (WH[0] * WH[1],))
    batch = tstep.sample_multi_batch(tbuf, draws, B)
    loss, (_, _, reg), grads = tstep.autodecoder_loss_and_grads(
        model, lib, state.params, batch, draws, True, True, 2.0, 6.0, 1e-4
    )
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(reg.item(), float(want_reg), rtol=1e-6)
    for p, g in zip(state.params.values(), grads):
        p.grad = g
    got, want = _leaves(_port_tree(model, lib, grads=True)), _leaves(jax.device_get(want_g))
    assert set(got) == set(want)
    for name, w in want.items():
        layer = name.rsplit("/", 1)[0].replace("model/params/", "").replace("codes/params/", "")
        tol = max(1e-4, 2 * FP32_SPREAD.get(layer, 0.0))
        err = np.max(np.abs(got[name] - w)) / (np.max(np.abs(w)) + 1e-30)
        assert err <= tol, (name, err, tol)
    # the code tables get gradients only in the sampled rows
    rows = [int(batch["instance_id"]), int(batch["articulation_id"])]
    for table, row in (("codes/params/embedding_instance_shape/embedding", rows[0]),
                       ("codes/params/embedding_instance_articulation/embedding", rows[1])):
        assert np.abs(np.delete(want[table], row, axis=0)).max() == 0 == np.abs(np.delete(got[table], row, axis=0)).max()


def test_train_steps_match_jax(setup):
    # Three steps run freely from the same start. Adam's first steps are
    # sign-like: a gradient entry near 0 whose sign differs moves its
    # parameter by up to 2 lr a step, codes included.
    params, bufs, key = setup["params"], setup["bufs"], setup["base_key"]
    model, lib, tx, state, tbuf = _port(params, bufs)
    step_fn = tstep.make_autodecoder_device_train_step(model, lib, tx, True, 2.0, 6.0, batch_size=B)
    shape = bufs["c2w"].shape[:3] + (WH[0] * WH[1],)
    for s, (_, jm, jparams) in enumerate(setup["trajectory"]):
        state, m = step_fn(state, tbuf, 0, draws=jax_step_draws(key, s, shape))
        if s == 0:  # from the same parameters, the metrics agree as in the next test
            np.testing.assert_allclose(m["loss"].item(), jm["loss"], rtol=1e-5)
        got, want = _leaves(_port_tree(model, lib)), _leaves(jparams)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=2 * LR * (s + 1), rtol=0, err_msg=f"step {s}: {name}")
    assert state.step == N_STEPS and state.opt_state.count == N_STEPS


@pytest.mark.parametrize("s", range(N_STEPS))
def test_each_step_from_the_jax_state_matches(setup, s):
    # The port restarted from JAX's state before step s (parameters, codes,
    # Adam count and moments): the step's loss, its code regularization and
    # both PSNRs to 1e-5 relative (the metrics are computed before the
    # update), the lr to 1e-6, and the parameters after it within 2 lr.
    before, jm, jparams = setup["trajectory"][s]
    model, lib, tx, state, tbuf = _port(setup["params"], setup["bufs"])
    state = _port_state_from_jax(before, state)
    step_fn = tstep.make_autodecoder_device_train_step(model, lib, tx, True, 2.0, 6.0, batch_size=B)
    shape = setup["bufs"]["c2w"].shape[:3] + (WH[0] * WH[1],)
    state, m = step_fn(state, tbuf, 0, draws=jax_step_draws(setup["base_key"], s, shape))
    for k in ("loss", "loss_reg", "psnr0", "psnr1"):
        np.testing.assert_allclose(m[k].item(), jm[k], rtol=1e-5, err_msg=f"step {s} {k}")
    assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    assert state.step == s + 1 and state.opt_state.count == s + 1
    got, want = _leaves(_port_tree(model, lib)), _leaves(jparams)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=2 * LR, rtol=0, err_msg=f"step {s}: {name}")


def test_multi_step_equals_single_steps(setup):
    results = []
    for inner in (1, 2):
        model, lib, tx, state, tbuf = _port(setup["params"], setup["bufs"])
        fn = tstep.make_autodecoder_device_train_step(model, lib, tx, True, 2.0, 6.0, batch_size=B,
                                                      inner_steps=inner)
        for _ in range(2 // inner):
            state, m = fn(state, tbuf, 3)
        results.append((state.step, m["loss"].item(), [p.detach().clone() for p in state.params.values()]))
    assert results[0][0] == results[1][0] == 2
    assert results[0][1] == results[1][1]
    for a, b in zip(results[0][2], results[1][2]):
        assert torch.equal(a, b)
