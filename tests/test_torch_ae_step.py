"""Port parity: whole auto-encoder train steps of aonerf_torch against
aonerf's ``make_ae_device_train_step`` (one view and one encode a step), on
a 64x48 multi scene at the published widths (ResNet34 encoder, 8x256 field)
with 8 + 8 samples, fed the same random draws; the source image of
``sample_multi_batch``; the port's multi-step against single steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models.ae import AutoEncoderArticulatedNeRF as JaxAE
from aonerf.train import step as jstep
from aonerf.train import step_ae as jstep_ae
from aonerf.train.lr import log_lerp_lr as jax_lr
from aonerf_torch.data import sapien_multi as sm
from aonerf_torch.data import synthetic
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.train import step as tstep
from aonerf_torch.train import step_ae as tstep_ae
from aonerf_torch.train.optim import OptState
from aonerf_torch.train.step import TrainState
from aonerf_torch.utils.bridge import module_flax_tree, module_state_dict_from_flax
from tests.test_torch_articulated import QueueDraws, jax_render_draws
from tests.test_torch_sapien_multi import jax_batch_draws
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

B, SC, NF, WH = 16, 8, 8, (64, 48)
LR = 1e-3
SCHEDULE = dict(lr_init=LR, lr_final=1e-5, max_steps=1000, lr_delay_steps=0)
N_STEPS = 2

# The first step's loss parts in fp32 against the port in fp64 (same batch
# and draws), relative, the larger of JAX's and the port's over the
# photometric/opacity variants tested: loss 4.1e-5, each level's photometric
# loss 3.6e-5, loss_state 1.6e-4 (JAX's; the port's 2.8e-5), opacity loss
# 1.4e-5. Held at about twice that; the PSNRs, 10 log10 of the photometric
# losses, within 5e-4 dB.
METRIC_RTOL = {"loss": 1e-4, "loss_state": 4e-4, "opacity_loss": 5e-5}
PSNR_ATOL = 5e-4


def jax_step_draws(base_key, step, shape):
    """Everything JAX's AE device step draws at ``step``: the ids and pixels,
    then the coarse jitter and the fine exponentials (the encoder draws
    nothing)."""
    sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, step))
    return QueueDraws(jax_batch_draws(sample_key, *shape, B) + jax_render_draws(render_key, B, SC, NF))


def scene_buffers(root):
    root = synthetic.generate_multi_scene(str(root), img_wh=WH, n_instances=2, degrees=(0, 10, 20), n_images=2)
    return sm.SapienMultiDataset(root, split="train", img_wh=WH).device_buffers()


def draw_shape(bufs):
    return bufs["c2w"].shape[:3] + (WH[0] * WH[1],)


def jax_model():
    return JaxAE(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True)


def port_model(params=None):
    """The port's AE from seed 0, or with the flax tree ``params``."""
    model = AutoEncoderArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=True,
                                       generator=torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        model.load_state_dict(module_state_dict_from_flax(params))
    return model


def port_leaves(model, grads=None):
    """name -> fp64 array of the port's parameters, or of ``grads`` (in the
    parameters' order)."""
    names = [n for n, _ in model.named_parameters()]
    values = grads if grads is not None else [p.detach() for _, p in model.named_parameters()]
    return {n: np.asarray(v, np.float64) for n, v in zip(names, values)}


def jax_leaves(tree):
    """name -> fp64 array of a flax AE tree, in the port's names and layout."""
    return {n: v.numpy().astype(np.float64) for n, v in module_state_dict_from_flax(tree).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    bufs = scene_buffers(tmp_path_factory.mktemp("multi"))
    params = module_flax_tree(port_model())
    tx = jstep.make_adam(**SCHEDULE)
    jfn = jstep_ae.make_ae_device_train_step(
        jax_model(), tx, True, 2.0, 6.0, img_wh=WH, batch_size=B, donate=False,
        lr_fn=functools.partial(jax_lr, **SCHEDULE),
    )
    base_key = jax.random.PRNGKey(5)
    jbuf = {k: jnp.asarray(v) for k, v in bufs.items()}
    jstate = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    trajectory = []  # (state before the step, its metrics, params after it)
    for _ in range(N_STEPS):
        before = jax.device_get(jstate)
        jstate, m = jfn(jstate, jbuf, base_key)
        trajectory.append((before, {k: float(v) for k, v in m.items()}, jax.device_get(jstate.params)))
    return {"bufs": bufs, "params": params, "base_key": base_key, "trajectory": trajectory}


def _port(params, bufs):
    model = port_model(params)
    tx = tstep.make_adam(**SCHEDULE)
    state = tstep.create_train_state(model, tx)
    return model, tx, state, {k: torch.from_numpy(v) for k, v in bufs.items()}


def _port_state_from_jax(jstate, state):
    """The port's TrainState of a JAX TrainState (step, parameters, Adam
    count and moments), written into the port's parameters."""
    adam = jstate.opt_state[0]
    with torch.no_grad():
        for n, v in module_state_dict_from_flax(jstate.params).items():
            state.params[n].copy_(v)
    mu, nu = (module_state_dict_from_flax(t) for t in (adam.mu, adam.nu))
    return TrainState(step=int(jstate.step), params=state.params,
                      opt_state=OptState(count=int(adam.count), slots={"mu": [mu[n] for n in state.params],
                                                                       "nu": [nu[n] for n in state.params]}))


def check_metrics(got, want, what):
    for k, rtol in METRIC_RTOL.items():
        np.testing.assert_allclose(got[k].item(), want[k], rtol=rtol, err_msg=f"{what} {k}")
    for k in ("psnr0", "psnr1"):
        np.testing.assert_allclose(got[k].item(), want[k], atol=PSNR_ATOL, rtol=0, err_msg=f"{what} {k}")
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)


@pytest.mark.parametrize("s", range(N_STEPS))
def test_each_step_from_the_jax_state_matches(setup, s):
    # The port restarted from JAX's state before step s (encoder, field,
    # state decoder and degree embedding, Adam count and moments): the
    # step's metrics (computed before the update) within METRIC_RTOL, the lr
    # to 1e-6, and every parameter after it within 2 lr (Adam's first steps
    # are sign-like: an entry whose gradient is near 0 in fp32 may move the
    # other way).
    before, jm, jparams = setup["trajectory"][s]
    model, tx, state, tbuf = _port(setup["params"], setup["bufs"])
    state = _port_state_from_jax(before, state)
    step_fn = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B)
    state, m = step_fn(state, tbuf, 0, draws=jax_step_draws(setup["base_key"], s, draw_shape(setup["bufs"])))
    assert set(m) == set(jm) == {"loss", "loss_state", "opacity_loss", "psnr0", "psnr1", "lr"}
    check_metrics(m, jm, f"step {s}")
    assert state.step == s + 1 and state.opt_state.count == s + 1
    got, want = port_leaves(model), jax_leaves(jparams)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=2 * LR, rtol=0, err_msg=f"step {s}: {name}")


def test_train_steps_match_jax(setup):
    # Two steps run freely from the same start: each parameter within 2 lr
    # a step of JAX's
    model, tx, state, tbuf = _port(setup["params"], setup["bufs"])
    step_fn = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B)
    for s, (_, jm, jparams) in enumerate(setup["trajectory"]):
        state, m = step_fn(state, tbuf, 0, draws=jax_step_draws(setup["base_key"], s, draw_shape(setup["bufs"])))
        if s == 0:
            check_metrics(m, jm, "step 0")
        got, want = port_leaves(model), jax_leaves(jparams)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=2 * LR * (s + 1), rtol=0, err_msg=f"step {s}: {name}")
    assert state.step == N_STEPS and state.opt_state.count == N_STEPS


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_multi_batch_src_imgs_match_jax(setup, seed):
    # the sampled view as the encoder's (3, h, w) [-1, 1] image: JAX's bits,
    # and the dataset's normalized_image of that view within 1 ulp
    bufs = setup["bufs"]
    key = jax.random.PRNGKey(seed)
    want = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in bufs.items()}, key, 8, src_hw=WH[::-1])
    ids = jax_batch_draws(key, *draw_shape(bufs), 8)
    tbuf = {k: torch.from_numpy(v) for k, v in bufs.items()}
    got = tstep.sample_multi_batch(tbuf, QueueDraws(ids), 8, src_hw=WH[::-1])
    assert set(got) == set(want) and got["src_imgs"].shape == (3, WH[1], WH[0])
    np.testing.assert_array_equal(got["src_imgs"].numpy(), np.asarray(want["src_imgs"]))
    ii, di, vi = (int(a) for a in ids[:3])
    view = sm._View(c2w=bufs["c2w"][ii, di, vi], rgb=bufs["rgb"][ii, di, vi].reshape(WH[1], WH[0], 3),
                    mask=bufs["mask"][ii, di, vi].reshape(WH[1], WH[0]).astype(bool))
    np.testing.assert_allclose(sm.SapienMultiDataset.normalized_image(view), got["src_imgs"].numpy(),
                               atol=1.2e-7, rtol=0)
    assert "src_imgs" not in tstep.sample_multi_batch(tbuf, QueueDraws(ids), 8)


def test_multi_step_equals_single_steps(setup):
    results = []
    for inner in (1, 2):
        model, tx, state, tbuf = _port(setup["params"], setup["bufs"])
        fn = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B,
                                                inner_steps=inner)
        for _ in range(2 // inner):
            state, m = fn(state, tbuf, 3)
        results.append((state.step, m["loss"].item(), [p.detach().clone() for p in state.params.values()]))
    assert results[0][0] == results[1][0] == 2
    assert results[0][1] == results[1][1]
    for a, b in zip(results[0][2], results[1][2]):
        assert torch.equal(a, b)


def test_ae_step_refuses_what_is_not_ported():
    model = port_model()
    tx = tstep.make_adam(**SCHEDULE)
    # several views a step and one encode for several steps run; JAX's three
    # ValueErrors guard them
    assert callable(tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, encode_reuse=2,
                                                       inner_steps=4))
    for kwargs, match in (({"views_per_step": 3}, "divisible"), ({"encode_reuse": 2}, "multiple"),
                          ({"encode_reuse": 4, "inner_steps": 6}, "multiple"),
                          ({"views_per_step": 2, "encode_reuse": 2}, "alternative")):
        with pytest.raises(ValueError, match=match):
            tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, **kwargs)
    with pytest.raises(KeyError):
        tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, opacity_loss="focal")
