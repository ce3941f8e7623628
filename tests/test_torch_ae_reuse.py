"""Port parity: one encode-reuse group of the auto-encoder (R = 3: a full
encode + field step on one sampled view, then two field-only steps on its
detached latents with fresh pixels) against aonerf's
``make_ae_device_train_step(encode_reuse=3)``, from the same weights and
Adam state and fed JAX's draws, on a 64x48 multi scene at the published
widths with 8 + 8 samples.

On both sides the frozen partition (encoder, joint-state decoder, degree
embedding) and its Adam moments leave the field-only steps bit for bit as
the first step left them, while the count advances. The group's metrics
are held as tests/test_torch_ae_step.py holds a step's (METRIC_RTOL; the
loss is the last field-only loss plus the first step's state loss), the
parameters after the group within 2 lr an update of JAX's (Adam's first
updates are sign-like: an entry whose gradient is near 0 in fp32 may move
the other way; tests/test_torch_ae_grads.py measures the gradients' fp32
spreads behind it)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aonerf.train import step as jstep
from aonerf.train import step_ae as jstep_ae
from aonerf.train.lr import log_lerp_lr as jax_lr
from aonerf_torch.train import step as tstep
from aonerf_torch.train import step_ae as tstep_ae
from aonerf_torch.utils.bridge import module_flax_tree, module_state_dict_from_flax, opt_state_from_optax
from tests.test_torch_ae_step import (
    LR,
    METRIC_RTOL,
    PSNR_ATOL,
    SCHEDULE,
    WH,
    B,
    jax_leaves,
    jax_model,
    port_leaves,
    port_model,
    scene_buffers,
)
from tests.test_torch_articulated import NF, SC, QueueDraws, jax_render_draws
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

R = 3
HW = WH[0] * WH[1]


def jax_group_draws(base_key, step, first: bool, shape):
    """What JAX's encode-reuse group draws at ``step``: on its first step the
    view's ids (from k_view) and pixels (k_pix), on a field-only step the
    pixels; then the render's jitter and exponentials."""
    sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, step))
    if first:
        k_view, k_pix = jax.random.split(sample_key)
        ids = [np.array(jax.random.randint(k, (), 0, n)) for k, n in zip(jax.random.split(k_view, 3), shape)]
    else:
        ids, k_pix = [], sample_key
    pix = [np.array(jax.random.randint(k_pix, (B,), 0, HW))]
    assert SC == 8 and NF == 8
    return QueueDraws(ids + pix + jax_render_draws(render_key, B))


def _frozen(names):
    return [n for n in names if n.split(".")[0] != "field"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    bufs = scene_buffers(tmp_path_factory.mktemp("multi"))
    params = module_flax_tree(port_model())
    tx = jstep.make_adam(**SCHEDULE)
    lr_fn = functools.partial(jax_lr, **SCHEDULE)
    model = jax_model()
    base_key = jax.random.PRNGKey(7)
    jbuf = {k: jnp.asarray(v) for k, v in bufs.items()}
    state0 = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    group = jstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B, donate=False,
                                               lr_fn=lr_fn, inner_steps=R, encode_reuse=R)
    jstate, m = group(state0, jbuf, base_key)
    # the group's first step and one field-only step, each as group_step
    # computes it but in programs of their own (XLA's bits differ between
    # programs, so the bits are compared within one)
    full = jstep_ae._ae_loss_fn(model, True, 2.0, 6.0, True, 0.5, return_latents=True)
    field = jstep_ae._ae_field_loss_fn(model, True, 2.0, 6.0, True, 0.5)

    @jax.jit
    def first_step(state):
        sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, state.step))
        k_view, k_pix = jax.random.split(sample_key)
        view = jstep.sample_view(jbuf, k_view)
        batch = jstep.sample_view_pixels(view, jbuf["directions"], k_pix, B)
        batch["src_imgs"] = jstep.view_src_image(view, WH[::-1])
        (_, (*_, latents)), grads = jax.value_and_grad(full, has_aux=True)(state.params, batch, render_key)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return jstep.TrainState(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                                opt_state=opt_state), view, latents

    @jax.jit
    def field_step(state, view, latents):
        sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, state.step))
        batch = jstep.sample_view_pixels(view, jbuf["directions"], sample_key, B)
        (loss, (l0, l1, lo)), grads = jax.value_and_grad(field, has_aux=True)(state.params, batch, latents,
                                                                               render_key)
        updates, opt_state = jstep_ae.masked_field_update(tx, grads, state.opt_state, state.params)
        return jstep.TrainState(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                                opt_state=opt_state), (loss, l0, l1, lo)

    after_first, view, latents = first_step(state0)
    after_field, _ = field_step(after_first, view, latents)
    after_third, parts = field_step(after_field, view, latents)
    return {"bufs": bufs, "params": params, "base_key": base_key, "jstate": jax.device_get(jstate),
            "after_first": jax.device_get(after_first), "after_field": jax.device_get(after_field),
            "after_third": jax.device_get(after_third), "third_parts": [float(x) for x in parts],
            "view": jax.device_get(view), "latents": jax.device_get(latents),
            "metrics": {k: float(v) for k, v in m.items()}}


def _leaves(tree_state):
    """name -> array of a JAX TrainState's params and Adam moments, in the
    port's names and layouts."""
    adam = tree_state.opt_state[0]
    out = {}
    for prefix, tree in (("p", tree_state.params), ("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"{prefix}:{n}": v.numpy() for n, v in module_state_dict_from_flax(tree).items()})
    return out


def test_jax_group_keeps_the_frozen_partition_bit_for_bit(setup):
    # JAX's field-only step (masked_field_update) leaves the frozen partition
    # and its moments as its first step left them; its count advances
    first, after = _leaves(setup["after_first"]), _leaves(setup["after_field"])
    frozen = [k for k in first if k.split(":")[1].split(".")[0] != "field"]
    assert len(frozen) > 100 and int(setup["after_field"].opt_state[0].count) == 2
    for k in frozen:
        np.testing.assert_array_equal(after[k], first[k], err_msg=k)
    moved = [k for k in first if k.startswith("p:field.") and not np.array_equal(after[k], first[k])]
    assert len(moved) > 0.9 * sum(k.startswith("p:field.") for k in first)
    # the group's frozen partition as that first step left it, to fp32 spreads
    # (another program): within 2 lr of it, while the field moved on
    group = _leaves(setup["jstate"])
    for k in frozen:
        if k.startswith("p:"):
            np.testing.assert_allclose(group[k], first[k], atol=2 * LR, rtol=0, err_msg=k)


def _port_first_step(setup):
    """The port's group's first step alone (view, pixels, full step), for
    the frozen partition's bits after it."""
    model = port_model(setup["params"])
    tx = tstep.make_adam(**SCHEDULE)
    state = tstep.create_train_state(model, tx)
    bufs = {k: torch.from_numpy(v) for k, v in setup["bufs"].items()}
    draws = jax_group_draws(setup["base_key"], 0, True, setup["bufs"]["c2w"].shape[:3])
    view = tstep.sample_view(bufs, draws)
    batch = tstep.sample_view_pixels(view, bufs["directions"], draws, B)
    batch["src_imgs"] = tstep.view_src_image(view, WH[::-1])
    _, _, grads = tstep_ae.ae_loss_and_grads(model, state.params, batch, draws, True, True, 2.0, 6.0, 0.5)
    return state.params, tx.update(list(state.params.values()), grads, state.opt_state)


def test_group_matches_jax(setup):
    model = port_model(setup["params"])
    tx = tstep.make_adam(**SCHEDULE)
    state = tstep.create_train_state(model, tx)
    names = list(state.params)
    shape = setup["bufs"]["c2w"].shape[:3]
    fn = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B, inner_steps=R,
                                            encode_reuse=R)
    seen = []

    def draws_for(step):
        seen.append(step)
        return jax_group_draws(setup["base_key"], step, step == 0, shape)

    state, m = fn(state, {k: torch.from_numpy(v) for k, v in setup["bufs"].items()}, 0, draws_for=draws_for)
    assert seen == list(range(R)) and state.step == state.opt_state.count == R
    # the state loss of the first step (same start) as a step's; the others
    # come from the last field-only step, after two updates that differ by
    # fp32 spreads (held from JAX's state in the test below); on both sides
    # loss = loss0 + loss1 + opacity + the first step's state loss
    want = setup["metrics"]
    np.testing.assert_allclose(m["loss_state"].item(), want["loss_state"], rtol=METRIC_RTOL["loss_state"])
    assert m["lr"] == pytest.approx(jax_lr(R, **SCHEDULE), rel=1e-6) == want["lr"]  # at the step after the group
    for got in ({k: float(v) for k, v in m.items()}, want):
        parts = sum(10 ** (-got[k] / 10) for k in ("psnr0", "psnr1")) + got["opacity_loss"] + got["loss_state"]
        assert got["loss"] == pytest.approx(parts, rel=1e-5)
    # the port's frozen partition and its moments: as the first step left them, bit for bit
    first_params, first_opt = _port_first_step(setup)
    frozen = _frozen(names)
    assert len(frozen) > 50 and first_opt.count == 1
    for i, n in enumerate(names):
        if n in frozen:
            assert torch.equal(state.params[n], first_params[n]), n
            for k in ("mu", "nu"):
                assert torch.equal(state.opt_state.slots[k][i], first_opt.slots[k][i]), (k, n)
        else:
            assert not torch.equal(state.params[n], first_params[n]), n
    # every parameter within 2 lr an update of JAX's: the frozen ones moved
    # once, the field's R times
    got, jwant = port_leaves(model), jax_leaves(setup["jstate"].params)
    assert set(got) == set(jwant)
    for name, w in jwant.items():
        updates = R if name.startswith("field.") else 1
        np.testing.assert_allclose(got[name], w, atol=2 * LR * updates, rtol=0, err_msg=name)
    # the bridge carries JAX's state after the group: its count, a moment for every parameter
    carried = opt_state_from_optax(setup["jstate"].opt_state, names)
    assert carried.count == R and set(carried.slots) == {"mu", "nu"}
    assert all(t is not None and t.shape == state.params[n].shape for t, n in zip(carried.slots["mu"], names))


def test_field_only_step_reads_no_frozen_gradient(setup):
    # the field-only loss differentiates the field alone: None for the rest
    model = port_model(setup["params"])
    state = tstep.create_train_state(model, tstep.make_adam(**SCHEDULE))
    bufs = {k: torch.from_numpy(v) for k, v in setup["bufs"].items()}
    draws = jax_group_draws(setup["base_key"], 0, True, setup["bufs"]["c2w"].shape[:3])
    view = tstep.sample_view(bufs, draws)
    batch = tstep.sample_view_pixels(view, bufs["directions"], draws, B)
    batch["src_imgs"] = tstep.view_src_image(view, WH[::-1])
    *_, latents = tstep_ae.ae_loss_and_grads(model, state.params, batch, draws, True, True, 2.0, 6.0, 0.5,
                                             return_latents=True)
    assert set(latents) == {"density", "color", "articulation", "articulation_deg"}
    assert not any(v.requires_grad for v in latents.values())
    draws = jax_group_draws(setup["base_key"], 1, False, None)
    batch = tstep.sample_view_pixels(view, bufs["directions"], draws, B)
    _, _, grads = tstep_ae.ae_field_loss_and_grads(model, state.params, batch, latents, draws, True, True, 2.0,
                                                   6.0, 0.5)
    mask = tstep_ae.field_update_mask(state.params)
    assert [g is not None for g in grads] == mask and 0 < sum(mask) < len(mask)


def test_field_only_step_from_the_jax_state_matches(setup):
    # the port restarted from JAX's state after the group's second step
    # (parameters, Adam count and moments through the bridge) runs the third,
    # field-only step on JAX's latents and draws: its loss parts as a step's
    # (METRIC_RTOL), the field within 2 lr of JAX's after it, and the frozen
    # partition and its moments unchanged bit for bit, the count advanced
    model = port_model(setup["after_field"].params)
    tx = tstep.make_adam(**SCHEDULE)
    params = dict(model.named_parameters())
    names = list(params)
    opt_state = opt_state_from_optax(setup["after_field"].opt_state, names)
    assert opt_state.count == 2
    before = {n: (params[n].clone(), opt_state.slots["mu"][i].clone(), opt_state.slots["nu"][i].clone())
              for i, n in enumerate(names)}
    view = {k: torch.from_numpy(np.array(v)) for k, v in setup["view"].items()}
    latents = {k: torch.from_numpy(np.array(v)) for k, v in setup["latents"].items()}
    draws = jax_group_draws(setup["base_key"], 2, False, None)
    bufs = {k: torch.from_numpy(v) for k, v in setup["bufs"].items()}
    batch = tstep.sample_view_pixels(view, bufs["directions"], draws, B)
    loss, (loss0, loss1, loss_op), grads = tstep_ae.ae_field_loss_and_grads(
        model, params, batch, latents, draws, True, True, 2.0, 6.0, 0.5)
    opt_state = tstep_ae.masked_field_update(tx, params, grads, opt_state)
    assert opt_state.count == 3
    want_loss, want0, want1, want_op = setup["third_parts"]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=METRIC_RTOL["loss"])
    np.testing.assert_allclose(loss_op.item(), want_op, rtol=METRIC_RTOL["opacity_loss"])
    for got, want in ((loss0, want0), (loss1, want1)):
        np.testing.assert_allclose(10 * np.log10(got.item()), 10 * np.log10(want), atol=PSNR_ATOL, rtol=0)
    jwant = jax_leaves(setup["after_third"].params)
    for i, n in enumerate(names):
        if n.startswith("field."):
            np.testing.assert_allclose(params[n].detach().numpy(), jwant[n], atol=2 * LR, rtol=0, err_msg=n)
        else:
            p, mu, nu = before[n]
            assert torch.equal(params[n], p) and torch.equal(opt_state.slots["mu"][i], mu), n
            assert torch.equal(opt_state.slots["nu"][i], nu), n
