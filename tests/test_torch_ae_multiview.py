"""Port parity: several source views a step (``views_per_step`` V > 1) of
the auto-encoder: ``sample_multi_batch_multiview``'s layout and its draws
replayed against aonerf's, a V = 2 step from JAX's state against JAX's
``make_ae_device_train_step(views_per_step=2)`` (fp32, 64x48, 8 + 8
samples), and JAX's two ValueErrors."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.train import step as jstep
from aonerf.train import step_ae as jstep_ae
from aonerf.train.lr import log_lerp_lr as jax_lr
from aonerf_torch.train import step as tstep
from aonerf_torch.train import step_ae as tstep_ae
from aonerf_torch.utils.bridge import module_flax_tree
from tests.test_torch_ae_step import (
    LR,
    NF,
    SC,
    SCHEDULE,
    WH,
    _port,
    _port_state_from_jax,
    check_metrics,
    draw_shape,
    jax_leaves,
    jax_model,
    port_leaves,
    port_model,
    scene_buffers,
)
from tests.test_torch_articulated import QueueDraws, jax_render_draws
from tests.test_torch_sapien_multi import jax_batch_draws
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

V, B = 2, 16  # views a step, rays a step (8 a view)


def jax_multiview_draws(sample_key, shape, batch_size=B, n_views=V):
    """The ids and pixels JAX's sample_multi_batch_multiview draws, view by
    view (each view's from its own split of ``sample_key``)."""
    out = []
    for k in jax.random.split(sample_key, n_views):
        out += jax_batch_draws(k, *shape, batch_size // n_views)
    return out


def jax_step_draws(base_key, step, shape):
    sample_key, render_key = jax.random.split(jax.random.fold_in(base_key, step))
    return QueueDraws(jax_multiview_draws(sample_key, shape) + jax_render_draws(render_key, B, SC, NF))


@pytest.fixture(scope="module")
def bufs(tmp_path_factory):
    return scene_buffers(tmp_path_factory.mktemp("multi"))


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_matches_jax(bufs, seed):
    key = jax.random.PRNGKey(seed)
    want = jstep.sample_multi_batch_multiview({k: jnp.asarray(v) for k, v in bufs.items()}, key, B, V,
                                              src_hw=WH[::-1])
    draws = QueueDraws(jax_multiview_draws(key, draw_shape(bufs)))
    got = tstep.sample_multi_batch_multiview({k: torch.from_numpy(v) for k, v in bufs.items()}, draws, B, V,
                                             src_hw=WH[::-1])
    assert not draws.arrays and set(got) == set(want)
    shapes = {"rays_o": (B, 3), "rays_d": (B, 3), "viewdirs": (B, 3), "target": (B, 3), "instance_mask": (B,),
              "src_imgs": (V, 3, WH[1], WH[0]), "deg": (V,), "instance_id": (V,), "articulation_id": (V,)}
    for k, shape in shapes.items():
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == shape, k
        if k in ("rays_o", "rays_d", "viewdirs"):  # a 3x3 product and a norm in fp32
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["rays_d"] is got["viewdirs"]
    # grouped by view: each view's rays share its camera's origin
    o = got["rays_o"].numpy().reshape(V, B // V, 3)
    assert (o == o[:, :1]).all()


@pytest.fixture(scope="module")
def trajectory(bufs):
    params = module_flax_tree(port_model())
    tx = jstep.make_adam(**SCHEDULE)
    jfn = jstep_ae.make_ae_device_train_step(
        jax_model(), tx, True, 2.0, 6.0, img_wh=WH, batch_size=B, donate=False,
        lr_fn=functools.partial(jax_lr, **SCHEDULE), views_per_step=V,
    )
    base_key = jax.random.PRNGKey(5)
    jstate = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    before = jax.device_get(jstate)
    jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in bufs.items()}, base_key)
    return {"params": params, "base_key": base_key, "before": before, "metrics": {k: float(v) for k, v in m.items()},
            "after": jax.device_get(jstate.params)}


def test_two_view_step_from_the_jax_state_matches(bufs, trajectory):
    # The port from JAX's state with JAX's draws replayed: both views encoded
    # in one batch, each view's rays conditioned on its own latents and
    # angle; the metrics within the one-view step's tolerances, every
    # parameter after the update within 2 lr.
    model, tx, state, tbuf = _port(trajectory["params"], bufs)
    state = _port_state_from_jax(trajectory["before"], state)
    step_fn = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, batch_size=B,
                                                 views_per_step=V)
    draws = jax_step_draws(trajectory["base_key"], 0, draw_shape(bufs))
    state, m = step_fn(state, tbuf, 0, draws=draws)
    assert not draws.arrays
    check_metrics(m, trajectory["metrics"], "V=2 step")
    assert state.step == 1
    got, want = port_leaves(model), jax_leaves(trajectory["after"])
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=2 * LR, rtol=0, err_msg=name)


def test_two_views_encode_once_and_condition_by_view(bufs):
    # one encoder call on the (V, 3, H, W) batch; the state loss over both
    # views' angles; the degree embedding's gradient in both views' rows
    model = port_model()
    calls = []
    real = model.encoder.forward
    model.encoder.forward = lambda x: calls.append(tuple(x.shape)) or real(x)
    draws = QueueDraws(jax_multiview_draws(jax.random.PRNGKey(3), draw_shape(bufs))
                       + jax_render_draws(jax.random.PRNGKey(4), B, SC, NF))
    batch = tstep.sample_multi_batch_multiview({k: torch.from_numpy(v) for k, v in bufs.items()}, draws, B, V,
                                               src_hw=WH[::-1])
    named = dict(model.named_parameters())
    _, (_, _, loss_state, _), grads = tstep_ae.ae_loss_and_grads(model, named, batch, draws, True, True, 2.0, 6.0,
                                                                 0.5)
    assert calls == [(V, 3, WH[1], WH[0])]
    with torch.no_grad():
        state = model.predict_state(model.encode(batch["src_imgs"])["articulation"])
    torch.testing.assert_close(loss_state, torch.mean((state.reshape(-1) - batch["deg"]) ** 2))
    table = grads[list(named).index("deg_embedding.weight")]
    rows = {int(round(np.rad2deg(float(d)))) for d in batch["deg"]}
    assert {int(r) for r in torch.nonzero(table.abs().sum(1)).flatten()} == rows


def test_value_errors_match_jax(bufs):
    model = port_model()
    tx = tstep.make_adam(**SCHEDULE)
    for kwargs, match in (({"views_per_step": 3, "batch_size": 16}, "divisible"),
                          ({"views_per_step": 2, "encode_reuse": 2}, "alternative")):
        with pytest.raises(ValueError, match=match):
            jstep_ae.make_ae_device_train_step(jax_model(), jstep.make_adam(**SCHEDULE), True, 2.0, 6.0, img_wh=WH,
                                               **kwargs)
        with pytest.raises(ValueError, match=match):
            tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=WH, **kwargs)
