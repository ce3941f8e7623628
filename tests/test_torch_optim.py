"""Port parity: the optimizers and schedules of aonerf_torch.train.optim
against aonerf.train.optim (optax) on the same parameters and the same
gradients, update by update; the latent split's two learning rates and its
model-only clip; the bridge of optax states; and resumed Trainer runs under
every optimizer, bit for bit against unbroken ones.

Tolerances: each parameter within 1e-6 of its leaf's largest entry after
every update (float32 sums in another order; RAdam's switch at rho_t >= 5 is
held to the same count on both sides). The learning rates within one float32
ulp of JAX's: XLA's float32 pow and cos are not correctly rounded (about 1 in
1000 values of a cos or pow differs by an ulp from the float64 value rounded,
which the port computes); the warmup ramp and steplr before its second
milestone hold no pow or cos other than exact ones, and are equal."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aonerf.train import optim as joptim
from aonerf_torch.data import synthetic
from aonerf_torch.train import optim
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import bridge, config
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

N_UPDATES = 6  # through Ranger's first sync and RAdam's switch (rho_t >= 5 from the 6th update)
SHAPES = {"dense": {"kernel": (7, 5), "bias": (5,)}, "embed": {"embedding": (4, 3)}}
PARAM_TOL = 1e-6


def _cfg(**kw):
    base = dict(lr_init=0.05, lr_final=5e-4, run_max_steps=20, lr_delay_steps=3, steps_per_epoch=2, num_epochs=4,
                decay_step=(1, 2), decay_gamma=0.5, poly_exp=0.9, weight_decay=1e-2, momentum=0.8)
    return config.load_config(None, {**base, **kw})


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _names(tree):
    return [f"{m}.{k}" for m, leaves in tree.items() for k in leaves]


def _flat(tree):
    """{port name: tensor} of a {module: {leaf: array}} tree (no layout change)."""
    return {f"{m}.{k}": torch.from_numpy(np.array(v)) for m, leaves in tree.items() for k, v in leaves.items()
            if hasattr(v, "shape")}


def _grads(step, scale=1.0):
    return _tree(1000 + step, scale)


def _run_jax(tx, params, n, grad_scale=1.0):
    """params after each of ``n`` updates, and the state before each."""
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    upd = jax.jit(tx.update)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    out, states = [], []
    for s in range(n):
        states.append(jax.device_get(state))
        u, state = upd(jax.tree_util.tree_map(jnp.asarray, _grads(s, grad_scale)), state, p)
        p = optax.apply_updates(p, u)
        out.append(jax.device_get(p))
    return out, states


def _run_port(tx, params, n, grad_scale=1.0):
    p = list(_flat(params).values())
    state = tx.init(p)
    out = []
    for s in range(n):
        state = tx.update(p, list(_flat(_grads(s, grad_scale)).values()), state)
        out.append([t.clone() for t in p])
    return out, state


def _check(port_params, jax_tree, what):
    """The port's parameters (in ``_flat``'s order of the start tree) against
    JAX's tree (whose dicts come back key-sorted), by name."""
    want_all = _flat(jax_tree)
    for got, name in zip(port_params, _names(_tree(0))):
        want = want_all[name].numpy()
        np.testing.assert_allclose(got.numpy(), want, atol=PARAM_TOL * np.abs(want).max(), rtol=0,
                                   err_msg=f"{what}: {name}")


CASES = [(o, s, w) for o in ("sgd", "adam") for s in ("steplr", "cosine", "poly") for w in (0, 1)] + [
    (o, s, 0) for o in ("radam", "ranger") for s in ("steplr", "cosine", "poly")]


@pytest.mark.parametrize("opt,sched,warmup", CASES, ids=lambda v: str(v))
def test_updates_and_lr_match_optax(opt, sched, warmup):
    cfg = _cfg(optimizer=opt, lr_scheduler=sched, warmup_epochs=warmup, warmup_multiplier=2.0)
    jtx, jlr = joptim.build_optimizer_from_config(cfg)
    ttx, tlr = optim.build_optimizer_from_config(cfg)
    params = _tree(0)
    want, jstates = _run_jax(jtx, params, N_UPDATES)
    got, state = _run_port(ttx, params, N_UPDATES)
    assert state.count == N_UPDATES
    for s in range(N_UPDATES):
        _check(got[s], want[s], f"update {s}")
    # restarted from JAX's state before update 3 (moments, traces, slow
    # weights and count through the bridge), the port goes on as JAX
    names = list(_flat(params))
    mid = bridge.opt_state_from_optax(jstates[3], names, to_port=_flat)
    assert mid.count == 3 and set(mid.slots) == set(ttx.slots)
    after = _flat(want[2])
    p = [after[n].clone() for n in names]
    for s in range(3, N_UPDATES):
        mid = ttx.update(p, list(_flat(_grads(s)).values()), mid)
        _check(p, want[s], f"restarted, update {s}")
    # the learning rates, float32: within an ulp, equal where no pow or cos rounds
    steps = np.arange(40)
    j = np.asarray(jax.jit(jax.vmap(jlr))(jnp.asarray(steps)), np.float32)
    t = np.asarray([tlr(int(s)) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(t, j, maxulp=1)
    exact = steps <= (warmup * cfg.steps_per_epoch if warmup else -1)
    if sched == "steplr":
        exact |= steps < max(cfg.decay_step) * cfg.steps_per_epoch
    np.testing.assert_array_equal(t[exact], j[exact])


def test_default_adam_route_is_the_log_lerp_adam():
    cfg = _cfg(grad_clip=0.5)
    jtx, jlr = joptim.build_optimizer_from_config(cfg)
    ttx, tlr = optim.build_optimizer_from_config(cfg)
    assert type(ttx) is optim.Adam and ttx.weight_decay == 0.0 and ttx.grad_clip == 0.5
    want, _ = _run_jax(jtx, _tree(0), 3, grad_scale=10.0)
    got, _ = _run_port(ttx, _tree(0), 3, grad_scale=10.0)
    for s in range(3):
        _check(got[s], want[s], f"update {s}")
    # the log-lerp schedule (train/lr.py, unchanged: exp and sin in numpy's
    # float32, 2 ulps from XLA's here) within 1e-6 of itself, as
    # tests/test_torch_train.py holds it
    np.testing.assert_allclose([tlr(s) for s in range(6)], [float(jlr(s)) for s in range(6)], rtol=1e-6)


@pytest.mark.parametrize("model_opt", ["adam", "ranger"])
def test_latent_split_two_rates_and_model_only_clip(model_opt):
    # {'model', 'codes'}: the model's optimizer (clipped at 0.5: its gradients'
    # norm is ~50) and the codes' AdamW at latent_lr, unclipped
    cfg = _cfg(exp_type="vanilla_autodecoder", optimizer=model_opt, lr_scheduler=None if model_opt == "adam" else
               "poly", latent_lr=2e-3, grad_clip=0.5)
    jtx, _ = joptim.build_optimizer_from_config(cfg)
    ptree = {"model": _tree(0)["dense"], "codes": _tree(0)["embed"]}
    gtree = lambda s: {"model": _grads(s, 10.0)["dense"], "codes": _grads(s, 10.0)["embed"]}  # noqa: E731
    n_model = len(ptree["model"])
    ttx, _ = optim.build_optimizer_from_config(cfg, n_model=n_model)
    assert isinstance(ttx, optim.LatentSplit) and ttx.codes_tx.grad_clip is None and ttx.model_tx.grad_clip == 0.5
    flat = lambda tree: {f"{m}.{k}": torch.from_numpy(np.array(v))  # noqa: E731
                         for m, leaves in tree.items() if isinstance(leaves, dict)
                         for k, v in leaves.items() if hasattr(v, "shape")}
    jp = jax.tree_util.tree_map(jnp.asarray, ptree)
    jstate = jtx.init(jp)
    p = list(flat(ptree).values())
    state = ttx.init(p)
    assert state.slots["mu"][n_model] is not None and ("slow" not in state.slots or state.slots["slow"][-1] is None)
    for s in range(N_UPDATES):
        before = [t.clone() for t in p]
        u, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, gtree(s)), jstate, jp)
        jp = optax.apply_updates(jp, u)
        state = ttx.update(p, list(flat(gtree(s)).values()), state)
        want_all = flat(jax.device_get(jp))
        for got, name in zip(p, flat(ptree)):
            want = want_all[name].numpy()
            np.testing.assert_allclose(got.numpy(), want, atol=PARAM_TOL * np.abs(want).max(), rtol=0,
                                       err_msg=f"update {s}: {name}")
        if s == 0:  # AdamW's first step moves each code entry by ~latent_lr (the sign of its gradient)
            step = (p[n_model] - before[n_model]).abs()
            assert torch.allclose(step, torch.full_like(step, 2e-3), rtol=0.05)
    mid = bridge.opt_state_from_optax(jax.device_get(jstate), list(flat(ptree)), to_port=flat)
    assert mid.count == N_UPDATES
    for k, v in state.slots.items():
        for a, b in zip(v, mid.slots[k]):
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * float(b.abs().max()) + 1e-30,
                                           rtol=0, err_msg=k)


def test_masked_update_freezes_parameters_and_slots_but_counts():
    ttx = optim.make_optimizer("ranger", optim.make_schedule("poly", 0.05, num_epochs=4, steps_per_epoch=2),
                               weight_decay=1e-2)
    p = list(_flat(_tree(0)).values())
    state = ttx.init(p)
    for s in range(2):
        state = ttx.update(p, list(_flat(_grads(s)).values()), state)
    mask = [True, False, True]
    frozen = [p[1].clone()] + [state.slots[k][1].clone() for k in ttx.slots]
    for s in range(2, 7):  # through the sync at the 6th update
        state = ttx.update(p, list(_flat(_grads(s)).values()), state, mask=mask)
    assert state.count == 7
    assert all(torch.equal(a, b) for a, b in zip(frozen, [p[1]] + [state.slots[k][1] for k in ttx.slots]))
    assert not torch.equal(state.slots["slow"][0], _flat(_tree(0))["dense.kernel"])


def _vanilla_settings(root, out, name, **kw):
    return {"exp_type": "vanilla", "dataset_name": "sapien", "exp_name": name, "root_dir": root,
            "output_path": str(out), "img_wh": [16, 12], "platform": "cpu", "num_coarse_samples": 4,
            "num_fine_samples": 8, "batch_size": 16, "chunk": 64, "inner_steps": 2, "val_every_steps": 100,
            "ckpt_every_steps": 2, "limit_val_batches": 1, "steps_per_epoch": 2, "num_epochs": 5,
            "decay_step": [2], "lr_init": 1e-3, **kw}


def _autodecoder_settings(root, out, name, **kw):
    with open(os.path.join(ROOT, "config", "autodecoder.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": [16, 12], "platform": "cpu",
                "num_coarse_samples": 4, "num_fine_samples": 4, "batch_size": 16, "chunk": 192, "inner_steps": 2,
                "val_every_steps": 100, "ckpt_every_steps": 2, "limit_val_batches": 1, **kw})
    return cfg


def _fit(settings, max_steps):
    trainer = Trainer(config.load_config(None, settings))
    try:
        trainer.fit(max_steps=max_steps)
        return trainer.state
    finally:
        trainer.close()


RESUME = {
    "sgd_steplr_warmup": dict(optimizer="sgd", lr_scheduler="steplr", warmup_epochs=1, warmup_multiplier=2.0,
                              weight_decay=1e-4),
    "adamw_cosine": dict(optimizer="adam", lr_scheduler="cosine", weight_decay=1e-4),
    "radam_poly": dict(optimizer="radam", lr_scheduler="poly"),
    "ranger_poly": dict(optimizer="ranger", lr_scheduler="poly", grad_clip=1.0),
    "autodecoder_latent_lr": dict(latent_lr=1e-3),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    single = synthetic.generate_single_scene(str(base / "single"), img_wh=(16, 12), n_train=2, n_val=1, n_test=0)
    multi = synthetic.generate_multi_scene(str(base / "multi"), img_wh=(16, 12), n_instances=2, degrees=(0, 10),
                                           n_images=2)
    return {"single": single, "multi": multi}


@pytest.mark.parametrize("case", list(RESUME))
def test_resumed_run_equals_unbroken_run(case, scenes, tmp_path):
    # 8 steps unbroken against 4 + a resume to 8 (Ranger syncs at 6 from
    # slow weights restored at 4): every parameter and every slot equal
    if case.startswith("autodecoder"):
        make = lambda name: _autodecoder_settings(scenes["multi"], tmp_path / "out", name, **RESUME[case])  # noqa
    else:
        make = lambda name: _vanilla_settings(scenes["single"], tmp_path / "out", name, **RESUME[case])  # noqa
    unbroken = _fit(make("unbroken"), 8)
    _fit(make("broken"), 4)
    resumed = _fit(make("broken"), 8)
    assert resumed.step == unbroken.step == resumed.opt_state.count == 8
    for a, b in zip(resumed.params.values(), unbroken.params.values()):
        assert torch.equal(a, b)
    assert set(resumed.opt_state.slots) == set(unbroken.opt_state.slots)
    for k, v in resumed.opt_state.slots.items():
        for a, b in zip(v, unbroken.opt_state.slots[k]):
            assert (a is None and b is None) or torch.equal(a, b), k
    if case == "ranger_poly":
        assert set(resumed.opt_state.slots) == {"mu", "nu", "slow"}
    if case.startswith("autodecoder"):  # the codes' AdamW beside the field's Adam: one count, both moments
        assert all(t is not None for t in resumed.opt_state.slots["mu"])
