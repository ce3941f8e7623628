"""The settings a one-device Trainer runs beside the JAX Trainer's: the
launcher variants' checkpoint cadence (``is_optimize``, ``finetune_lpips``),
checkpoint surgery (``load_partial``, ``load_params_subtree``,
``best_step``) on bridged trees, ``debug_nans`` and ``profile_steps``, each
against ``aonerf`` on the CPU where JAX has a counterpart."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import CodeLibraryArticulated as JaxCodeLibrary
from aonerf.train import step as jstep
from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import ckpt as jckpt
from aonerf.utils import config as jconfig
from aonerf_torch.data import synthetic
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.models.codes import CodeLibraryArticulated
from aonerf_torch.train import loop
from aonerf_torch.train import step as tstep
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import ckpt, config
from aonerf_torch.utils.bridge import module_state_dict_from_flax
from aonerf_torch.utils.profile import device_op_table, latest_trace, timed_ops
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WH = (16, 12)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.generate_single_scene(str(tmp_path_factory.mktemp("scene")), img_wh=WH, n_train=2, n_val=1,
                                           n_test=0)


def _settings(root, out, name, **extra):
    return {"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": list(WH), "platform": "cpu",
            "num_coarse_samples": 4, "num_fine_samples": 4, "batch_size": 16, "chunk": 64, "inner_steps": 1,
            "val_every_steps": 1000, "lr_delay_steps": 0, **extra}


# ----------------------------------------------------------------- cadence


@pytest.mark.parametrize("variant", [{"is_optimize": True}, {"finetune_lpips": True}, {}],
                         ids=["is_optimize", "finetune_lpips", "plain"])
def test_launcher_cadence_matches_jax(variant, scene, tmp_path):
    # steps_per_epoch 2, ckpt_every_steps 3 and ckpt_keep 1 for 6 steps, a
    # val PSNR at every checkpoint: the launcher variants save every 2 steps
    # and is_optimize keeps them all; the others keep the best and the
    # latest. The same steps on disk as the JAX Trainer's for the same Config.
    settings = _settings(scene, tmp_path, "jax", steps_per_epoch=2, ckpt_every_steps=3, ckpt_keep=1,
                         val_every_steps=1, limit_val_batches=1, **variant)
    jcfg = jconfig.load_config(None, settings)
    jtrainer = JaxTrainer(jcfg)
    try:
        jtrainer.fit(max_steps=6)
        want = sorted(jtrainer.ckpt._mgr.all_steps())
    finally:
        jtrainer.close()
    cfg = config.load_config(None, {**settings, "exp_name": "port"})
    trainer = Trainer(cfg)
    try:
        trainer.fit(max_steps=6)
        got = trainer.ckpt.steps()
        keep = trainer.ckpt.keep
    finally:
        trainer.close()
    assert cfg.ckpt_every_steps == jcfg.ckpt_every_steps == (2 if variant else 3)
    assert got == want
    if variant.get("is_optimize"):
        assert got == [2, 4, 6] and keep is None
    else:
        assert 6 in got and len(got) <= 2 and keep == 1


# ---------------------------------------------------------------- surgery


def _autodecoder_trees(seed):
    """A {'model', 'codes'} flax tree of the auto-decoder at 4 + 4 samples."""
    jmodel = JaxArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True)
    jlib = JaxCodeLibrary()
    key = jax.random.PRNGKey(seed)
    codes = jlib.init(key, jnp.asarray(0), jnp.asarray(0))
    lat = {k: jnp.atleast_2d(v) for k, v in jlib.apply(codes, jnp.asarray(0), jnp.asarray(0)).items()}
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4)
    model = jmodel.init(key, {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d}, False, True, 2.0, 6.0, lat)
    return jax.device_get({"model": model, "codes": codes})


def _port_params(tree):
    """The port's parameters by name (the auto-decoder Trainer's
    {'model', 'codes'} ModuleDict) of a flax tree, by the bridge."""
    out = {}
    for group in ("model", "codes"):
        out.update(module_state_dict_from_flax(tree[group], prefix=f"{group}."))
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.fixture(scope="module")
def trees():
    params, donor = _autodecoder_trees(0), _autodecoder_trees(1)
    # a leaf of another shape in the donor: skipped by load_partial
    donor["model"]["params"]["fine_mlp"]["rgb"]["kernel"] = np.zeros((7, 3), np.float32)
    return params, donor


@pytest.mark.parametrize("ignore", [(), ("codes",), ("model/params/coarse_mlp",), ("model/params/fine_mlp/pts",)],
                         ids=["none", "codes", "coarse_mlp", "fine_pts"])
def test_load_partial_takes_and_skips_what_jax_does(trees, ignore):
    params, donor = trees
    want = jckpt.load_partial(params, donor, prefixes_to_ignore=ignore)
    got = ckpt.load_partial(_port_params(params), _port_params(donor), prefixes_to_ignore=ignore)
    _assert_same(got, _port_params(jax.device_get(want)))
    base, taken = _port_params(params), _port_params(donor)
    n_taken = sum(not torch.equal(got[n], base[n]) for n in got)
    assert n_taken == sum(torch.equal(got[n], taken[n]) and not torch.equal(base[n], taken[n]) for n in got) > 0
    assert torch.equal(got["model.fine_mlp.rgb.weight"], base["model.fine_mlp.rgb.weight"])  # shape differs


def test_load_params_subtree_grafts_the_codes_as_jax(trees):
    params, donor = trees
    tx = jstep.make_adam()
    jstate = jstep.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    want = jax.device_get(jckpt.load_params_subtree(jstate, jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, donor), tx), "codes").params)

    model = ArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True, device="cpu")
    lib = CodeLibraryArticulated(device="cpu")
    state = tstep.create_train_state(nn.ModuleDict({"model": model, "codes": lib}), tstep.make_adam())
    with torch.no_grad():
        for n, v in _port_params(params).items():
            state.params[n].copy_(v)
    out = ckpt.load_params_subtree(state, {"params": _port_params(donor)}, "codes")
    assert out is state
    _assert_same({n: p.detach() for n, p in state.params.items()}, _port_params(want))
    with pytest.raises(KeyError, match="subtree"):
        ckpt.load_params_subtree(state, {"params": {}}, "codes")


@pytest.mark.parametrize("keep", [0, 1, 2, 3, None])
def test_best_step_and_retention_match_orbax(keep, tmp_path):
    # PSNRs by step, one saved without a PSNR and a tie: after every save the
    # port keeps exactly the steps the JAX manager (orbax's BestN, best_mode
    # 'max', keep_checkpoints_without_metrics) keeps, and names the same best
    # step. JAX's manager is the reference: a latest checkpoint whose PSNR
    # ranks below the kept ones is dropped (step 5 at keep 2), whatever its
    # class's docstring ("always-keep-latest") says.
    history = [(0, 30.0), (1, 10.0), (2, None), (3, 20.0), (4, 30.0), (5, 5.0)]
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), keep=keep)
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"), keep=keep)
    assert mgr.best_step() is None is jmgr.best_step()
    state = {"w": np.zeros(2, np.float32)}
    for step, psnr in history:
        jmgr.save(step, state, val_psnr=psnr)
        mgr.save(step, {"w": torch.zeros(2)}, val_psnr=psnr)
        assert mgr.steps() == sorted(jmgr._mgr.all_steps()), step
        assert mgr.best_step() == jmgr.best_step(), step
        assert mgr.latest_step() == jmgr.latest_step(), step
    want = sorted(jmgr._mgr.all_steps())
    jmgr.close()
    if keep == 2:
        assert want == mgr.steps() == [0, 2, 4] and mgr.best_step() == 4
    elif keep is None:
        assert want == mgr.steps() == [0, 1, 2, 3, 4, 5]


def test_resume_after_a_dropped_latest_matches_jax(scene, tmp_path, monkeypatch):
    # ckpt_keep 1, a validation and a checkpoint every step, val PSNRs 30, 10,
    # 5: both managers keep only step 1, so both Trainers resume from step 1
    # rather than from the last step trained
    settings = _settings(scene, tmp_path, "jax", ckpt_keep=1, ckpt_every_steps=1, val_every_steps=1,
                         limit_val_batches=1)
    steps = {}
    for side, make, load in (("jax", JaxTrainer, jconfig.load_config), ("port", Trainer, config.load_config)):
        cfg = load(None, {**settings, "exp_name": side})
        trainer = make(cfg)
        psnrs = iter([30.0, 10.0, 5.0])
        monkeypatch.setattr(trainer, "validate", lambda n_images=None, it=psnrs: {"psnr": next(it)})
        try:
            trainer.fit(max_steps=3)
            kept = trainer.ckpt.steps() if side == "port" else sorted(trainer.ckpt._mgr.all_steps())
        finally:
            trainer.close()
        resumed = make(cfg)
        try:
            steps[side] = (kept, int(jax.device_get(resumed.state.step)) if side == "jax" else resumed.state.step)
        finally:
            resumed.close()
    assert steps["port"] == steps["jax"] == ([1], 1)


# ------------------------------------------------------------- debug_nans


def _plant_nan_jax(trainer):
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(trainer.state.params))
    leaves[0] = np.array(leaves[0])
    leaves[0].flat[0] = np.nan  # on the host: jax_debug_nans is on
    trainer.state = trainer.state.replace(params=jax.tree_util.tree_unflatten(treedef, leaves))


def test_debug_nans_raises_on_a_planted_nan_on_both_sides(scene, tmp_path):
    # one NaN in the first trunk kernel: JAX's jax_debug_nans and the port's
    # checks both raise FloatingPointError in the first step; the port names
    # the level output that held it
    settings = _settings(scene, tmp_path, "jax", debug_nans=True)
    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    try:
        _plant_nan_jax(jtrainer)
        with pytest.raises(FloatingPointError):
            jtrainer.fit(max_steps=1)
    finally:
        jtrainer.close()
        jax.config.update("jax_debug_nans", False)  # JAX's Trainer sets it for the process
    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        with torch.no_grad():
            next(iter(trainer.state.params.values())).view(-1)[0] = float("nan")
        with pytest.raises(FloatingPointError, match="coarse level's comp_rgb"):
            trainer.fit(max_steps=1)
        assert trainer.ckpt.latest_step() is None
    finally:
        trainer.close()


def test_debug_nans_trains_without_a_nan_and_checks_gradients(scene, tmp_path):
    trainer = Trainer(config.load_config(None, _settings(scene, tmp_path, "port", debug_nans=True)))
    try:
        last = trainer.fit(max_steps=3)
        assert trainer.state.step == 3 and np.isfinite(last["loss"])
        # a NaN gradient alone (finite outputs) is caught before the update
        names = list(trainer.state.params)
        grads = [torch.zeros_like(p) for p in trainer.state.params.values()]
        grads[5] = grads[5].clone().fill_(float("nan"))
        with pytest.raises(FloatingPointError, match=names[5]):
            trainer.tx.update(list(trainer.state.params.values()), grads, trainer.state.opt_state)
    finally:
        trainer.close()
    quiet = Trainer(config.load_config(None, _settings(scene, tmp_path, "quiet")))
    try:  # off: the optimizer and the model as built, no hook
        assert not isinstance(quiet.tx, loop._NanCheckedOptimizer) and not quiet.model._forward_hooks
    finally:
        quiet.close()


# ----------------------------------------------------------- profile_steps


def test_profile_steps_writes_a_trace_and_a_table(scene, tmp_path):
    trainer = Trainer(config.load_config(None, _settings(scene, tmp_path, "port", profile_steps=2)))
    try:
        trainer.fit(max_steps=4)
    finally:
        trainer.close()
    trace_dir = os.path.join(trainer.run_dir, "profile")
    path = latest_trace(trace_dir)
    assert path is not None and os.path.basename(path) == "trace_00000000.json"
    what, times = timed_ops(path)
    assert what == "host (cpu_op)" and times  # no card: the CPU's operations
    # the trace holds the first two of the four steps: a step gathers its
    # batch from each of the four ray buffers once
    assert times["aten::index"][1] == 2 * 4
    table = device_op_table(trace_dir, top_k=5).splitlines()
    assert table[0].startswith("== host (cpu_op):") and len(table) == 6
    assert all(" ms " in row and "%" in row for row in table[1:])
    assert device_op_table(str(tmp_path / "nothing")).startswith("(no trace")
