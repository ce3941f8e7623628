"""The port's vanilla Trainer at other encoding degrees on the CPU, against
the JAX Trainer, which passes ``min_deg_point``, ``max_deg_point`` and
``deg_view`` into ``NeRF`` and reads neither ``netdepth`` nor ``netwidth``:
``fit`` then ``test`` at (0, 8, 2) with the trained weights bridged into
the JAX Trainer, a resume from a checkpoint at those degrees, and the
parameter shapes of a config that sets ``netwidth`` / ``netdepth``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import config as jconfig
from aonerf_torch.data import synthetic
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import config
from aonerf_torch.utils.bridge import flax_leaves, nerf_flax_tree
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

DEG = {"min_deg_point": 0, "max_deg_point": 8, "deg_view": 2}  # encoded widths 51 / 15


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.generate_single_scene(str(tmp_path_factory.mktemp("scene")), img_wh=(16, 12), n_train=2,
                                           n_val=1, n_test=2)


def _settings(root, out, name, **extra):
    return {"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": [16, 12], "platform": "cpu",
            "num_coarse_samples": 8, "num_fine_samples": 16, "batch_size": 16, "chunk": 64, "inner_steps": 1,
            "val_every_steps": 1000, "lr_delay_steps": 0, **extra}


def _shapes(tree):
    return {"/".join(path): tuple(np.shape(leaf)) for path, leaf in flax_leaves(tree)}


def test_fit_and_test_match_the_jax_trainer_at_other_degrees(scene, tmp_path, monkeypatch):
    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    settings = _settings(scene, tmp_path, "port", **DEG)
    trainer = Trainer(config.load_config(None, settings))
    try:
        for mlp in (trainer.model.coarse_mlp, trainer.model.fine_mlp):
            assert (mlp.min_deg_point, mlp.max_deg_point, mlp.deg_view) == (0, 8, 2)
            assert mlp.pts_0.weight.shape == (256, 51) and mlp.views_0.weight.shape == (128, 256 + 15)
        last = trainer.fit(max_steps=4)
        assert trainer.state.step == 4 and np.isfinite(last["loss"])
    finally:
        trainer.close()

    trainer = Trainer(config.load_config(None, {**settings, "run_eval": True}))  # restores step 4
    try:
        assert trainer.state.step == 4
        params = nerf_flax_tree(trainer.model)
        got = trainer.test()
    finally:
        trainer.close()

    jtrainer = JaxTrainer(jconfig.load_config(None, {**settings, "exp_name": "jax", "run_eval": True}))
    try:
        assert _shapes(jax.device_get(jtrainer.state.params)) == _shapes(params)  # the same tree at these degrees
        jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
        want = jtrainer.test()
    finally:
        jtrainer.close()

    with open(tmp_path / "port" / "results.json") as f, open(tmp_path / "jax" / "results.json") as g:
        saved, jax_saved = json.load(f), json.load(g)
    assert saved == json.loads(json.dumps(got)) and jax_saved == json.loads(json.dumps(want))
    # tests/test_torch_test.py's tolerances: the port's fp32 render against
    # JAX's jitted one, rgb within ~1.5e-5, so PSNR within 1e-3 dB and SSIM
    # within 1e-5
    for name, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_obj", 1e-3)):
        assert np.isfinite(saved[name]["test"])
        np.testing.assert_allclose(saved[name]["test"], jax_saved[name]["test"], atol=tol, rtol=0, err_msg=name)


def test_resume_at_other_degrees(scene, tmp_path):
    settings = _settings(scene, tmp_path, "resume", ckpt_every_steps=2, **DEG)
    trainer = Trainer(config.load_config(None, settings))
    try:
        trainer.fit(max_steps=2)
        saved = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    finally:
        trainer.close()
    assert saved["coarse_mlp.pts_0.weight"].shape == (256, 51)
    resumed = Trainer(config.load_config(None, settings))
    try:
        assert resumed.state.step == resumed.state.opt_state.count == 2
        for n, p in resumed.state.params.items():
            assert torch.equal(p, saved[n]), n
        last = resumed.fit(max_steps=4)
        assert resumed.state.step == 4 and np.isfinite(last["loss"])
    finally:
        resumed.close()
    # a run at the default degrees does not take these weights
    with pytest.raises(RuntimeError, match=r"size of tensor a \(63\) must match .* \(51\)"):
        Trainer(config.load_config(None, {**_settings(scene, tmp_path, "default"),
                                          "ckpt_path": str(tmp_path / "resume" / "ckpts")}))


def test_netwidth_and_netdepth_are_read_by_no_model(scene, tmp_path):
    # the JAX Trainer's mlp_kwargs hold neither field: a config that sets
    # them builds 8x256 MLPs in both Trainers, the same parameter shapes
    settings = _settings(scene, tmp_path, "jax", netwidth=128, netdepth=6)
    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    try:
        want = _shapes(jax.device_get(jtrainer.state.params))
    finally:
        jtrainer.close()
    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        got = _shapes(nerf_flax_tree(trainer.model))
    finally:
        trainer.close()
    assert got == want
    assert got["params/fine_mlp/pts_7/kernel"] == (256, 256) and got["params/coarse_mlp/pts_0/kernel"] == (63, 256)
