"""The port's auto-encoder ``Trainer.validate`` against the JAX Trainer's:
PSNR, object PSNR and the two joint-state errors from the same weights on
held-out degrees."""

import os

import jax
import numpy as np
import torch

from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import config as jconfig
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import config
from aonerf_torch.utils.bridge import module_state_dict_from_flax
from tests.test_torch_ae_trainer import scene, settings
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)


def test_validate_matches_jax(tmp_path):
    # One set of weights (JAX's init, bridged), held-out 5/15 degrees, each
    # view conditioned on its ground-truth angle: psnr and psnr_obj within
    # 1e-3 dB (the AE forward's rgb agrees to ~2e-5, tests/test_torch_ae.py),
    # state_error_rad (a mean of squared radians) within 1e-4 relative of
    # JAX's (the predicted state agrees to ~3e-6 rad), and the mean whole-
    # degree error exactly.
    root = scene(tmp_path / "scene")
    cfg = settings(root, tmp_path / "out", "jax")
    jtrainer = JaxTrainer(jconfig.load_config(None, cfg))
    trainer = Trainer(config.load_config(None, {**cfg, "exp_name": "port"}))
    try:
        assert trainer.val_dataset.uses_val_split and jtrainer.val_dataset.uses_val_split
        trainer.model.load_state_dict(module_state_dict_from_flax(jax.device_get(jtrainer.state.params)))
        want = jtrainer.validate()
        got = trainer.validate()
    finally:
        jtrainer.close()
        trainer.close()
    assert list(got) == list(want) == ["psnr", "psnr_obj", "state_error_rad", "abs_state_error_deg"]
    assert all(np.isfinite(v) for v in got.values())
    for k in ("psnr", "psnr_obj"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["state_error_rad"], want["state_error_rad"], rtol=1e-4)
    assert got["abs_state_error_deg"] == want["abs_state_error_deg"]
    assert os.listdir(tmp_path / "out" / "port" / "val_vis") == ["step0000000.png"]
