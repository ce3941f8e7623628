"""The port's auto-encoder ``Trainer.test`` against the JAX Trainer's: the
spheric sweep of one instance (5 of the 19 poses, which chip_smoke.py runs
whole on the card), each pose conditioned on the latents and the predicted
joint angle encoded from its source view, with the same weights;
results.json and every render file."""

import json
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

N_SWEEP = 5
RENDER_FILES = sorted(
    [f"{stem}{i:03d}.{ext}" for i in range(N_SWEEP)
     for stem, ext in (("image", "jpg"), ("depth", "png"), ("depth", "npy"), ("depth_raw", "png"), ("opacity", "png"))]
    + ["depth_raw.npz"]
)


def test_test_sweep_matches_the_jax_trainer(tmp_path, monkeypatch):
    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = scene(tmp_path / "scene", val=False)
    cfg = settings(root, tmp_path / "out", "jax", run_eval=True, render_instance=1, test_sweep_poses=N_SWEEP)
    jtrainer = JaxTrainer(jconfig.load_config(None, cfg))
    try:
        assert jtrainer.cfg.test_sweep_poses == N_SWEEP
        params = jax.device_get(jtrainer.state.params)
        want = jtrainer.test()
    finally:
        jtrainer.close()

    trainer = Trainer(config.load_config(None, {**cfg, "exp_name": "port"}))
    try:
        assert trainer.dataset.split == "test" and trainer.val_dataset is trainer.dataset
        trainer.model.load_state_dict(module_state_dict_from_flax(params))
        got = trainer.test()
    finally:
        trainer.close()

    port_dir, jax_dir = tmp_path / "out" / "port", tmp_path / "out" / "jax"
    with open(port_dir / "results.json") as f, open(jax_dir / "results.json") as g:
        saved, jax_saved = json.load(f), json.load(g)
    assert saved == json.loads(json.dumps(got)) and list(saved) == list(want)
    assert list(saved) == list(jax_saved) == ["psnr", "ssim", "lpips", "psnr_obj"]
    # Against the whole sweep render in fp64 (encode, predicted state, both
    # levels), poses 0-1: JAX's rgb is up to 3.8e-4 off and its depth 2.8e-3
    # (its fp32 latents of these white-background views are ~7e-5 off and the
    # random field magnifies them), the port's 1.4e-4 and 7.4e-4. Held:
    # PSNR within 1e-3 dB as the other test() parity tests hold it, SSIM
    # within 1e-4 (3.5e-5 apart here), depth within 6e-3, twice JAX's spread.
    for name, tol in (("psnr", 1e-3), ("ssim", 1e-4), ("psnr_obj", 1e-3)):
        assert list(saved[name]) == list(jax_saved[name]) == ["test"]
        assert np.isfinite(saved[name]["test"])
        np.testing.assert_allclose(saved[name]["test"], jax_saved[name]["test"], atol=tol, rtol=0, err_msg=name)
    assert np.isnan(saved["lpips"]["test"]) and np.isnan(jax_saved["lpips"]["test"])
    files, jax_files = sorted(os.listdir(port_dir / "render")), sorted(os.listdir(jax_dir / "render"))
    assert files == jax_files
    assert [f for f in files if not f.startswith("video.")] == RENDER_FILES
    a, b = np.load(port_dir / "render" / "depth_raw.npz"), np.load(jax_dir / "render" / "depth_raw.npz")
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], atol=6e-3, rtol=0, err_msg=k)
