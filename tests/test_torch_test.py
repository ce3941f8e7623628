"""The port's test path on the CPU against the JAX Trainer: ``Trainer.test``
with ``run_eval`` on a 16x12 scene with bridged weights, and the CLI's
``--run_eval`` and ``--save_path``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import config as jconfig
from aonerf_torch.cli import train as cli
from aonerf_torch.data import synthetic
from aonerf_torch.eval import lpips
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import config
from aonerf_torch.utils.bridge import nerf_state_dict_from_flax

torch.set_num_threads(2)

RENDER_FILES = sorted(
    [f"image{i:03d}.jpg" for i in range(2)] + [f"depth{i:03d}.{e}" for i in range(2) for e in ("png", "npy")]
    + [f"depth_raw{i:03d}.png" for i in range(2)] + ["depth_raw.npz"]
    + [f"opacity{i:03d}.png" for i in range(2)]
)


def _settings(root, out, name):
    return {"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": [16, 12], "run_eval": True,
            "platform": "cpu", "num_coarse_samples": 8, "num_fine_samples": 16, "chunk": 64}


def _video(files):
    videos = [f for f in files if f.startswith("video.")]
    assert videos in (["video.gif"], ["video.mp4"]), files
    return videos[0]


def test_test_matches_the_jax_trainer(tmp_path, monkeypatch):
    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=1, n_val=1, n_test=2)
    settings = _settings(root, tmp_path / "out", "jax")

    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    try:
        params = jax.device_get(jtrainer.state.params)
        want = jtrainer.test()
    finally:
        jtrainer.close()

    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        assert trainer.dataset.split == "test" and not hasattr(trainer, "val_dataset")
        assert (trainer.near, trainer.far) == (trainer.dataset.near, trainer.dataset.far)
        trainer.model.load_state_dict(nerf_state_dict_from_flax(params))
        got = trainer.test()
    finally:
        trainer.close()

    port_dir, jax_dir = tmp_path / "out" / "port", tmp_path / "out" / "jax"
    with open(port_dir / "results.json") as f, open(jax_dir / "results.json") as g:
        saved, jax_saved = json.load(f), json.load(g)
    assert saved == json.loads(json.dumps(got))
    assert list(saved) == list(jax_saved) == ["psnr", "ssim", "lpips", "psnr_obj"]
    # The port's fp32 render against JAX's jitted one: rgb within ~1.5e-5
    # (tests/test_torch_eval.py), so PSNR within 1e-3 dB and SSIM within 1e-5.
    for name, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_obj", 1e-3)):
        assert list(saved[name]) == list(jax_saved[name]) == ["test"]
        assert np.isfinite(saved[name]["test"])
        np.testing.assert_allclose(saved[name]["test"], jax_saved[name]["test"], atol=tol, rtol=0, err_msg=name)
    assert np.isnan(saved["lpips"]["test"]) and np.isnan(jax_saved["lpips"]["test"])

    files, jax_files = sorted(os.listdir(port_dir / "render")), sorted(os.listdir(jax_dir / "render"))
    assert files == jax_files
    assert [f for f in files if f != _video(files)] == RENDER_FILES
    a, b = np.load(port_dir / "render" / "depth_raw.npz"), np.load(jax_dir / "render" / "depth_raw.npz")
    assert sorted(a.files) == sorted(b.files) == ["depth_raw000", "depth_raw001"]
    for k in b.files:  # the jitted renderer's depth tolerance (tests/test_torch_eval.py)
        assert a[k].shape == b[k].shape == (12, 16)
        np.testing.assert_allclose(a[k], b[k], atol=5e-4, rtol=0, err_msg=k)
        np.testing.assert_array_equal(np.load(port_dir / "render" / f"depth{k[-3:]}.npy"), a[k])


def test_cli_run_eval_restores_and_writes_under_save_path(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=2)
    settings = _settings(root, tmp_path / "out", "cli")
    del settings["run_eval"]
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**settings, "batch_size": 16, "inner_steps": 2, "ckpt_every_steps": 2,
                                    "val_every_steps": 100, "limit_val_batches": 1}))

    assert cli.parse_args(["--run_eval"]).run_eval is True  # a bare flag, as in JAX
    assert cli.parse_args([]).run_eval is None
    assert cli.parse_args(["--save_path", "x"]).render_name == "x"
    cli.main(["--config", str(cfg_path), "--max_steps", "2"])
    capsys.readouterr()

    stats = cli.main(["--config", str(cfg_path), "--run_eval", "--save_path", "x"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run_dir = tmp_path / "out" / "cli"
    with open(run_dir / "results.json") as f:
        assert json.load(f) == printed == json.loads(json.dumps(stats))
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    files = sorted(os.listdir(run_dir / "x"))
    assert [f for f in files if f != _video(files)] == RENDER_FILES
    assert not (run_dir / "render").exists()

    # the restored step-2 weights rendered those views: the same Trainer
    # restored by hand renders view 0's depth again
    trainer = Trainer(config.load_config(str(cfg_path), {"run_eval": True}))
    try:
        assert trainer.state.step == 2
        s = trainer.dataset.get_image(0)
        _, _, depth = trainer._renderer(trainer._view_rays(s))
        np.testing.assert_array_equal(depth.reshape(12, 16).numpy(), np.load(run_dir / "x" / "depth000.npy"))
    finally:
        trainer.close()


def test_test_scores_lpips_from_exported_weights(tmp_path, monkeypatch):
    # AONERF_LPIPS_WEIGHTS naming an exported file: test() scores LPIPS per
    # view (the weights loaded once) and summarizes it as the JAX Trainer
    # does, on a 32x24 scene (VGG's fifth tap needs 16 pixels a side) with
    # bridged weights and random LPIPS weights of narrow widths. The renders
    # agree within ~1.5e-5 (above); LPIPS within 1e-4 relative.
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=(32, 24), n_train=1, n_val=1, n_test=2)
    weights = tmp_path / "lpips.npz"
    lpips.write_random_weights(str(weights), seed=0, widths=(8, 8, 16, 16, 32, 32, 32, 64, 64, 64, 64, 64, 64))
    monkeypatch.setenv("AONERF_LPIPS_WEIGHTS", str(weights))
    settings = {**_settings(root, tmp_path / "out", "jax"), "img_wh": [32, 24]}
    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    try:
        params = jax.device_get(jtrainer.state.params)
        want = jtrainer.test()
    finally:
        jtrainer.close()
    loads = []
    real_load = lpips.load_weights
    monkeypatch.setattr(lpips, "load_weights", lambda *a, **k: loads.append(a) or real_load(*a, **k))
    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        trainer.model.load_state_dict(nerf_state_dict_from_flax(params))
        got = trainer.test()
    finally:
        trainer.close()
    assert len(loads) == 1  # once per test(), not once per view
    with open(tmp_path / "out" / "port" / "results.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert list(got["lpips"]) == list(want["lpips"]) == ["test"]
    assert np.isfinite(got["lpips"]["test"]) and got["lpips"]["test"] > 0
    np.testing.assert_allclose(got["lpips"]["test"], want["lpips"]["test"], rtol=1e-4)
    np.testing.assert_allclose(got["psnr"]["test"], want["psnr"]["test"], atol=1e-3, rtol=0)
