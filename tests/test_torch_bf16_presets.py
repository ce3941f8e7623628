"""The articulated bf16 presets through the port's Trainer on the CPU:
config/autodecoder_tpu_fast.json, config/ae_art_tpu_quality.json and
config/ae_art_tpu_fast.json as they stand but for a small scene (16x12 for
the auto-decoder, 64x48 for the auto-encoder, whose layer4 maps need it),
4 + 8 samples, a small batch and 2 steps a dispatch: each trains, validates
and checkpoints fp32 tensors, the fp32 and the bf16 Trainer both restore
that checkpoint, and the sweep (2 poses) and, for the auto-decoder, the code
inversion run in bf16."""

import json
import os

import numpy as np
import pytest
import torch

from aonerf_torch.cli import train as cli
from aonerf_torch.data import synthetic
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import config
from aonerf_torch.utils.ckpt import CheckpointManager
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

# preset -> (its published settings, the scene size it is cut to, its batch there)
PRESETS = {
    "autodecoder_tpu_fast": ({"exp_type": "vanilla_autodecoder", "batch_size": 176, "inner_steps": 233,
                              "latent_dense": True, "ae_views_per_step": 1}, (16, 12), 32),
    # latent_dense is the Config's default (True), which this preset keeps
    "ae_art_tpu_quality": ({"exp_type": "vanilla_ae_art", "batch_size": 160, "inner_steps": 256,
                            "latent_dense": True, "ae_views_per_step": 1}, (64, 48), 32),
    "ae_art_tpu_fast": ({"exp_type": "vanilla_ae_art", "batch_size": 768, "inner_steps": 25,
                         "latent_dense": True, "ae_views_per_step": 2}, (64, 48), 32),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_trains_validates_checkpoints_and_restores(tmp_path, name):
    published, wh, batch = PRESETS[name]
    path = os.path.join(ROOT, "config", f"{name}.json")
    with open(path) as f:
        preset = json.load(f)
    cfg0 = config.load_config(path)
    assert cfg0.compute_dtype == "bf16" and cfg0.grad_clip == 1.0
    assert {k: getattr(cfg0, k) for k in published} == published
    root = synthetic.generate_multi_scene(str(tmp_path / "multi"), img_wh=wh, degrees=(0, 10, 20), n_images=2,
                                          val_degrees=(5, 15), n_val_images=1)
    cut = ["--platform", "cpu", "--root_dir", root, "--output_path", str(tmp_path / "out"),
           "--img_wh", json.dumps(list(wh)), "--num_coarse_samples", "4", "--num_fine_samples", "8",
           "--batch_size", str(batch), "--chunk", "256", "--inner_steps", "2", "--lr_delay_steps", "0"]
    metrics = cli.main(["--config", path, *cut, "--val_every_steps", "4", "--ckpt_every_steps", "4",
                        "--limit_val_batches", "1", "--max_steps", "4"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "psnr0", "psnr1", "val_psnr", "val_psnr_obj"))
    if published["exp_type"] == "vanilla_ae_art":
        assert np.isfinite(metrics["val_state_error_rad"]) and np.isfinite(metrics["loss_state"])
    run_dir = tmp_path / "out" / preset["exp_name"]
    assert CheckpointManager(str(run_dir / "ckpts")).steps() == [4]
    saved = CheckpointManager(str(run_dir / "ckpts")).restore()
    tensors = [*saved["params"].values(), *saved["opt_state"]["mu"].values(), *saved["opt_state"]["nu"].values()]
    assert tensors and all(v.dtype == torch.float32 for v in tensors)

    overrides = {"platform": "cpu", "root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": list(wh),
                 "num_coarse_samples": 4, "num_fine_samples": 8, "batch_size": batch, "chunk": 256}
    for dtype in ("f32", "bf16"):  # either mode restores the bf16 run's checkpoint
        trainer = Trainer(config.load_config(path, {**overrides, "compute_dtype": dtype}))
        try:
            field = trainer.model.field if trainer.autoencoder else trainer.model
            assert field.compute_dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
            assert trainer.state.step == 4
            for n, p in trainer.state.params.items():
                assert p.dtype == torch.float32 and torch.equal(p, saved["params"][n]), n
            if dtype == "bf16" and not trainer.autoencoder:
                codes, history = trainer.optimize_instance_codes(n_steps=2, batch_size=batch)
                assert all(v.dtype == torch.float32 for v in codes.values()) and np.isfinite(history["psnr1"]).all()
        finally:
            trainer.close()

    stats = cli.main(["--config", path, *cut, "--run_eval", "--test_sweep_poses", "2"])
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    assert len([f for f in os.listdir(run_dir / "render") if f.startswith("image")]) == 2
