"""The vanilla NeRF's bf16 mode through the port's Trainer on the CPU:
config/vanilla_tpu_fast.json (bf16, batch 224, grad_clip 1.0, chunk 256) as
it stands but for a reduced scene, samples and step count, trains, validates
and checkpoints fp32 tensors; the fp32 Trainer loads that checkpoint; what
the articulated types still refuse in bf16."""

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "config", "vanilla_tpu_fast.json")
torch.set_num_threads(2)


def test_fast_preset_trains_validates_and_checkpoints_fp32(tmp_path):
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=1)
    with open(FAST) as f:
        preset = json.load(f)
    assert (preset["compute_dtype"], preset["batch_size"], preset["grad_clip"], preset["chunk"]) == ("bf16", 224, 1.0, 256)
    cut = ["--platform", "cpu", "--root_dir", root, "--output_path", str(tmp_path / "out"), "--img_wh", "[16,12]",
           "--num_coarse_samples", "4", "--num_fine_samples", "8", "--inner_steps", "3", "--lr_delay_steps", "0",
           "--val_every_steps", "6", "--ckpt_every_steps", "6", "--limit_val_batches", "1"]
    metrics = cli.main(["--config", FAST, *cut, "--max_steps", "6"])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    run_dir = tmp_path / "out" / preset["exp_name"]
    assert CheckpointManager(str(run_dir / "ckpts")).steps() == [6]
    saved = CheckpointManager(str(run_dir / "ckpts")).restore()
    tensors = [*saved["params"].values(), *saved["opt_state"]["mu"].values(), *saved["opt_state"]["nu"].values()]
    assert tensors and all(v.dtype == torch.float32 for v in tensors)
    assert os.listdir(run_dir / "val_vis") == ["step0000006.png"]

    overrides = {"platform": "cpu", "root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": [16, 12],
                 "num_coarse_samples": 4, "num_fine_samples": 8}
    for dtype in ("bf16", "f32"):  # either mode restores the bf16 run's checkpoint
        trainer = Trainer(config.load_config(FAST, {**overrides, "compute_dtype": dtype}))
        try:
            assert trainer.model.compute_dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
            assert trainer.state.step == 6
            for n, p in trainer.state.params.items():
                assert p.dtype == torch.float32 and torch.equal(p, saved["params"][n]), n
            assert all(torch.equal(m, saved["opt_state"]["mu"][n])
                       for m, n in zip(trainer.state.opt_state.slots["mu"], trainer.state.params))
        finally:
            trainer.close()


@pytest.mark.parametrize("exp_type", ["vanilla_autodecoder", "vanilla_ae_art"])
def test_articulated_types_refuse_bf16(exp_type):
    # The articulated types run bf16 (tests/test_torch_bf16_presets.py); in
    # bf16 they still refuse what neither mode runs, and no dtype but fp32
    # and bf16 runs.
    base = {"exp_type": exp_type, "dataset_name": "sapien_multi", "platform": "cpu"}
    with pytest.raises(NotImplementedError, match="n_model_shards"):
        Trainer(config.load_config(None, {**base, "compute_dtype": "bf16", "n_model_shards": 2}))
    with pytest.raises(NotImplementedError, match="compute_dtype='fp16'"):
        Trainer(config.load_config(None, {**base, "compute_dtype": "fp16"}))


def test_unknown_compute_dtype_is_refused():
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        Trainer(config.load_config(None, {"platform": "cpu", "compute_dtype": "fp16"}))
