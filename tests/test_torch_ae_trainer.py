"""The port's auto-encoder Trainer on the CPU: a checkpoint round trip with
the encoder, the state decoder and the degree embedding, the published
config's model, what the Trainer still refuses and the settings it now
trains (one encode for several steps, the reference's optimizers, a dataset
whose instances differ in articulation count). Its ``validate`` and
``test`` are held to the JAX Trainer's in tests/test_torch_ae_validate.py and
tests/test_torch_ae_test.py."""

import json
import os
import shutil

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

WH = (64, 48)  # the encoder's layer4 maps are 2x2


def scene(root, val: bool = True, **kwargs):
    return synthetic.generate_multi_scene(str(root), img_wh=WH, n_instances=2, degrees=(0, 10, 20), n_images=2,
                                          val_degrees=(5, 15) if val else (), n_val_images=1, **kwargs)


def settings(root, out, name, **extra):
    with open(os.path.join(ROOT, "config", "ae_art.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": list(WH), "platform": "cpu",
                "num_coarse_samples": 8, "num_fine_samples": 8, "batch_size": 16, "chunk": 1024, "inner_steps": 2,
                "limit_val_batches": 3, "val_every_steps": 2, "ckpt_every_steps": 2})
    cfg.update(extra)
    return cfg


def _fit(cfg, max_steps):
    trainer = Trainer(config.load_config(None, cfg))
    try:
        last = trainer.fit(max_steps=max_steps)
        return trainer.state, last
    finally:
        trainer.close()


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    root = scene(tmp_path / "scene")
    unbroken, _ = _fit(settings(root, tmp_path / "out", "unbroken", val_every_steps=100), 4)
    broken = settings(root, tmp_path / "out", "broken")
    _, last = _fit(broken, 2)
    assert {"loss_state", "opacity_loss", "val_state_error_rad", "val_abs_state_error_deg"} <= set(last)
    saved = CheckpointManager(str(tmp_path / "out" / "broken" / "ckpts")).restore(2)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    for name in ("encoder.conv1.weight", "encoder.articulation_fc.weight", "joint_state_decoder.Dense_2.weight",
                 "deg_embedding.weight", "field.fine_mlp.deform_0.weight"):
        assert name in saved["params"] and saved["opt_state"]["nu"][name].abs().sum() > 0, name
    resumed, _ = _fit({**broken, "val_every_steps": 100}, 4)  # restores step 2 with its moments
    assert resumed.step == unbroken.step == 4 and resumed.opt_state.count == 4
    assert list(resumed.params) == list(unbroken.params)
    for a, b in zip(resumed.params.values(), unbroken.params.values()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_state.slots["mu"] + resumed.opt_state.slots["nu"],
                    unbroken.opt_state.slots["mu"] + unbroken.opt_state.slots["nu"]):
        assert torch.equal(a, b)


def test_trainer_builds_the_published_ae_config(tmp_path):
    root = scene(tmp_path / "scene")
    cfg = config.load_config(os.path.join(ROOT, "config", "ae_art.json"),
                             {"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": list(WH),
                              "platform": "cpu"})
    assert (cfg.batch_size, cfg.chunk, cfg.lr_init, cfg.latent_dense) == (4096, 3840, 2.5e-4, True)
    assert (cfg.ae_opacity_loss, cfg.ae_photometric, cfg.opacity_lambda) == ("bce_prob", "masked", 0.5)
    assert config.jax_only_settings(cfg) == {} and cfg.extras == {"_comment": cfg.extras["_comment"]}
    trainer = Trainer(cfg)
    try:
        model = trainer.model
        assert trainer.code_library is None and trainer.articulated and trainer.autoencoder
        assert model.field.coarse_mlp.latent_dense and model.field.num_fine_samples == 128
        assert model.field.sigma_activation == "softplus" and model.field.sigma_cap == 500.0
        assert model.field.tail_to_background and model.field.rgb_padding == 0.0
        assert model.deg_embedding.weight.shape == (91, 32)
        assert sorted({n.split(".")[0] for n in trainer.state.params}) == [
            "deg_embedding", "encoder", "field", "joint_state_decoder"]
        with pytest.raises(ValueError, match="auto-decoder"):
            trainer.optimize_instance_codes()
    finally:
        trainer.close()


# what each case does now: refused as not ported (NotImplementedError), refused
# as JAX refuses it (ValueError), or trained
EXPECTED = {"ae_views_per_step": ValueError, "ae_encode_reuse": "trains", "compute_dtype": NotImplementedError,
            "noise_std": "trains", "optimizer": "trains", "lr_scheduler": "trains",
            "dataset_name": NotImplementedError}


@pytest.mark.parametrize("overrides", [
    # several views a step and one encode for several steps are alternatives
    # (JAX's ValueError); one encode for 4 steps, sigma noise, the
    # reference's optimizers and schedules train; a dtype the port does not
    # run is refused
    {"ae_views_per_step": 2, "ae_encode_reuse": 2}, {"ae_encode_reuse": 4}, {"compute_dtype": "fp16"},
    {"noise_std": 1.0},
    {"optimizer": "ranger"}, {"lr_scheduler": "cosine"}, {"dataset_name": "sapien"},
], ids=lambda o: next(iter(o)))
def test_trainer_refuses_what_the_ae_does_not_run(overrides, tmp_path):
    expected = EXPECTED[next(iter(overrides))]
    if expected is NotImplementedError:
        with pytest.raises(NotImplementedError):
            Trainer(config.load_config(None, {"exp_type": "vanilla_ae_art", "dataset_name": "sapien_multi",
                                              "platform": "cpu", **overrides}))
        return
    cfg = settings(scene(tmp_path / "scene", val=False), tmp_path / "out", "run", inner_steps=4,
                   val_every_steps=100, **overrides)
    if expected is ValueError:
        with pytest.raises(ValueError, match="alternative"):
            Trainer(config.load_config(None, cfg))
        return
    state, last = _fit(cfg, 4)
    assert state.step == state.opt_state.count == 4 and np.isfinite(last["loss"]), last
    if "optimizer" in overrides:  # Ranger keeps the slow weights
        assert set(state.opt_state.slots) == {"mu", "nu", "slow"}


def test_non_rectangular_dataset_is_refused(tmp_path):
    # instance 1 lacks the 20-degree articulation: device_buffers refuses it,
    # and fit trains on batches assembled on the host (one step a call),
    # validates, checkpoints and closes its prefetcher
    root = scene(tmp_path / "scene", val=False)
    second = sorted(os.listdir(root))[1]
    shutil.rmtree(os.path.join(root, second, "train", "20_degree"))
    trainer = Trainer(config.load_config(None, settings(root, tmp_path / "out", "ragged")))
    try:
        with pytest.raises(ValueError, match="uniform"):
            trainer.train_buffers()
        last = trainer.fit(max_steps=3)
        assert trainer.state.step == trainer.state.opt_state.count == 3 and trainer._prefetcher is None
        assert np.isfinite(last["loss"]) and np.isfinite(last["val_psnr"]) and "val_state_error_rad" in last
        assert CheckpointManager(str(tmp_path / "out" / "ragged" / "ckpts")).steps() == [2, 3]
    finally:
        trainer.close()


def test_cli_refuses_run_optimize_for_the_ae(tmp_path):
    root = scene(tmp_path / "scene", val=False)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(settings(root, tmp_path / "out", "cli")))
    with pytest.raises(ValueError, match="auto-decoder"):
        cli.main(["--config", str(cfg_path), "--run_optimize"])


def test_ae_trainer_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root = scene(tmp_path / "scene", val=False)
    cfg = settings(root, tmp_path / "out", "nodevice")
    del cfg["platform"]
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(config.load_config(None, cfg))
