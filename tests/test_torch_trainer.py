"""The port's vanilla training surface on the CPU: the train CLI on a scene
written by aonerf's datagen CLI (checkpoint, resume, val grid, metrics),
loading another run's checkpoint, and
parity of its loader, scene writer, config, checkpoints and val grid with
aonerf."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from aonerf.data import sapien as jsapien
from aonerf.data import synthetic as jsyn
from aonerf.eval import viz as jviz
from aonerf.utils import config as jconfig
from aonerf_torch.cli import train as cli
from aonerf_torch.data import sapien, synthetic
from aonerf_torch.eval import viz
from aonerf_torch.train.loop import Trainer, _check_supported
from aonerf_torch.utils import config
from aonerf_torch.utils.ckpt import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _datagen(out_dir, img_wh=(16, 12), n_train=4):
    cfg = {"mode": "single", "out_dir": str(out_dir), "img_wh": list(img_wh), "n_train": n_train,
           "n_val": 1, "n_test": 1}
    path = os.path.join(os.path.dirname(str(out_dir)), "gen.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    proc = subprocess.run([sys.executable, "-m", "aonerf.data.datagen.generate", "--config", path],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return str(out_dir)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    root = _datagen(tmp_path / "scene")
    cfg = {
        "exp_type": "vanilla", "exp_name": "tiny", "dataset_name": "sapien", "root_dir": root,
        "output_path": str(tmp_path / "out"), "img_wh": [16, 12], "white_back": True,
        "num_coarse_samples": 4, "num_fine_samples": 8, "batch_size": 32, "chunk": 64,
        "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": 10, "ckpt_every_steps": 10,
        "limit_val_batches": 1,
    }
    cfg_path = str(tmp_path / "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run_dir = os.path.join(cfg["output_path"], "tiny")

    metrics = cli.main(["--config", cfg_path, "--max_steps", "20", "--platform", "cpu"])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    rows = _rows(run_dir)
    assert [r["step"] for r in rows if "train/loss" in r] == [10]
    assert [r["step"] for r in rows if "val/psnr" in r] == [10, 20]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step")
    assert CheckpointManager(os.path.join(run_dir, "ckpts")).steps() == [10, 20]
    grids = sorted(os.listdir(os.path.join(run_dir, "val_vis")))
    assert grids == ["step0000010.png", "step0000020.png"]
    assert np.asarray(Image.open(os.path.join(run_dir, "val_vis", grids[0]))).shape == (12, 16 * 4, 3)

    cli.main(["--config", cfg_path, "--max_steps", "30", "--platform", "cpu"])  # resumes at 20
    rows = _rows(run_dir)
    assert [r["step"] for r in rows if "train/loss" in r] == [10, 30]
    assert CheckpointManager(os.path.join(run_dir, "ckpts")).steps() == [10, 20, 30]
    trainer = Trainer(config.load_config(cfg_path, {"platform": "cpu"}))
    try:
        assert trainer.state.step == 30 and trainer.state.opt_state.count == 30
    finally:
        trainer.close()


@pytest.mark.parametrize("source", ["ckpt_path", "weight_path"])
def test_trainer_loads_a_checkpoint_from_another_run(tmp_path, source):
    # ckpt_path restores the whole state; weight_path the params only, with
    # the step and the optimizer starting fresh (aonerf/train/loop.py:259-269)
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=0)
    base = {"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": [16, 12], "platform": "cpu",
            "num_coarse_samples": 4, "num_fine_samples": 8, "batch_size": 16, "inner_steps": 2}
    first = Trainer(config.load_config(None, {**base, "exp_name": "first"}))
    try:
        first.state, _ = first.step_fn(first.state, first.train_buffers(), 0)
        first.ckpt.save(first.state.step, first._state_dict())
        saved = {n: p.detach().clone() for n, p in first.state.params.items()}
        saved_mu = [m.clone() for m in first.state.opt_state.slots["mu"]]
    finally:
        first.close()
    second = Trainer(config.load_config(None, {**base, "exp_name": "second",
                                               source: os.path.join(base["output_path"], "first", "ckpts")}))
    try:
        for n, p in second.state.params.items():
            assert torch.equal(p, saved[n]), n
        opt = second.state.opt_state
        if source == "ckpt_path":
            assert second.state.step == opt.count == 2
            assert all(torch.equal(a, b) for a, b in zip(opt.slots["mu"], saved_mu))
        else:
            assert second.state.step == opt.count == 0
            assert all(not m.any() for m in opt.slots["mu"])
    finally:
        second.close()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # noise_std, profile_steps, debug_nans, the launcher variants and every
    # encoding degree the kernels' layout holds run (tests/test_torch_settings.py,
    # tests/test_torch_noise.py, tests/test_torch_degrees*.py); what stays
    # refused names its ROADMAP item, a degree beyond the layout with the
    # shared memory it would need
    for overrides, item in (({"exp_type": "vanilla_ae_art"}, None), ({"compute_dtype": "fp16"}, None),
                            ({"max_deg_point": 48}, "encoded width 291: .* needs 236176 bytes .* item 11"),
                            ({"n_model_shards": 2}, "item 12, tensor parallelism")):
        with pytest.raises(NotImplementedError, match=item):
            Trainer(config.load_config(None, {"platform": "cpu", **overrides}))
    # the reference's optimizers and schedules run (tests/test_torch_optim.py),
    # and data parallelism with either scene-buffer layout (tests/test_torch_parallel*.py)
    _check_supported(config.load_config(None, {"platform": "cpu", "optimizer": "ranger", "lr_scheduler": "poly"}))
    _check_supported(config.load_config(None, {"platform": "cpu", "shard_scene_buffers": False}))
    if not torch.cuda.is_available():  # entry points default to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(config.load_config(None, {"root_dir": str(tmp_path)}))


def test_jax_only_fields_match_jax_config():
    # the port's table of the JAX Config fields it lacks: names and defaults
    jax_fields = {f.name: f.default for f in dataclasses.fields(jconfig.Config) if f.name != "extras"}
    port_fields = {f.name for f in dataclasses.fields(config.Config) if f.name != "extras"}
    assert port_fields <= set(jax_fields)
    assert config.JAX_ONLY_DEFAULTS == {n: d for n, d in jax_fields.items() if n not in port_fields}


@pytest.mark.parametrize("settings", [
    {},
    {"profile_steps": 0, "debug_nans": False, "n_model_shards": 1, "decay_step": [20], "N_max_objs": 4},
    {"is_optimize": False, "latent_lr": None, "save_path": "render", "code_reg_weight": 1e-4},
])
def test_jax_only_fields_at_their_defaults_are_accepted(settings):
    cfg = config.load_config(os.path.join(ROOT, "config", "vanilla.json"), settings)
    assert config.jax_only_settings(cfg) == {}
    _check_supported(cfg)


def test_jax_only_fields_by_alias_are_refused():
    # the optimizer's settings are Config fields now, read as JAX reads them
    settings = {"momentum": 0.5, "decay_step": [10, 20]}
    cfg, want = config.load_config(None, settings), jconfig.load_config(None, settings)
    assert (cfg.momentum, cfg.decay_step) == (want.momentum, want.decay_step) == (0.5, (10, 20))
    assert config.jax_only_settings(cfg) == {} and cfg.extras == {}
    _check_supported(cfg)
    # a field the port still lacks is refused by name
    cfg = config.load_config(None, {**settings, "n_model_shards": 3})
    assert config.jax_only_settings(cfg) == {"n_model_shards": 3}
    with pytest.raises(NotImplementedError, match="n_model_shards=3"):
        _check_supported(cfg)


def test_code_aliases_land_in_the_config():
    # the auto-decoder's code sizes are port fields now, by the reference's names too
    aliased = {"N_max_objs": 8, "N_obj_code_length": 64}
    got, want = config.load_config(None, aliased), jconfig.load_config(None, aliased)
    assert (got.n_max_objs, got.obj_code_dim) == (want.n_max_objs, want.obj_code_dim) == (8, 64)
    assert got.extras == {} and config.jax_only_settings(got) == {}


def test_write_single_scene_matches_jax_generator(tmp_path):
    a = synthetic.generate_single_scene(str(tmp_path / "port"), img_wh=(16, 12), n_train=2, n_val=1, n_test=1)
    b = jsyn.generate_single_scene(str(tmp_path / "jax"), img_wh=(16, 12), n_train=2, n_val=1, n_test=1)
    for split in ("train", "val", "test"):
        with open(os.path.join(a, split, "transforms.json")) as f, open(os.path.join(b, split, "transforms.json")) as g:
            assert json.load(f) == json.load(g)
        names = sorted(os.listdir(os.path.join(a, split, "rgb")))
        assert names == sorted(os.listdir(os.path.join(b, split, "rgb")))
        for n in names:
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(a, split, "rgb", n))),
                                          np.asarray(Image.open(os.path.join(b, split, "rgb", n))))


def test_train_buffers_match_jax(tmp_path):
    root = jsyn.generate_single_scene(str(tmp_path), img_wh=(16, 12), n_train=3, n_val=1, n_test=1)
    ds = sapien.SapienDataset(root, split="train", img_wh=(16, 12))
    jds = jsapien.SapienDataset(root, split="train", img_wh=(16, 12))
    got, want = ds.train_buffers(), jds.train_buffers()
    assert set(got) == set(want) and ds.num_rays == jds.num_rays == 3 * 16 * 12
    assert got["viewdirs"] is got["rays_d"]
    for k in want:  # fp32 ray math in the same order; PNG decoding to 1/255
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def test_config_matches_jax_for_the_vanilla_fields(tmp_path):
    path = os.path.join(ROOT, "config", "vanilla.json")
    got, want = config.load_config(path), jconfig.load_config(path)
    for f in config.Config.__dataclass_fields__:
        if f != "extras":
            assert getattr(got, f) == getattr(want, f), f
    aliased = {"N_samples": 32, "N_importance": 16, "perturb": 0, "lr": 2e-3, "use_disp": True, "save_path": "out"}
    got, want = config.load_config(None, aliased), jconfig.load_config(None, aliased)
    for f in ("num_coarse_samples", "num_fine_samples", "randomized", "lr_init", "lindisp", "render_name"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.randomized is False and got.num_coarse_samples == 32 and got.render_name == "out"


def test_checkpoints_keep_latest_best_and_unscored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step, psnr in ((1, 10.0), (2, 30.0), (3, None), (4, 20.0), (5, 5.0)):
        mgr.save(step, {"step": step, "params": {"w": torch.full((2,), float(step))}}, psnr)
    # the best two by val PSNR and the unscored one; the latest (5.0) ranks
    # below them and goes, as orbax drops it (tests/test_torch_settings.py)
    assert mgr.steps() == [2, 3, 4]
    assert mgr.latest_step() == 4
    assert torch.equal(mgr.restore()["params"]["w"], torch.full((2,), 4.0))
    assert mgr.restore(2)["step"] == 2


def test_val_grid_matches_jax():
    rng = np.random.default_rng(0)
    target, rgb = rng.uniform(size=(12 * 16, 3)), rng.uniform(size=(12 * 16, 3))
    depth, acc = rng.uniform(2, 6, 12 * 16), rng.uniform(size=12 * 16)
    np.testing.assert_array_equal(
        viz.visualize_val_rgb_opa_depth((16, 12), target, rgb, depth, acc),
        jviz.visualize_val_rgb_opa_depth((16, 12), target, rgb, depth, acc),
    )
