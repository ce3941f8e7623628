"""The port's auto-decoder Trainer on the CPU against the JAX Trainer:
``validate``'s rotating (instance, articulation, view) schedule and its
held-out conditioning, ``test()``'s articulation sweep with bridged weights,
a checkpoint round trip with the codes and their Adam moments, the CLI's
``--run_optimize``, and what the Trainer still refuses."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import config as jconfig
from aonerf_torch.cli import train as cli
from aonerf_torch.data import synthetic
from aonerf_torch.data.sapien_multi import DEFAULT_VAL_DEGREES
from aonerf_torch.train.loop import Trainer, _check_supported
from aonerf_torch.utils import config
from aonerf_torch.utils.bridge import articulated_state_dict_from_flax, codes_state_dict_from_flax
from aonerf_torch.utils.ckpt import CheckpointManager
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

WH = (16, 12)
N_SWEEP = 19


def _scene(root, val: bool):
    return synthetic.generate_multi_scene(str(root), img_wh=WH, n_instances=2, degrees=(0, 10, 20, 30), n_images=2,
                                          val_degrees=(5, 15, 25) if val else (), n_val_images=1)


def _settings(root, out, name, **extra):
    with open(os.path.join(ROOT, "config", "autodecoder.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": str(out), "exp_name": name, "img_wh": list(WH), "platform": "cpu",
                "num_coarse_samples": 8, "num_fine_samples": 8, "batch_size": 16, "chunk": 64, "inner_steps": 2,
                "limit_val_batches": 3, "val_every_steps": 2, "ckpt_every_steps": 2})
    cfg.update(extra)
    return cfg


def _record(obj, name, calls, key=lambda *a, **k: a):
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        calls.append(key(*args, **kwargs))
        return real(*args, **kwargs)

    setattr(obj, name, wrapper)


@pytest.mark.parametrize("val", [True, False], ids=["held_out", "train_views"])
def test_validate_schedule_matches_jax(tmp_path, val):
    root = _scene(tmp_path / "scene", val)
    settings = _settings(root, tmp_path / "out", "jax")
    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        assert trainer.val_dataset.uses_val_split == jtrainer.val_dataset.uses_val_split == val
        assert (trainer.val_dataset is trainer.dataset) == (not val)
        # JAX renders nothing here: its schedule is what get_image and
        # _render_setup are asked for
        n = WH[0] * WH[1]
        jtrainer._renderer = lambda params, rays, latents: (jnp.zeros((n, 3)), jnp.zeros(n), jnp.zeros(n))
        for step in (0, 6, 10):
            jtrainer.state = jtrainer.state.replace(step=jnp.asarray(step, jnp.int32))
            trainer.state.step = step
            calls = {"jax": ([], []), "port": ([], [])}
            for side, t in (("jax", jtrainer), ("port", trainer)):
                _record(t.val_dataset, "get_image", calls[side][0])
                _record(t, "_render_setup", calls[side][1],
                        key=lambda img, is_test=False: (int(img["instance_id"]), int(img["articulation_id"]), is_test))
            want = jtrainer.validate()
            got = trainer.validate()
            for t in (jtrainer, trainer):
                del t.val_dataset.get_image, t._render_setup
            assert calls["port"] == calls["jax"], step
            assert len(calls["port"][0]) == 3 and all(c[2] == val for c in calls["port"][1])
            assert set(got) == set(want) == {"psnr", "psnr_obj"} and all(np.isfinite(v) for v in got.values())
        if val:  # held-out 5/15/25 degrees -> the midpoints 1/3/5 of the 2N-1 sweep
            assert [trainer._interp_articulation_id(np.deg2rad(d)) for d in (5, 15, 25)] == [1, 3, 5]
        grids = sorted(os.listdir(tmp_path / "out" / "port" / "val_vis"))
        assert grids == ["step0000000.png", "step0000006.png", "step0000010.png"]
    finally:
        jtrainer.close()
        trainer.close()


RENDER_FILES = sorted(
    [f"image{i:03d}.jpg" for i in range(N_SWEEP)] + [f"depth{i:03d}.{e}" for i in range(N_SWEEP) for e in ("png", "npy")]
    + [f"depth_raw{i:03d}.png" for i in range(N_SWEEP)] + ["depth_raw.npz"]
    + [f"opacity{i:03d}.png" for i in range(N_SWEEP)]
)


def test_test_sweep_matches_the_jax_trainer(tmp_path, monkeypatch):
    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = _scene(tmp_path / "scene", val=False)
    settings = _settings(root, tmp_path / "out", "jax", run_eval=True, render_instance=1)
    jtrainer = JaxTrainer(jconfig.load_config(None, settings))
    try:
        params = jax.device_get(jtrainer.state.params)
        want = jtrainer.test()
    finally:
        jtrainer.close()

    trainer = Trainer(config.load_config(None, {**settings, "exp_name": "port"}))
    try:
        assert trainer.dataset.split == "test" and trainer.val_dataset is trainer.dataset
        trainer.model.load_state_dict(articulated_state_dict_from_flax(params["model"]))
        trainer.code_library.load_state_dict(codes_state_dict_from_flax(params["codes"]))
        got = trainer.test()
    finally:
        trainer.close()

    port_dir, jax_dir = tmp_path / "out" / "port", tmp_path / "out" / "jax"
    with open(port_dir / "results.json") as f, open(jax_dir / "results.json") as g:
        saved, jax_saved = json.load(f), json.load(g)
    assert saved == json.loads(json.dumps(got))
    assert list(saved) == list(jax_saved) == ["psnr", "ssim", "lpips", "psnr_obj"]
    # the port's fp32 render against JAX's jitted one, at full width: PSNR
    # within 1e-3 dB and SSIM within 1e-5, as tests/test_torch_test.py holds
    # the vanilla test()
    for name, tol in (("psnr", 1e-3), ("ssim", 1e-5), ("psnr_obj", 1e-3)):
        assert list(saved[name]) == list(jax_saved[name]) == ["test"]
        assert np.isfinite(saved[name]["test"])
        np.testing.assert_allclose(saved[name]["test"], jax_saved[name]["test"], atol=tol, rtol=0, err_msg=name)
    assert np.isnan(saved["lpips"]["test"]) and np.isnan(jax_saved["lpips"]["test"])
    files, jax_files = sorted(os.listdir(port_dir / "render")), sorted(os.listdir(jax_dir / "render"))
    assert files == jax_files
    assert [f for f in files if not f.startswith("video.")] == RENDER_FILES
    a, b = np.load(port_dir / "render" / "depth_raw.npz"), np.load(jax_dir / "render" / "depth_raw.npz")
    for k in b.files:  # the vanilla test()'s depth tolerance (tests/test_torch_test.py)
        np.testing.assert_allclose(a[k], b[k], atol=5e-4, rtol=0, err_msg=k)


def _fit(settings, max_steps):
    trainer = Trainer(config.load_config(None, settings))
    try:
        trainer.fit(max_steps=max_steps)
        return trainer.state
    finally:
        trainer.close()


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    root = _scene(tmp_path / "scene", val=True)
    unbroken = _fit(_settings(root, tmp_path / "out", "unbroken", val_every_steps=100), 4)
    broken = _settings(root, tmp_path / "out", "broken", val_every_steps=100)
    _fit(broken, 2)
    saved = CheckpointManager(str(tmp_path / "out" / "broken" / "ckpts")).restore(2)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    for table in ("shape", "appearance", "articulation"):
        name = f"codes.embedding_instance_{table}.weight"
        assert name in saved["params"] and saved["opt_state"]["mu"][name].abs().sum() > 0, name
    resumed = _fit(broken, 4)  # restores step 2: params, codes and their moments
    assert resumed.step == unbroken.step == 4 and resumed.opt_state.count == 4
    assert list(resumed.params) == list(unbroken.params)
    for a, b in zip(resumed.params.values(), unbroken.params.values()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_state.slots["mu"] + resumed.opt_state.slots["nu"],
                    unbroken.opt_state.slots["mu"] + unbroken.opt_state.slots["nu"]):
        assert torch.equal(a, b)


def test_cli_run_optimize_prints_the_psnr1_history(tmp_path, capsys):
    root = _scene(tmp_path / "scene", val=False)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_settings(root, tmp_path / "out", "cli", val_every_steps=100)))
    cli.main(["--config", str(cfg_path), "--max_steps", "2"])
    capsys.readouterr()
    assert cli.parse_args(["--run_optimize"]).run_optimize is True
    out = cli.main(["--config", str(cfg_path), "--run_optimize", "--optimize_steps", "2", "--optimize_instance", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and list(out) == ["psnr1"]
    assert len(out["psnr1"]) == 1 and np.isfinite(out["psnr1"]).all()  # one group of 50 steps
    saved = np.load(tmp_path / "out" / "cli" / "optimized_codes.npz")
    assert sorted(saved.files) == ["color", "density", "history_psnr1"]
    assert saved["density"].shape == saved["color"].shape == (1, 128)
    np.testing.assert_array_equal(saved["history_psnr1"], out["psnr1"])


def test_trainer_builds_the_published_autodecoder_config(tmp_path):
    root = _scene(tmp_path / "scene", val=True)
    cfg = config.load_config(os.path.join(ROOT, "config", "autodecoder.json"),
                             {"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": list(WH),
                              "platform": "cpu"})
    assert (cfg.n_max_objs, cfg.obj_code_dim, cfg.batch_size, cfg.chunk, cfg.latent_dense) == (4, 128, 4096, 3840, True)
    assert config.jax_only_settings(cfg) == {}
    trainer = Trainer(cfg)
    try:
        lib = trainer.code_library
        assert lib.embedding_instance_shape.weight.shape == (4, 128)
        assert lib.embedding_instance_articulation.weight.shape == (10, 32)
        assert trainer.model.coarse_mlp.latent_dense and trainer.model.num_fine_samples == 128
        assert len(trainer.state.params) == 2 * 2 * 20 + 3  # 20 layers a level, weight and bias; 3 tables
    finally:
        trainer.close()
    assert tuple(DEFAULT_VAL_DEGREES) == (5, 15, 25, 35, 45, 55, 65, 75, 85)


def test_trainer_refuses_what_the_autodecoder_does_not_run(tmp_path):
    base = {"exp_type": "vanilla_autodecoder", "dataset_name": "sapien_multi", "platform": "cpu"}
    for overrides in ({"dataset_name": "sapien"},
                      {"compute_dtype": "fp16"},  # bf16 runs
                      {"n_model_shards": 2}):  # noise_std, is_optimize run
        with pytest.raises(NotImplementedError):
            Trainer(config.load_config(None, {**base, **overrides}))
    # the codes' own AdamW (latent_lr), one encode for several auto-encoder
    # steps and replicated scene buffers run: tests/test_torch_optim.py,
    # tests/test_torch_ae_reuse.py, tests/test_torch_parallel_steps.py
    for overrides in ({"exp_type": "vanilla_ae_art", "ae_encode_reuse": 2}, {"latent_lr": 1e-3},
                      {"shard_scene_buffers": False}):
        _check_supported(config.load_config(None, {**base, **overrides}))
    root = synthetic.generate_single_scene(str(tmp_path / "single"), img_wh=WH, n_train=1, n_val=1, n_test=0)
    vanilla = Trainer(config.load_config(None, {"root_dir": root, "output_path": str(tmp_path / "out"),
                                                "img_wh": list(WH), "platform": "cpu"}))
    try:
        with pytest.raises(ValueError, match="auto-decoder"):
            vanilla.optimize_instance_codes()
    finally:
        vanilla.close()
