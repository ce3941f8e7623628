"""``aonerf_torch.cli.export_voxels --platform cpu`` against
``tools/export_voxels.py`` on a tiny trained run of the vanilla field and of
the auto-decoder, from the same bridged checkpoint: the same summary, the
same occupancy PLY, the same mesh."""

import os

import pytest
import torch

from aonerf_torch.cli import export_voxels as cli
from aonerf_torch.data import synthetic
from tests.torch_export import ROOT, gap_level, run_both, train_and_bridge
from tests.torch_release import release_after_module  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WH = (16, 12)


def _small(root, out, **extra):
    return {"root_dir": root, "output_path": str(out), "img_wh": list(WH), "platform": "cpu", "num_coarse_samples": 4,
            "num_fine_samples": 4, "batch_size": 16, "chunk": 64, "inner_steps": 1, "val_every_steps": 1000,
            "lr_delay_steps": 0, "lr_init": 5e-3, **extra}


def test_vanilla_export_matches_the_jax_tool(tmp_path, capsys):
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=WH, n_train=2, n_val=1, n_test=0)
    paths, grid = train_and_bridge(_small(root, tmp_path / "out"), tmp_path)
    got = run_both(paths, tmp_path, capsys, gap_level(grid))
    assert got["occupied"] > 0 and got["mesh_faces"] > 0
    # the default threshold of 10 on a 2-step field: both tools agree too
    run_both(paths, tmp_path, capsys, 10.0, extra=("--bbox", "-1.0", "1.2"))


def test_autodecoder_export_matches_the_jax_tool(tmp_path, capsys):
    import json

    root = synthetic.generate_multi_scene(str(tmp_path / "multi"), img_wh=WH, n_instances=2, degrees=(0, 10, 20),
                                          n_images=2, val_degrees=(5, 15), n_val_images=1)
    with open(os.path.join(ROOT, "config", "autodecoder.json")) as f:
        settings = {**json.load(f), **_small(root, tmp_path / "out", batch_size=32)}
    paths, grid = train_and_bridge(settings, tmp_path)
    got = run_both(paths, tmp_path, capsys, gap_level(grid), extra=("--instance", "1", "--articulation", "2"))
    assert got["occupied"] > 0 and got["mesh_faces"] > 0


def test_export_refuses_without_a_card_or_a_checkpoint(tmp_path):
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=WH, n_train=1, n_val=1, n_test=0)
    path = tmp_path / "cfg.json"
    path.write_text(__import__("json").dumps({**_small(root, tmp_path / "out"), "platform": None}))
    argv = ["--config", str(path), "--out", str(tmp_path / "occ.ply")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    with pytest.raises(SystemExit, match="no trained checkpoint"):
        cli.main(argv + ["--platform", "cpu"])
