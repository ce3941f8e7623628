"""``aonerf_torch.cli.export_voxels --platform cpu`` against
``tools/export_voxels.py`` on a tiny trained auto-encoder run, from the same
bridged checkpoint: the codes encoded from the chosen view on each side, the
same summary, the same occupancy PLY, the same mesh."""

import json
import os

import torch

from aonerf_torch.data import synthetic
from tests.torch_export import ROOT, gap_level, run_both, train_and_bridge
from tests.torch_release import release_after_module  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WH = (64, 48)  # the encoder's layer4 maps are 2x2 (at 32x24 instance norm zeroes them)


def test_ae_export_matches_the_jax_tool(tmp_path, capsys):
    root = synthetic.generate_multi_scene(str(tmp_path / "multi"), img_wh=WH, n_instances=2, degrees=(0, 10, 20),
                                          n_images=2, val_degrees=(5, 15), n_val_images=1)
    with open(os.path.join(ROOT, "config", "ae_art.json")) as f:
        settings = json.load(f)
    settings.update({"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": list(WH), "platform": "cpu",
                     "num_coarse_samples": 4, "num_fine_samples": 4, "batch_size": 16, "chunk": 1024,
                     "inner_steps": 1, "val_every_steps": 1000, "lr_delay_steps": 0})
    paths, grid = train_and_bridge(settings, tmp_path)
    # each tool encodes the view itself: the codes differ by the encoder's
    # fp32 rounding (up to 6.5e-5, 2e-5 of their largest entry, measured),
    # which the field carries to 8e-4 of the grid's largest value (1.2e-5
    # from the same codes); that moves a vertex up to 8.0e-3 along its
    # 0.3-long edge where the edge's two values lie close
    got = run_both(paths, tmp_path, capsys, gap_level(grid), extra=("--instance", "1", "--articulation", "1"),
                   vert_tol=2e-2)
    assert got["occupied"] > 0 and got["mesh_faces"] > 0
