"""``aonerf_torch.cli.export_voxels --platform cpu`` at other encoding
degrees against ``tools/export_voxels.py`` (whose JAX Trainer builds the
vanilla NeRF at the config's degrees), from the same bridged checkpoint of a
tiny run at (min_deg_point, max_deg_point, deg_view) = (0, 8, 2): the same
summary, the same occupancy PLY, the same mesh (tests/torch_export.py's
comparison and tolerance)."""

import torch

from aonerf_torch.data import synthetic
from tests.test_torch_export_voxels import WH, _small
from tests.torch_export import gap_level, run_both, train_and_bridge
from tests.torch_release import release_after_module  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)


def test_vanilla_export_at_other_degrees_matches_the_jax_tool(tmp_path, capsys):
    root = synthetic.generate_single_scene(str(tmp_path / "scene"), img_wh=WH, n_train=2, n_val=1, n_test=0)
    # lr 1e-3: at the default tests' 5e-3 two steps leave this field's density 0 everywhere, and the tools
    # would agree on an empty grid
    settings = _small(root, tmp_path / "out", min_deg_point=0, max_deg_point=8, deg_view=2, lr_init=1e-3)
    paths, grid = train_and_bridge(settings, tmp_path)
    got = run_both(paths, tmp_path, capsys, gap_level(grid))
    assert got["occupied"] > 0 and got["mesh_faces"] > 0
