"""Export a trained field's geometry: checkpoint -> occupancy point PLY, and
with --mesh a marching-tetrahedra triangle mesh PLY (counterpart of
``tools/export_voxels.py``).

The run's latest checkpoint is restored by the port's Trainer; the R^3
density grid is evaluated on the card (``viz/voxelgrid.py``) unless
``--platform cpu``, and meshed on the host (``viz/mesh.py``). Prints one
JSON summary: out, occupied, resolution, threshold, step, and with --mesh
also mesh, mesh_verts, mesh_faces.

Usage:
  # vanilla run
  python -m aonerf_torch.cli.export_voxels --config run.json --out occ.ply

  # auto-decoder run: an instance at an articulation (its learned codes);
  # auto-encoder run: the same flags, the codes encoded from that view
  python -m aonerf_torch.cli.export_voxels --config run.json --out occ.ply \\
      --instance 0 --articulation 0 [--resolution 128] [--threshold 10] \\
      [--bbox -1.5 1.5] [--mesh mesh.ply] [--platform cpu]

Any Config field can be overridden as --<name> <value>, as with
``aonerf_torch.cli.train``.
"""

import argparse
import json
from typing import Dict

import numpy as np

from aonerf_torch.cli.train import add_config_fields, config_overrides
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils.config import load_config
from aonerf_torch.viz import voxelgrid as vg
from aonerf_torch.viz.mesh import marching_tetrahedra, write_mesh_ply
from aonerf_torch.viz.pointcloud import write_ply


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, required=True, help="train config JSON")
    p.add_argument("--out", type=str, required=True, help="output .ply path")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--threshold", type=float, default=10.0)
    p.add_argument("--bbox", type=float, nargs=2, default=(-1.5, 1.5), help="cubic bbox [lo, hi] on every axis")
    p.add_argument("--instance", type=int, default=0, help="articulated runs")
    p.add_argument("--articulation", type=int, default=0, help="articulated runs")
    p.add_argument("--mesh", type=str, default=None,
                   help="also write the isosurface at --threshold as a triangle-mesh PLY to this path")
    add_config_fields(p)
    return p.parse_args(argv)


def density_fn_for(trainer, instance: int = 0, articulation: int = 0):
    """The density adapter of a Trainer's restored model: the vanilla field;
    the auto-decoder at the codes of ``instance`` at ``articulation``; the
    auto-encoder at the codes encoded from that pair's first view."""
    exp_type = trainer.cfg.exp_type
    if exp_type == "vanilla":
        return vg.nerf_density_fn(trainer.model)
    if exp_type == "vanilla_autodecoder":
        return vg.articulated_density_fn(trainer.model, trainer._latents_for(instance, articulation))
    latents, _ = trainer._render_setup(trainer.dataset.get_image(instance, articulation, 0))
    return vg.ae_density_fn(trainer.model, latents)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = load_config(args.config, config_overrides(args))
    trainer = Trainer(cfg)
    try:
        step = int(trainer.state.step)
        if step <= 0:
            raise SystemExit(f"no trained checkpoint found for {cfg.exp_name!r}")
        fn = density_fn_for(trainer, args.instance, args.articulation)
        lo, hi = args.bbox
        bbox_min, bbox_max = (lo,) * 3, (hi,) * 3
        grid = vg.density_grid(fn, bbox_min, bbox_max, args.resolution, device=trainer.device)
        pts = vg.occupied_points(grid, bbox_min, bbox_max, args.threshold)
        summary = {
            "out": write_ply(args.out, pts.astype(np.float32)), "occupied": int(len(pts)),
            "resolution": args.resolution, "threshold": args.threshold, "step": step,
        }
        if args.mesh:
            verts, faces = marching_tetrahedra(grid, args.threshold, bbox_min, bbox_max)
            summary["mesh"] = write_mesh_ply(args.mesh, verts, faces)
            summary["mesh_verts"] = int(len(verts))
            summary["mesh_faces"] = int(len(faces))
    finally:
        trainer.close()
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
