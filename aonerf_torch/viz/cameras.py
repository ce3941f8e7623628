"""Camera, pose and ray diagnostics rendered to image files (counterpart of
``aonerf.viz.cameras``).

The reference's visualize_nerf/ suite (interactive open3d viewers, e.g.
visualize_cameras_sapien.py) renders camera frusta, look directions, sampled
rays and scene bounds; this module renders the same diagnostics headlessly
through matplotlib into PNGs. matplotlib is imported by ``plot_cameras``
alone.

Usage:
  python -m aonerf_torch.viz.cameras --root data/scene --split train --out cams.png
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np, get_rays_np


def plot_cameras(
    c2ws: np.ndarray,
    out_path: str,
    focal: Optional[float] = None,
    img_wh=(320, 240),
    rays_per_cam: int = 0,
    near: float = 2.0,
    far: float = 6.0,
    box_half: float = 1.5,
) -> str:
    """Render camera frusta (and optionally a few rays) to ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")

    for c2w in np.asarray(c2ws):
        c2w = np.asarray(c2w)[:3, :4]
        eye = c2w[:, 3]
        ax.scatter(*eye, color="tab:blue", s=12)
        # look direction (-z axis of the camera)
        look = -c2w[:, 2]
        ax.plot(*np.stack([eye, eye + 0.8 * look], axis=1), color="tab:blue", lw=0.8)
        # frustum corners at unit depth
        if focal is not None:
            w, h = img_wh
            for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                corner_cam = np.array([sx * w / (2 * focal), sy * h / (2 * focal), -1.0])
                corner = eye + c2w[:, :3] @ corner_cam
                ax.plot(*np.stack([eye, corner], axis=1), color="tab:gray", lw=0.4)
        if rays_per_cam > 0 and focal is not None:
            w, h = img_wh
            dirs = get_ray_directions_np(h, w, focal)
            o, vd, _, _ = get_rays_np(dirs, c2w)
            pick = np.linspace(0, len(o) - 1, rays_per_cam).astype(int)
            for i in pick:
                seg = np.stack([o[i] + near * vd[i], o[i] + far * vd[i]], axis=1)
                ax.plot(*seg, color="tab:orange", lw=0.5, alpha=0.6)

    # scene bound cube
    r = box_half
    for s, e in (
        ([-r, -r, -r], [r, -r, -r]), ([-r, -r, -r], [-r, r, -r]),
        ([-r, -r, -r], [-r, -r, r]), ([r, r, r], [-r, r, r]),
        ([r, r, r], [r, -r, r]), ([r, r, r], [r, r, -r]),
    ):
        ax.plot(*np.stack([s, e], axis=1), color="tab:green", lw=0.7)

    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    ax.set_title(f"{len(c2ws)} cameras")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=str, required=True, help="dataset root")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--out", type=str, default="cameras.png")
    p.add_argument("--rays-per-cam", type=int, default=0)
    args = p.parse_args(argv)

    with open(os.path.join(args.root, args.split, "transforms.json")) as f:
        meta = json.load(f)
    c2ws = np.asarray([np.asarray(v) for v in meta["frames"].values()])
    focal = focal_from_meta(meta, (320, 240))
    path = plot_cameras(c2ws, args.out, focal=focal, rays_per_cam=args.rays_per_cam)
    print(json.dumps({"out": path, "cameras": len(c2ws)}))


if __name__ == "__main__":
    main()
