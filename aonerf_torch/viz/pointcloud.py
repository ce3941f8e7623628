"""Depth render -> world-space point cloud, and the ASCII PLY writer behind
every geometry export (counterpart of ``aonerf.viz.pointcloud``; host
NumPy).

Usage:
  python -m aonerf_torch.viz.pointcloud --depth-npy render/depth000.npy \
      --root data/scene --out cloud.ply
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np


def depth_to_points(
    depth: np.ndarray,
    c2w: np.ndarray,
    focal: float,
    rgb: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    stride: int = 1,
) -> np.ndarray:
    """Back-project an (H, W) depth map to world points.

    ``depth`` is distance along the (unnormalized, z=-1) pixel ray — the
    volumetric-rendering depth convention (comp_depth = sum w*t, with t in
    units of the unnormalized direction; helper.py:183-188). Returns
    (N, 3) or (N, 6) with colors in [0,1] appended when ``rgb`` is given.
    """
    h, w = depth.shape
    dirs = get_ray_directions_np(h, w, focal)
    c2w = np.asarray(c2w, np.float32)[:3, :4]
    world_d = dirs @ c2w[:, :3].T
    pts = c2w[:, 3] + world_d * depth[..., None]

    keep = np.isfinite(depth)
    if mask is not None:
        keep &= mask.astype(bool)
    if stride > 1:
        sub = np.zeros_like(keep)
        sub[::stride, ::stride] = True
        keep &= sub

    pts = pts[keep]
    if rgb is not None:
        pts = np.concatenate([pts, rgb[keep].reshape(-1, 3)], axis=-1)
    return pts


def write_ply(
    path: str,
    points: np.ndarray,
    edges: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
) -> str:
    """Write (N, 3) xyz or (N, 6) xyz+rgb([0,1]) points as ASCII PLY, with
    optional (E, 2) edge and/or (F, 3) triangle-face elements — the single
    PLY writer behind pointcloud/lineset/mesh export."""
    points = np.asarray(points)
    has_color = points.shape[-1] >= 6
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        if edges is not None:
            f.write(f"element edge {len(edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for p in points:
            line = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if has_color:
                c = (np.clip(p[3:6], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        if edges is not None:
            for a, b in np.asarray(edges, dtype=np.int64):
                f.write(f"{a} {b}\n")
        if faces is not None:
            for a, b, c in np.asarray(faces, dtype=np.int64):
                f.write(f"3 {a} {b} {c}\n")
    return path


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--depth-npy", type=str, required=True,
                   help="(H, W) or (N, H, W) depth .npy from an eval render")
    p.add_argument("--root", type=str, required=True, help="dataset root")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--out", type=str, default="cloud.ply")
    p.add_argument("--stride", type=int, default=2)
    args = p.parse_args(argv)

    with open(os.path.join(args.root, args.split, "transforms.json")) as f:
        meta = json.load(f)
    frames = list(meta["frames"].values())
    depths = np.load(args.depth_npy)
    if depths.ndim == 2:
        depths = depths[None]
    focal = focal_from_meta(meta, (depths.shape[2], depths.shape[1]))

    clouds = [
        depth_to_points(d, np.asarray(frames[i]), focal, stride=args.stride)
        for i, d in enumerate(depths[: len(frames)])
    ]
    path = write_ply(args.out, np.concatenate(clouds, axis=0))
    print(json.dumps({"out": path, "points": sum(map(len, clouds))}))


if __name__ == "__main__":
    main()
