"""Pose sanity checker: validate a transforms.json camera set (counterpart
of ``aonerf.viz.check_poses``).

Reference analogue: visualize_nerf/check_poses.py — an interactive viewer
used to eyeball whether dataset poses follow the expected convention. This
headless version checks the invariants numerically and reports violations:

  - rotation orthonormality (R R^T = I) and right-handedness (det R = +1)
  - camera distance from origin (SAPIEN datagen: radius 4 +- 0.5,
    data_utils.py:66-80)
  - look-at consistency: camera -z axis points toward the origin
  - focal/camera_angle_x presence

Usage: python -m aonerf_torch.viz.check_poses --root data/scene --split train
       python -m aonerf_torch.viz.check_poses --root scan1 --convention dtu
(--convention routes through aonerf_torch.viz.conventions.load_cameras, so any
supported camera convention can be validated, not just sapien.)
"""

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


def check_poses(
    c2ws: np.ndarray,
    expect_radius: Optional[float] = None,
    radius_tol: float = 1.0,
    lookat_cos_min: float = 0.9,
) -> Dict:
    """Validate an (N, 4, 4) or (N, 3, 4) c2w stack; returns a report dict
    with per-check pass counts and the worst offenders."""
    c2ws = np.asarray(c2ws, np.float64)
    if c2ws.ndim == 2:
        c2ws = c2ws[None]
    R = c2ws[:, :3, :3]
    t = c2ws[:, :3, 3]

    ortho_err = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max(axis=(1, 2))
    dets = np.linalg.det(R)
    radii = np.linalg.norm(t, axis=-1)
    # camera forward = -z column; unit vector toward the origin = -t/|t|
    fwd = -R[:, :, 2]
    to_origin = -t / np.clip(radii[:, None], 1e-9, None)
    lookat_cos = np.sum(fwd * to_origin, axis=-1)

    report = {
        "n_cameras": int(len(c2ws)),
        "orthonormal": {
            "max_err": float(ortho_err.max()),
            "n_bad": int((ortho_err > 1e-3).sum()),
        },
        "right_handed": {
            "min_det": float(dets.min()),
            "n_bad": int((np.abs(dets - 1.0) > 1e-3).sum()),
        },
        "radius": {
            "min": float(radii.min()),
            "max": float(radii.max()),
            "mean": float(radii.mean()),
        },
        "lookat_origin": {
            "min_cos": float(lookat_cos.min()),
            "n_bad": int((lookat_cos < lookat_cos_min).sum()),
        },
    }
    if expect_radius is not None:
        off = np.abs(radii - expect_radius) > radius_tol
        report["radius"]["n_outside_expected"] = int(off.sum())
    report["ok"] = bool(
        report["orthonormal"]["n_bad"] == 0
        and report["right_handed"]["n_bad"] == 0
        and report["lookat_origin"]["n_bad"] == 0
    )
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--expect-radius", type=float, default=None)
    p.add_argument("--convention", type=str, default=None,
                   help="validate a non-sapien pose set via "
                        "aonerf_torch.viz.conventions.load_cameras")
    args = p.parse_args(argv)

    if args.convention:
        from aonerf_torch.viz.conventions import load_cameras

        kwargs = {"split": args.split} if args.convention in ("sapien", "blender") else {}
        cams = load_cameras(args.convention, args.root, **kwargs)
        report = check_poses(cams.c2ws, expect_radius=args.expect_radius)
        report["has_focal"] = cams.focal is not None
        report["convention"] = cams.convention
    else:
        with open(os.path.join(args.root, args.split, "transforms.json")) as f:
            meta = json.load(f)
        c2ws = np.asarray([np.asarray(v) for v in meta["frames"].values()])
        report = check_poses(c2ws, expect_radius=args.expect_radius)
        report["has_focal"] = "focal" in meta or "camera_angle_x" in meta
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
