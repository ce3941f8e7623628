"""Host-side (numpy) camera and ray helpers (own copy of
``aonerf.data.camera``)."""

from typing import Tuple

import numpy as np


def get_ray_directions_np(h: int, w: int, focal: float) -> np.ndarray:
    """(H, W, 3) camera-frame pixel directions (x right, y up, -z forward)."""
    j, i = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
    )
    return np.stack(
        [(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], axis=-1
    )


def get_rays_np(
    directions: np.ndarray, c2w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """World rays for one camera; returns (rays_o, viewdirs, rays_d, radii).

    viewdirs and rays_d are the same unit-norm array; radii uses the
    unnormalized directions.
    """
    rays_d_orig = directions @ c2w[:, :3].T
    rays_o = np.broadcast_to(c2w[:, 3], rays_d_orig.shape).copy()

    dx = np.sqrt(np.sum((rays_d_orig[:-1] - rays_d_orig[1:]) ** 2, axis=-1))
    dx = np.concatenate([dx, dx[-2:-1]], axis=0)
    radii = (dx[..., None] * 2.0 / np.sqrt(12.0)).reshape(-1, 1)

    viewdirs = rays_d_orig / np.linalg.norm(rays_d_orig, axis=-1, keepdims=True)
    viewdirs = viewdirs.reshape(-1, 3).astype(np.float32)
    rays_o = rays_o.reshape(-1, 3).astype(np.float32)
    return rays_o, viewdirs, viewdirs, radii.astype(np.float32)


def focal_from_meta(meta: dict, img_wh: Tuple[int, int], native_w: int = 320) -> float:
    """Focal length from a transforms.json dict: camera_angle_x (scaled to
    img_wh) when present, else the literal 'focal' key."""
    w, h = img_wh
    cam_x = meta.get("camera_angle_x", None)
    if cam_x:
        focal = 0.5 * h / np.tan(0.5 * cam_x)
        focal *= w / native_w
        return float(focal)
    focal = meta.get("focal", None)
    if focal is None:
        raise ValueError("focal length not found in transforms.json")
    return float(focal)


def look_at_c2w(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """(4, 4) camera-to-world with the camera at ``eye`` looking at ``center``
    (OpenGL convention: camera -z axis points at the target)."""
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w
