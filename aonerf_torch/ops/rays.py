"""Ray generation: pinhole directions, world-space rays, NDC, spheric poses
and the MVS-convention rays (counterpart of ``aonerf.ops.rays``).

As in the reference, ``get_rays`` returns the unit-norm directions twice
(viewdirs and rays_d alias one tensor there); the unnormalized directions
survive only in the radii. Every tensor is on the inputs' device;
``get_ray_directions``, whose inputs are numbers, takes the device it
builds on. ``create_spheric_poses`` is host numpy, as in the reference.
"""

from typing import Tuple

import numpy as np
import torch

from aonerf_torch import DeviceLike


def get_ray_directions(h: int, w: int, focal: float, device: DeviceLike) -> torch.Tensor:
    """Per-pixel ray directions in the camera frame, (H, W, 3).

    Convention: x right, y up, the camera looks down -z; no half-pixel
    centring.
    """
    j, i = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -torch.ones_like(i)], dim=-1)


def get_rays(
    directions: torch.Tensor, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """World-space rays of one camera.

    directions: (H, W, 3) camera-frame directions; c2w: (3, 4).
    Returns (rays_o (HW,3), viewdirs (HW,3), rays_d (HW,3), radii (HW,1)):
    viewdirs and rays_d are the same unit-norm tensor; radii is the mip-NeRF
    pixel-footprint radius from the unnormalized directions.
    """
    rays_d_orig = directions @ c2w[:, :3].T  # (H, W, 3), unnormalized
    rays_o = c2w[:, 3].expand(rays_d_orig.shape)

    dx = torch.sqrt(torch.sum((rays_d_orig[:-1] - rays_d_orig[1:]) ** 2, dim=-1))
    dx = torch.cat([dx, dx[-2:-1]], dim=0)
    radii = (dx[..., None] * 2.0 / np.sqrt(12.0)).reshape(-1, 1)

    viewdirs = rays_d_orig / torch.linalg.norm(rays_d_orig, dim=-1, keepdim=True)
    viewdirs = viewdirs.reshape(-1, 3)
    return rays_o.reshape(-1, 3), viewdirs, viewdirs, radii


def get_ndc_rays(
    h: int, w: int, focal: float, near: float, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and project them into NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def create_spheric_poses(radius: float = 4.0, n_poses: int = 40, phi_deg: float = -30.0) -> np.ndarray:
    """Spheric camera path: c2w poses at elevation ``phi_deg`` circling the
    object. Returns (n_poses, 4, 4) float32."""

    def trans_t(t):
        m = np.eye(4, dtype=np.float64)
        m[2, 3] = t
        return m

    def rot_phi(phi):
        c, s = np.cos(phi), np.sin(phi)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float64)

    def rot_theta(th):
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float64)

    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)

    poses = []
    for theta in np.linspace(-180.0, 180.0, n_poses + 1)[:-1]:
        c2w = trans_t(radius)
        c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
        c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
        poses.append(flip @ c2w)
    return np.stack(poses, axis=0).astype(np.float32)


def get_rays_background(
    directions: torch.Tensor, c2w: torch.Tensor, coords: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-norm rays of the pixels ``coords`` (N, 2) as (row, col)."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o[coords[:, 0], coords[:, 1]], rays_d[coords[:, 0], coords[:, 1]]


def transform_rays_camera(
    rays_o: torch.Tensor, rays_d: torch.Tensor, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-pose camera-frame rays by c2w: rotate the directions (normalized)
    and translate the origins."""
    rays_d = rays_d @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape) + rays_o
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def world_to_ndc(points: torch.Tensor, w: int, h: int, focal: float, near: float) -> torch.Tensor:
    """Project world points into the NDC cube."""
    ox_oz = points[..., 0] / points[..., 2]
    oy_oz = points[..., 1] / points[..., 2]
    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / points[..., 2]
    return torch.stack([o0, o1, o2], dim=-1)


def get_rays_mvs(h: int, w: int, focal: float, c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MVS-convention rays (+z forward, +y down)."""
    grid = dict(dtype=c2w.dtype, device=c2w.device)
    ys, xs = torch.meshgrid(torch.linspace(0, h - 1, h, **grid), torch.linspace(0, w - 1, w, **grid), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dirs = torch.stack([(xs - w / 2) / focal, (ys - h / 2) / focal, torch.ones_like(xs)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
