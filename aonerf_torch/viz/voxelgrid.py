"""Field-density voxel grids: occupancy extraction and PLY export
(counterpart of ``aonerf.viz.voxelgrid``).

The trained field itself is the geometry: its fine MLP is evaluated at the
R^3 voxel centres of a box on the model's device, in z-slabs of (R, R)
points, thresholded to occupied voxel centres and written as a point PLY
(viz/pointcloud.py::write_ply) for any mesh viewer; viz/mesh.py turns the
same grid into a triangle mesh. It works for the vanilla field, the
articulated field at any codes (an instance at an articulation) and the
auto-encoder at codes encoded from a source view.

The adapters evaluate the fine MLP's own forward, outside the fused level
kernels (JAX evaluates these products with flax ``Dense``, outside its
Pallas kernels), in the MLP's ``compute_dtype``: the vanilla MLP's raw
density through ReLU; the articulated MLP's, then the field's own
activation and cap (``ArticulatedNeRF.sigma_from_raw``).
"""

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from aonerf_torch import DeviceLike, default_device, full_fp32
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.viz.pointcloud import write_ply

DensityFn = Callable[[torch.Tensor], torch.Tensor]  # (B, S, 3) points -> (B, S) density


def nerf_density_fn(model) -> DensityFn:
    """Density adapter for the vanilla field (``models/nerf.py::NeRF``): the
    fine MLP's raw density through ReLU, as the field renders it."""
    mlp = model.fine_mlp

    def fn(points: torch.Tensor) -> torch.Tensor:
        enc = pos_enc(points, mlp.min_deg_point, mlp.max_deg_point)
        with full_fp32():
            return torch.relu(mlp(enc, _fixed_view_cond(points, mlp.deg_view))[1][..., 0])

    return fn


def _fixed_view_cond(points: torch.Tensor, deg_view: int) -> torch.Tensor:
    """The encoded +x view direction for each of the B rows of ``points``
    (density does not depend on the view)."""
    dirs = torch.zeros(points.shape[0], 3, dtype=points.dtype, device=points.device)
    dirs[:, 0] = 1.0
    return pos_enc(dirs, 0, deg_view)


def _field_sigma(field, points: torch.Tensor, cond: torch.Tensor, latents: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fine-level density of an ``ArticulatedNeRF`` with the field's own
    activation and cap, so a threshold means what it means in training."""
    enc = points if field.enc_after else pos_enc(points, field.min_deg_point, field.max_deg_point)
    _, raw_sigma = field.fine_mlp(enc, cond, latents)
    return field.sigma_from_raw(raw_sigma)[..., 0]


def articulated_density_fn(model, latents: Dict[str, torch.Tensor]) -> DensityFn:
    """Density adapter for the articulated field (``models/articulated.py``)
    at fixed ``latents`` (density, color and articulation codes, (1, C)
    each, as ``Trainer._latents_for`` gives them)."""

    def fn(points: torch.Tensor) -> torch.Tensor:
        return _field_sigma(model, points, _fixed_view_cond(points, model.deg_view), latents)

    return fn


def ae_density_fn(model, latents: Dict[str, torch.Tensor]) -> DensityFn:
    """Density adapter for the auto-encoder (``models/ae.py``) at encoded
    ``latents`` (as ``Trainer._render_setup`` gives them): its ``field``'s
    fine MLP with the field's own activation and cap."""
    field = model.field

    def fn(points: torch.Tensor) -> torch.Tensor:
        return _field_sigma(field, points, _fixed_view_cond(points, field.deg_view), latents)

    return fn


def voxel_centers(bbox_min, bbox_max, resolution: int):
    """The R voxel centres along each axis, float32 on the host, computed as
    JAX computes them: lo + (hi - lo) * (arange + 0.5) / R."""
    lo = torch.tensor(bbox_min, dtype=torch.float32)
    hi = torch.tensor(bbox_max, dtype=torch.float32)
    steps = torch.arange(resolution, dtype=torch.float32) + 0.5
    return [lo[a] + (hi[a] - lo[a]) * steps / resolution for a in range(3)]


@torch.no_grad()
def density_grid(
    density_fn: DensityFn,
    bbox_min=(-1.5, -1.5, -1.5),
    bbox_max=(1.5, 1.5, 1.5),
    resolution: int = 64,
    device: DeviceLike = None,
) -> np.ndarray:
    """(R, R, R) float32 density at the voxel centres of the box, indexed
    [ix, iy, iz]. ``density_fn`` runs on ``device`` (the model's) once a
    z-slab of (R, R) points, each slab written into one grid on the device;
    the grid comes to the host once, at the end. A bf16 density widens to
    float32 exactly."""
    dev = default_device(device)
    cx, cy, cz = voxel_centers(bbox_min, bbox_max, resolution)
    xs, ys = torch.meshgrid(cx.to(dev), cy.to(dev), indexing="ij")
    grid = torch.empty((resolution,) * 3, dtype=torch.float32, device=dev)
    for k, z in enumerate(cz.tolist()):
        grid[:, :, k] = density_fn(torch.stack([xs, ys, torch.full_like(xs, z)], dim=-1))
    return grid.cpu().numpy()


def occupied_points(
    grid: np.ndarray,
    bbox_min=(-1.5, -1.5, -1.5),
    bbox_max=(1.5, 1.5, 1.5),
    threshold: float = 10.0,
) -> np.ndarray:
    """(P, 3) float64 world-space voxel centres with density above
    ``threshold`` (sigma 10: a voxel alpha 1 - exp(-sigma * delta) of about
    0.37 at a 3/64 voxel pitch, inside the surface shell)."""
    res = grid.shape[0]
    idx = np.argwhere(grid > threshold)
    lo = np.asarray(bbox_min, dtype=np.float64)
    hi = np.asarray(bbox_max, dtype=np.float64)
    return lo + (hi - lo) * (idx + 0.5) / res


def export_occupancy_ply(
    path: str,
    density_fn: DensityFn,
    bbox_min=(-1.5, -1.5, -1.5),
    bbox_max=(1.5, 1.5, 1.5),
    resolution: int = 64,
    threshold: float = 10.0,
    device: DeviceLike = None,
) -> Tuple[str, int]:
    """The grid, thresholded, as a point PLY; returns (path, count)."""
    grid = density_grid(density_fn, bbox_min, bbox_max, resolution, device=device)
    pts = occupied_points(grid, bbox_min, bbox_max, threshold)
    write_ply(path, pts.astype(np.float32))
    return path, int(len(pts))
