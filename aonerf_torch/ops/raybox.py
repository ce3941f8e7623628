"""Ray-AABB intersection by the vectorized slab test (counterpart of
``aonerf.ops.raybox``).

  - ray_box_intersection / get_ray_limits: the cube of side
    ``box_side_length`` centred at the origin; invalid rays get the min/max
    over the valid ones, negatives are clamped to 0
  - bbox_intersection_batch: any AABB ``[min, max]``; zero direction
    components are nudged to 1e-14, and a ray that starts inside the box
    reports a miss

Every tensor is on the inputs' device.
"""

from typing import Tuple

import torch


def _slab(
    rays_o: torch.Tensor, inv_d: torch.Tensor, bounds_min, bounds_max
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Core slab test. Returns (tmin, tmax, valid) for all rays at once."""
    lo = (bounds_min - rays_o) * inv_d
    hi = (bounds_max - rays_o) * inv_d
    t0 = torch.minimum(lo, hi)  # per-axis entry
    t1 = torch.maximum(lo, hi)  # per-axis exit
    # Narrowed axis by axis in the reference's yz -> xz -> xy order: the
    # invalidity checks use the running tmin/tmax, not the final ones.
    tmin, tmax = t0[..., 0], t1[..., 0]
    valid = torch.ones(rays_o.shape[:-1], dtype=torch.bool, device=rays_o.device)
    for axis in (1, 2):
        valid = valid & ~((tmin > t1[..., axis]) | (t0[..., axis] > tmax))
        tmin = torch.maximum(tmin, t0[..., axis])
        tmax = torch.minimum(tmax, t1[..., axis])
    return tmin, tmax, valid


def ray_box_intersection(
    rays_o: torch.Tensor, rays_d: torch.Tensor, box_side_length: float = 2.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry/exit distances against the origin-centred cube.

    Returns (tmin (..., 1), tmax (..., 1)); invalid rays are marked tmin=-1,
    tmax=-2.
    """
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    half = box_side_length / 2.0
    tmin, tmax, valid = _slab(o, 1.0 / d, -half, half)
    tmin = torch.where(valid, tmin, -1.0)
    tmax = torch.where(valid, tmax, -2.0)
    shape = (*rays_o.shape[:-1], 1)
    return tmin.reshape(shape), tmax.reshape(shape)


def get_ray_limits(
    rays_o: torch.Tensor, rays_d: torch.Tensor, box_side_length: float = 2.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray [near, far] against the cube, invalid rays filled from the
    valid population and negatives clamped to 0."""
    near, far = ray_box_intersection(rays_o, rays_d, box_side_length)
    valid = far > near
    keep = valid | ~torch.any(valid)
    big = torch.finfo(near.dtype).max
    min_valid_near = torch.min(torch.where(valid, near, big))
    max_valid_far = torch.max(torch.where(valid, far, -big))
    near = torch.where(keep, near, min_valid_near)
    far = torch.where(keep, far, max_valid_far)
    return torch.clamp(near, min=0.0), torch.clamp(far, min=0.0)


def bbox_intersection_batch(
    bounds: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched intersection with an AABB ``bounds`` (2, 3) = [min, max].

    Returns (hit (N,), tmin (N,), tmax (N,)); a ray whose origin is inside
    the box (tmin < 0 or tmax < 0) reports hit=False with tmin=tmax=0.
    """
    d = torch.where(rays_d == 0.0, 1.0e-14, rays_d)
    tmin, tmax, valid = _slab(rays_o, 1.0 / d, bounds[0], bounds[1])
    hit = valid & (tmin >= 0.0) & (tmax >= 0.0)
    zero = torch.zeros_like(tmin)
    return hit, torch.where(hit, tmin, zero), torch.where(hit, tmax, zero)
