"""Volume-rendering integrator, alpha compositing with a cumulative product
(counterpart of ``aonerf.ops.render``).

  - the last interval is 1e10 long; distances are scaled by ||dirs||
  - transmittance is the exclusive cumprod of (1 - alpha + 1e-10)
  - depth = sum(w * t), NaN -> the largest float, clipped to its own
    [min, max]
  - white background: rgb + (1 - acc)
  - optional NOCS compositing in place of depth

The fused level kernels integrate in log space and skip depth's NaN step;
this is the plain integrator of the reference's eager model.
"""

from typing import Optional, Tuple

import torch

_EPS = 1e-10


def volumetric_rendering(
    rgb: torch.Tensor,
    density: torch.Tensor,
    t_vals: torch.Tensor,
    dirs: torch.Tensor,
    white_bkgd: bool,
    nocs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-sample rgb/density along rays.

    rgb: (..., S, 3); density: (..., S, 1); t_vals: (..., S); dirs: (..., 3).
    Returns (comp_rgb, acc, weights, depth), or (comp_rgb, acc, weights,
    comp_nocs) when ``nocs`` (..., S, 3) is given.
    """
    dists = torch.cat([t_vals[..., 1:] - t_vals[..., :-1], torch.full_like(t_vals[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    alpha = 1.0 - torch.exp(-density[..., 0] * dists)
    accum_prod = torch.cat(
        [torch.ones_like(alpha[..., :1]), torch.cumprod(1.0 - alpha[..., :-1] + _EPS, dim=-1)], dim=-1
    )
    weights = alpha * accum_prod

    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t_vals, dim=-1)
    # jnp.nan_to_num(depth, nan=inf) turns NaN into inf and then every +inf
    # into the largest float; torch's keeps the inf it put in for NaN.
    depth = torch.nan_to_num(depth, nan=torch.finfo(depth.dtype).max)
    depth = torch.clamp(depth, torch.min(depth), torch.max(depth))
    acc = torch.sum(weights, dim=-1)

    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])

    if nocs is not None:
        comp_nocs = torch.sum(weights[..., None] * nocs, dim=-2)
        return comp_rgb, acc, weights, comp_nocs
    return comp_rgb, acc, weights, depth
