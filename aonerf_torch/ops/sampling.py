"""Ray sampling: stratified coarse t-values and inverse-CDF importance samples
(counterpart of ``aonerf.ops.sampling``).

With ``randomized``, the jitter and the sorted uniforms come from a
``draws`` object (``aonerf_torch.ops.random.Draws`` or any object with its
methods).
"""

from typing import Tuple

import numpy as np
import torch

from aonerf_torch.ops.sorting import merge_sorted, sorted_uniform


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num, dtype=float32)`` bit for bit.

    JAX casts the bounds to float32 first, forms the interior steps as
    ``iota * (1 / (num - 1))`` and ends on ``stop`` exactly. ``torch.linspace``
    rounds differently in a few ULPs at num >= 128, and a u that lands on a
    cdf value could then pick another bin, so the grid is built the JAX way.
    """
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    if num == 1:
        return np.asarray([start], f32)
    step = np.arange(num - 1, dtype=f32) * (f32(1.0) / f32(num - 1))
    out = start * (f32(1.0) - step) + stop * step
    return np.concatenate([out, np.asarray([stop], f32)]).astype(f32)


def cast_rays(
    t_vals: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor
) -> torch.Tensor:
    """Points along rays: o + t*d. t_vals (..., S) -> points (..., S, 3)."""
    return origins[..., None, :] + t_vals[..., None] * directions[..., None, :]


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    num_samples: int,
    near: float,
    far: float,
    randomized: bool,
    lindisp: bool,
    draws=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_samples + 1`` stratified t-values in [near, far].

    Returns (t_vals (B, S+1), coords (B, S+1, 3)). With ``randomized``, each
    t-value is jittered uniformly within its bin (bins delimited by the
    midpoints, the first and last clamped at near and far) by
    ``draws.uniform((B, S+1))``.
    """
    if randomized and draws is None:
        raise ValueError("randomized sampling needs draws")
    grid = torch.from_numpy(linspace_f32(0.0, 1.0, num_samples + 1)).to(
        device=rays_o.device, dtype=rays_o.dtype
    )
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - grid) + 1.0 / far * grid)
    else:
        t_vals = near * (1.0 - grid) + far * grid
    if randomized:
        mids = 0.5 * (t_vals[1:] + t_vals[:-1])
        upper = torch.cat([mids, t_vals[-1:]])
        lower = torch.cat([t_vals[:1], mids])
        t_rand = draws.uniform((rays_o.shape[0], num_samples + 1))
        t_vals = lower + (upper - lower) * t_rand
    else:
        t_vals = t_vals.expand(rays_o.shape[0], num_samples + 1)
    return t_vals, cast_rays(t_vals, rays_o, rays_d)


def sorted_piecewise_constant_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomized: bool,
    draws=None,
    float_min_eps: float = 2.0**-32,
) -> torch.Tensor:
    """Inverse-CDF sampling of a piecewise-constant PDF over sorted ``bins``.

    bins (..., N) sorted; weights (..., N-1) non-negative masses.
    Returns (..., num_samples), sorted by construction: u is a linspace, or
    with ``randomized`` sorted uniforms from ``draws`` (``sorted_uniform``).

    The bracketing bins come from ``torch.searchsorted(cdf, u, right=True)``,
    i.e. count = #{i : cdf_i <= u}, clamped as the JAX one-hot selection is:
    idx0 = count - 1, idx1 = min(count, N - 1). At u = 1 - 2^-32, which rounds
    to 1.0 in float32, count == N and both indices clamp to bins[-1].
    """
    if randomized and draws is None:
        raise ValueError("randomized PDF sampling needs draws")
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)

    if randomized:
        u = sorted_uniform(draws, (*cdf.shape[:-1], num_samples)).to(cdf.dtype)
    else:
        u = torch.from_numpy(linspace_f32(0.0, 1.0 - float_min_eps, num_samples))
        u = u.to(device=cdf.device, dtype=cdf.dtype).expand(*cdf.shape[:-1], num_samples)
    u = u.contiguous()

    n = cdf.shape[-1]
    count = torch.searchsorted(cdf.contiguous(), u, right=True)
    idx0 = count - 1
    idx1 = torch.clamp(count, max=n - 1)
    bin0, bin1 = torch.gather(bins, -1, idx0), torch.gather(bins, -1, idx1)
    cdf0, cdf1 = torch.gather(cdf, -1, idx0), torch.gather(cdf, -1, idx1)

    t = torch.clamp(torch.nan_to_num((u - cdf0) / (cdf1 - cdf0), nan=0.0), 0.0, 1.0)
    return bin0 + t * (bin1 - bin0)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    num_samples: int,
    randomized: bool,
    draws=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-resample fine t-values and merge them with ``t_vals``.

    The new samples carry no gradient. Returns (t_vals (B, S+num_samples),
    coords (B, S+num_samples, 3)).
    """
    t_samples = sorted_piecewise_constant_pdf(bins, weights, num_samples, randomized, draws)
    t_vals = merge_sorted(t_vals, t_samples.detach())
    return t_vals, cast_rays(t_vals, origins, directions)
