"""Sinusoidal positional encoding (counterpart of ``aonerf.ops.encoding``).

Feature order, for D = x.shape[-1] and L = max_deg - min_deg:
  [ x (D), sin(2^min_deg x) ... sin(2^(max_deg-1) x) (L*D, scale-major),
    cos(...) computed as sin(phase + pi/2) (L*D, scale-major) ]
"""

import math

import torch


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """Positional-encode the last axis of ``x``: (..., D) -> (..., (2L+1)D),
    in ``x``'s dtype as JAX computes it: the scales and pi/2 rounded to that
    dtype first (a Python scalar would stay fp32 in a bf16 add on CUDA)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor(
        [2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype, device=x.device
    )
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    half_pi = torch.tensor(0.5 * math.pi, dtype=x.dtype, device=x.device)
    four_feat = torch.sin(torch.cat([xb, xb + half_pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


def pos_enc_dim(input_dim: int, min_deg: int, max_deg: int) -> int:
    """Feature size produced by :func:`pos_enc`."""
    return ((max_deg - min_deg) * 2 + 1) * input_dim
