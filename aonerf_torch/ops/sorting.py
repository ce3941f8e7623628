"""Merging sorted t-values and drawing sorted uniforms (counterpart of
``aonerf.ops.sorting``).

The JAX package merges with a bitonic network because a general sort is slow
on the TPU. On the GPU ``torch.sort`` of the concatenation is the natural
equivalent and gives the same output: the sorted multiset of both inputs.
"""

import torch


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ascending arrays along the last axis: (..., Na), (..., Nb)
    -> (..., Na+Nb) ascending."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def sorted_uniform(draws, shape) -> torch.Tensor:
    """Sorted-ascending uniforms along the last axis without a sort: the
    normalized cumulative sums of n + 1 exponential draws from ``draws``
    (the order statistics of n iid U(0, 1) in law)."""
    *batch, n = shape
    e = draws.exponential((*batch, n + 1))
    s = torch.cumsum(e, dim=-1)
    return s[..., :-1] / s[..., -1:]
