"""Merging sorted t-values (counterpart of ``aonerf.ops.sorting``).

The JAX package merges with a bitonic network because a general sort is slow
on the TPU. On the GPU ``torch.sort`` of the concatenation is the natural
equivalent and gives the same output: the sorted multiset of both inputs.
"""

import torch


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ascending arrays along the last axis: (..., Na), (..., Nb)
    -> (..., Na+Nb) ascending."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
