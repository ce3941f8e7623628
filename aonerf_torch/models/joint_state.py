"""Joint-state regressor: articulation code (32) -> joint angle in radians
(counterpart of ``aonerf.models.joint_state``): 32 -> 64 -> 32 -> 1 with
ReLU. Its layers keep flax's auto names, ``Dense_0`` .. ``Dense_2``.
With ``compute_dtype=torch.bfloat16`` each layer is flax's bf16 ``Dense``
(``models.mlp.linear``) and the output is cast to fp32.
"""

from typing import Optional

import torch
from torch import nn

from aonerf_torch import DeviceLike, default_device, full_fp32
from aonerf_torch.models.mlp import COMPUTE_DTYPES, linear
from aonerf_torch.models.resnet import lecun_normal_


class JointStateDecoder(nn.Module):
    def __init__(
        self, generator: Optional[torch.Generator] = None, device: DeviceLike = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        """lecun-normal kernels and zero biases, as flax's ``Dense``, drawn
        on the CPU from ``generator`` and then moved to ``device``."""
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype {compute_dtype}: expected one of {tuple(COMPUTE_DTYPES.values())}")
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(32, 64, device="meta")
        self.Dense_1 = nn.Linear(64, 32, device="meta")
        self.Dense_2 = nn.Linear(32, 1, device="meta")
        self.to_empty(device="cpu")
        with torch.no_grad():
            for layer in self.children():
                lecun_normal_(layer.weight, layer.in_features, generator)
                nn.init.zeros_(layer.bias)
        self.to(default_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        with full_fp32():
            x = torch.relu(linear(self.Dense_0, x, dtype))
            x = torch.relu(linear(self.Dense_1, x, dtype))
            out = linear(self.Dense_2, x, dtype)
        return out if dtype == torch.float32 else out.to(torch.float32)
