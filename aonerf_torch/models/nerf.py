"""Hierarchical two-level NeRF field (counterpart of ``aonerf.models.nerf``).

  coarse: num_coarse_samples + 1 evenly spaced t-values in [near, far]
  fine:   num_fine_samples inverse-CDF samples from the coarse weights[1:-1]
          over the coarse bin midpoints, merged with the coarse t-values

Each level is one call of the fused level (``ops.kernels.fused_train``): the
CUDA kernels on the card, their plain versions on the CPU, in fp32 or, with
``compute_dtype=torch.bfloat16``, in the kernels' bf16 mode (``dot_bf16``);
the parameters stay fp32 either way. Randomized
rendering (jittered coarse t-values, sorted-uniform fine samples) takes its
numbers from an explicit ``draws`` object (``ops.random``). With
``noise_std`` > 0, randomized rendering adds ``uniform * noise_std`` to each
sample's raw sigma before the ReLU, as JAX's NeRF does; the training forward
K1s adds it in the kernel (``fused_train``).
"""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from aonerf_torch import DeviceLike, default_device
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.kernels.fused_render import fused_render_level
from aonerf_torch.ops.kernels.fused_train import fused_level, fused_nerf_forward


class NeRF(nn.Module):
    num_levels = 2

    def __init__(
        self,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        lindisp: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        compute_dtype: torch.dtype = torch.float32,
        noise_std: float = 0.0,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
    ):
        """Two ``NeRFMLP`` at the encoding degrees given (flax's ``NeRF``
        passes its fields of those names to both), drawn in turn from
        ``generator``."""
        super().__init__()
        device = default_device(device)
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.lindisp = lindisp
        self.noise_std = noise_std
        self.compute_dtype = compute_dtype
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        mlp = dict(generator=generator, device=device, compute_dtype=compute_dtype, min_deg_point=min_deg_point,
                   max_deg_point=max_deg_point, deg_view=deg_view)
        self.coarse_mlp = NeRFMLP(**mlp)
        self.fine_mlp = NeRFMLP(**mlp)

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        randomized: bool,
        white_bkgd: bool,
        near: float,
        far: float,
        draws=None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """rays: 'rays_o', 'rays_d' (unit), 'viewdirs' (B, 3), B a multiple of
        ``fused_render.RAY_TILE`` (16, the fp32 backward's ray tile) with grad
        enabled in fp32; in bf16 mode, or without grad, any B (the kernels
        choose their own tile). ``draws`` (``ops.random.Draws``) is needed
        when ``randomized``.

        Returns [(comp_rgb, acc, depth)] per level, coarse first. With grad
        enabled, or with sigma noise (randomized, ``noise_std`` > 0), each
        level is the differentiable ``fused_level`` (K1s forward, K2
        backward); otherwise ``fused_render_level`` (K1) alone.
        """
        if randomized and draws is None:
            raise ValueError("randomized rendering needs draws")
        noisy = randomized and self.noise_std > 0
        level = fused_level if torch.is_grad_enabled() or noisy else fused_render_level
        return fused_nerf_forward(
            self.coarse_mlp, self.fine_mlp, rays, randomized, white_bkgd, near, far,
            self.num_coarse_samples, self.num_fine_samples, self.lindisp, draws, level=level,
            dot_bf16=self.compute_dtype == torch.bfloat16, noise_std=self.noise_std,
        )
