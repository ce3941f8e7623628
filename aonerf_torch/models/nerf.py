"""Hierarchical two-level NeRF field (counterpart of ``aonerf.models.nerf``).

  coarse: num_coarse_samples + 1 evenly spaced t-values in [near, far]
  fine:   num_fine_samples inverse-CDF samples from the coarse weights[1:-1]
          over the coarse bin midpoints, merged with the coarse t-values

Each level is one call of ``fused_render_level``: the CUDA kernel on the card,
its plain version on the CPU. Only deterministic rendering is ported so far.
"""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from aonerf_torch import DeviceLike, default_device
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops import encoding, sampling
from aonerf_torch.ops.kernels.fused_render import fused_render_level, kernel_params


class NeRF(nn.Module):
    num_levels = 2

    def __init__(
        self,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        lindisp: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = default_device(device)
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.lindisp = lindisp
        self.coarse_mlp = NeRFMLP(generator=generator, device=device)
        self.fine_mlp = NeRFMLP(generator=generator, device=device)

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        randomized: bool,
        white_bkgd: bool,
        near: float,
        far: float,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """rays: 'rays_o', 'rays_d' (unit), 'viewdirs' (B, 3), B a multiple of
        ``fused_render.RAY_TILE`` (16).

        Returns [(comp_rgb, acc, depth)] per level, coarse first.
        """
        if randomized:
            raise NotImplementedError("randomized rendering is not ported yet")
        ret = []
        t_vals = weights = None
        viewdirs_enc = encoding.pos_enc(rays["viewdirs"], 0, NeRFMLP.deg_view)
        for i_level in range(self.num_levels):
            if i_level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    rays["rays_o"], rays["rays_d"], self.num_coarse_samples,
                    near, far, randomized, self.lindisp,
                )
                mlp = self.coarse_mlp
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1], rays["rays_o"], rays["rays_d"],
                    t_vals, self.num_fine_samples, randomized,
                )
                mlp = self.fine_mlp
            t_vals = t_vals.contiguous()
            samples_enc = encoding.pos_enc(
                samples, NeRFMLP.min_deg_point, NeRFMLP.max_deg_point
            )
            comp_rgb, acc, depth, weights = fused_render_level(
                kernel_params(mlp), t_vals, rays["rays_o"], rays["rays_d"],
                viewdirs_enc, samples_enc, white_bkgd,
            )
            ret.append((comp_rgb, acc, depth))
        return ret
