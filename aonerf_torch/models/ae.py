"""Auto-encoder articulated NeRF: latents encoded from a source image, and
the joint state regressed from them (counterpart of ``aonerf.models.ae``).

A multi-head ResNet34 encodes the source image into shape (density),
appearance (color) and articulation codes; ``JointStateDecoder`` regresses
the joint angle from the articulation code; the field is the port's
``ArticulatedNeRF`` with the auto-encoder's settings: softplus (or relu)
density soft-capped at ``sigma_cap``, ``tail_to_background``, no rgb
padding, and with ``embed_deg`` the deformation conditioned on an embedding
of the rounded joint angle in degrees, nn.Embedding(91, 32): the
ground-truth angle when training and validating, the predicted one at test.
``compute_dtype`` reaches the encoder, the field and the state decoder; the
codes they hand on, the predicted state and the degree embedding stay fp32.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from aonerf_torch import DeviceLike, default_device
from aonerf_torch.models.articulated import ArticulatedNeRF, Latents
from aonerf_torch.models.joint_state import JointStateDecoder
from aonerf_torch.models.resnet import MultiHeadImgEncoder

RAD2DEG = np.float32(180.0 / np.pi)  # in fp32, as jnp.rad2deg multiplies


class AutoEncoderArticulatedNeRF(nn.Module):
    num_levels = 2

    def __init__(
        self,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        noise_std: float = 0.0,
        lindisp: bool = False,
        embed_deg: bool = True,
        sigma_activation: str = "softplus",
        sigma_cap: Optional[float] = 500.0,
        compute_dtype: torch.dtype = torch.float32,
        latent_dense: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Every table and kernel drawn on the CPU from ``generator`` (the
        encoder, the field, the state decoder, then the degree embedding),
        then moved to ``device``."""
        super().__init__()
        device = default_device(device)
        self.embed_deg = embed_deg
        self.encoder = MultiHeadImgEncoder(art_size=32, generator=generator, device=device,
                                           compute_dtype=compute_dtype)
        self.field = ArticulatedNeRF(
            num_coarse_samples=num_coarse_samples, num_fine_samples=num_fine_samples,
            min_deg_point=min_deg_point, max_deg_point=max_deg_point, deg_view=deg_view, noise_std=noise_std,
            lindisp=lindisp, sigma_activation=sigma_activation, sigma_cap=sigma_cap, tail_to_background=True,
            latent_dense=latent_dense, rgb_padding=0.0, embed_deg=embed_deg, compute_dtype=compute_dtype,
            generator=generator, device=device,
        )
        self.joint_state_decoder = JointStateDecoder(generator=generator, device=device,
                                                     compute_dtype=compute_dtype)
        if embed_deg:  # 0..90 degrees inclusive
            self.deg_embedding = nn.Embedding(91, 32, device="meta")
            self.deg_embedding.to_empty(device="cpu")
            with torch.no_grad():
                nn.init.xavier_uniform_(self.deg_embedding.weight, generator=generator)
            self.deg_embedding.to(device)

    def encode(self, images: torch.Tensor) -> Latents:
        """images: (B, 3, H, W) or (B, V, 3, H, W) -> latent dict."""
        return self.encoder(images)

    def predict_state(self, articulation_code: torch.Tensor) -> torch.Tensor:
        """Joint angle (radians) from the articulation code."""
        return self.joint_state_decoder(articulation_code)

    def deg_code(self, deg_rad: torch.Tensor) -> torch.Tensor:
        """Embedding of the joint angle rounded to whole degrees (half to
        even), clipped to 0..90."""
        deg = torch.round(deg_rad.to(torch.float32) * RAD2DEG).to(torch.int32)
        return self.deg_embedding(torch.clamp(deg, 0, 90))

    def render(
        self,
        rays: Dict[str, torch.Tensor],
        randomized: bool,
        white_bkgd: bool,
        near: float,
        far: float,
        latents: Latents,
        draws=None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        return self.field(rays, randomized, white_bkgd, near, far, latents, draws=draws)

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        src_imgs: torch.Tensor,
        deg: torch.Tensor,
        randomized: bool,
        white_bkgd: bool,
        near: float,
        far: float,
        draws=None,
    ):
        """Encode, condition, render. ``deg`` (radians) selects the degree
        embedding; pass the prediction itself at inference.

        Returns (levels, latents, pred_state)."""
        latents = self.encode(src_imgs)
        pred_state = self.predict_state(latents["articulation"])
        if self.embed_deg:
            latents = dict(latents, articulation_deg=self.deg_code(deg))
        levels = self.render(rays, randomized, white_bkgd, near, far, latents, draws=draws)
        return levels, latents, pred_state
