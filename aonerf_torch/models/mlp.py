"""Vanilla NeRF MLP (counterpart of ``aonerf.models.mlp.NeRFMLP``), 8x256 at
any encoding degrees: P = pos_enc_dim(3, min_deg_point, max_deg_point)
encoded sample features (63 at the default 0 / 10) and V = pos_enc_dim(3, 0,
deg_view) encoded view-direction features (27 at 4).

  trunk: pts_0 (P -> 256) + pts_1..7 (256 -> 256), ReLU; the encoded input
         is concatenated to the activation after pts_4, so pts_5 takes 256 + P
  heads: density (256 -> 1, bias 0.3), bottleneck (256 -> 256)
  view:  views_0 (256 + V -> 128), ReLU; rgb (128 -> 3)

Layer names match the flax parameter tree, so ``utils.bridge`` can carry the
weights across. The fused level kernel computes the same function from
``ops.kernels.fused_render.kernel_params(mlp)``; ``forward`` is the layer-by-
layer form.

``compute_dtype`` (``torch.float32`` or ``torch.bfloat16``) is the mode the
fused kernels run this MLP in: with bf16 every product takes bf16-rounded
operands and sums in fp32 (the TPU kernels' ``dot_bf16``; its plain form is
``level_activations_ref(..., dot_bf16=True)``). ``forward`` computes in the
same dtype as flax's ``NeRFMLP(compute_dtype=...)``: each layer through
``linear``, fp32 products in fp32, bf16 ones rounded with their bias.
Parameters, their gradients and the optimizer's moments stay fp32, as
flax's ``param_dtype`` keeps them.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aonerf_torch import DeviceLike, default_device
from aonerf_torch.ops.encoding import pos_enc_dim

# the kernels' modes by the name Config.compute_dtype gives them
COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def round_exact(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """fp64 ``x`` rounded to the nearest bf16 value (ties to even) in one
    step, as ``dtype``; its gradient passes through as a cast's does."""
    m, e = torch.frexp(x.detach())
    exact = torch.ldexp(torch.round(m * 256.0), (e - 8).to(x.dtype))
    return (x + (exact - x).detach()).to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``layer`` on ``x`` as flax's ``Dense(dtype=compute_dtype)`` computes
    it. fp32: the layer itself. bf16: the product of bf16 operands (fp32
    sums) rounded to bf16, then the bias rounded to bf16 and added, rounded
    again. The bias never goes to ``F.linear`` / ``addmm``: their epilogue
    adds it before the one rounding."""
    if compute_dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(compute_dtype), layer.weight.to(compute_dtype)) + layer.bias.to(compute_dtype)


class NeRFMLP(nn.Module):
    netdepth = 8
    netwidth = 256
    netwidth_condition = 128
    skip_layer = 4

    def __init__(
        self,
        density_bias_init: float = 0.3,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        compute_dtype: torch.dtype = torch.float32,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
    ):
        """Xavier-uniform kernels and zero biases (density bias
        ``density_bias_init``), drawn on the CPU from ``generator`` and then
        moved to ``device``; the sample points encoded at degrees
        [min_deg_point, max_deg_point) and the view directions at [0,
        deg_view), as flax's ``NeRFMLP`` fields of those names."""
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype {compute_dtype}: the kernels run {tuple(COMPUTE_DTYPES.values())}")
        self.compute_dtype = compute_dtype
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        pos = pos_enc_dim(3, self.min_deg_point, self.max_deg_point)
        view = pos_enc_dim(3, 0, self.deg_view)
        w = self.netwidth

        def linear(fan_in, fan_out):  # no draw from the global generator
            return nn.Linear(fan_in, fan_out, device="meta")

        for i in range(self.netdepth):
            fan_in = pos if i == 0 else w + (pos if i == self.skip_layer + 1 else 0)
            setattr(self, f"pts_{i}", linear(fan_in, w))
        self.density = linear(w, 1)
        self.bottleneck = linear(w, w)
        self.views_0 = linear(w + view, self.netwidth_condition)
        self.rgb = linear(self.netwidth_condition, 3)
        self.to_empty(device="cpu")
        with torch.no_grad():
            for layer in self.children():
                nn.init.xavier_uniform_(layer.weight, generator=generator)
                nn.init.zeros_(layer.bias)
            self.density.bias.fill_(density_bias_init)
        self.to(default_device(device))

    def forward(
        self, x: torch.Tensor, condition: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, P) encoded samples; condition (B, V) encoded view dirs,
        both cast to ``compute_dtype`` as flax casts them.

        Returns (raw_rgb (B, S, 3), raw_density (B, S, 1)) in ``compute_dtype``.
        """
        dtype = self.compute_dtype
        num_samples, feat_dim = x.shape[1:]
        x = x.reshape(-1, feat_dim).to(dtype)
        inputs = x
        for idx in range(self.netdepth):
            x = torch.relu(linear(getattr(self, f"pts_{idx}"), x, dtype))
            if idx % self.skip_layer == 0 and idx > 0:
                x = torch.cat([x, inputs], dim=-1)
        raw_density = linear(self.density, x, dtype).reshape(-1, num_samples, 1)
        bottleneck = linear(self.bottleneck, x, dtype)
        cond = condition.to(dtype)[:, None, :].expand(-1, num_samples, -1).reshape(-1, condition.shape[-1])
        x = torch.relu(linear(self.views_0, torch.cat([bottleneck, cond], dim=-1), dtype))
        raw_rgb = linear(self.rgb, x, dtype).reshape(-1, num_samples, 3)
        return raw_rgb, raw_density
