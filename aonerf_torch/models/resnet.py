"""Multi-head ResNet34 image encoder (counterpart of ``aonerf.models.resnet``).

The stem (7x7/2 conv, norm, ReLU, 3x3/2 max-pool) and layer1..layer3 are
shared; each head owns a private copy of layer4, then a global average pool
and a Linear: color (128), density (128), articulation (32) and, when
``global_size`` > 0, global. A head named in ``spatials`` is pixel-aligned
instead: the stem's map (h/2 x w/2), each shared stage's and the head's
layer4 map, each resized bilinearly (half-pixel centres) to the stem's
size, concatenated and put through a 1x1 conv ``{name}_pix``, which returns
a (B, C, h/2, w/2) map. A 5-D (B, V, 3, H, W) input runs view by view and
aggregates each head's output over V by mean or max.

Norms are affine-free instance norm (eps 1e-5, biased variance, statistics
in fp32) or flax's ``GroupNorm(num_groups=1)`` (a scale and a bias per
channel, eps 1e-6); batch norm would need running statistics. Modules take
the flax tree's names where torch allows them (``conv1``, ``layer2.block0.
downsample``, ``color_layer4``, ``color_fc``); flax's ``_Norm_k`` is
``norm{k}`` here (``utils.bridge`` maps the two). Inputs are NCHW images in
[-1, 1]. The convolutions are ``F.conv2d`` in fp32: ``forward`` keeps them
out of TF32 whatever the process-wide flag says (``aonerf_torch.full_fp32``).
With ``compute_dtype=torch.bfloat16`` they run as flax's bf16 ``Conv``: bf16
input and weights, fp32 sums, the output rounded to bf16; the norms keep
fp32 statistics and return bf16, ReLU, max-pool and the residual adds run
in bf16, and the global pool and the heads in fp32 (the pixel-aligned
heads resize the bf16 maps in fp32; flax's bf16 resize is not matched).
"""

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aonerf_torch import DeviceLike, default_device, full_fp32

STAGE_BLOCKS = {"resnet34": (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
HEADS = ("global", "color", "density", "articulation")  # the output order


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (std rescaled for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class Norm(nn.Module):
    """'instance': affine-free instance norm, eps 1e-5; 'group': one group
    over every channel with a per-channel scale and bias, eps 1e-6."""

    def __init__(self, norm_type: str, channels: int):
        super().__init__()
        if norm_type not in ("instance", "group"):
            raise ValueError(f"unsupported norm {norm_type!r} (batch needs running stats)")
        self.norm_type = norm_type
        if norm_type == "group":
            self.weight = nn.Parameter(torch.ones(channels, device="meta"))
            self.bias = nn.Parameter(torch.zeros(channels, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # fp32 statistics, fp64 in an oracle
        if self.norm_type == "instance":  # spelled out: F.instance_norm refuses a 1x1 map, JAX gives 0
            var, mean = torch.var_mean(x32, dim=(2, 3), correction=0, keepdim=True)
            return ((x32 - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)
        return F.group_norm(x32, 1, self.weight, self.bias, eps=1e-6).to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, device="meta")


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on ``x`` in ``x``'s dtype: its weight cast to it (bf16
    operands, one rounding of the fp32 sums), else the layer itself."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    return F.conv2d(x, layer.weight.to(x.dtype), None, layer.stride, layer.padding)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, norm_type: str = "instance"):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.norm0 = Norm(norm_type, features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.norm1 = Norm(norm_type, features)
        if cin != features or stride != 1:
            # flax's 1x1 "SAME" conv pads nothing: ceil(H / stride) outputs
            self.downsample = _conv(cin, features, 1, stride)
            self.norm2 = Norm(norm_type, features)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm0(conv(self.conv1, x)))
        y = self.norm1(conv(self.conv2, y))
        residual = x if self.downsample is None else self.norm2(conv(self.downsample, x))
        return torch.relu(y + residual)


class Stage(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int, stride: int, norm_type: str = "instance"):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"block{i}", BasicBlock(cin if i == 0 else features, features, stride if i == 0 else 1,
                                                  norm_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class MultiHeadImgEncoder(nn.Module):
    def __init__(
        self,
        backbone: str = "resnet34",
        shared_layers: int = 3,
        color_size: int = 128,
        density_size: int = 128,
        art_size: int = 32,
        global_size: int = 0,
        norm_type: str = "instance",
        agg_fct: str = "mean",
        spatials: tuple = (),
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        """Kernels lecun-normal and biases zero, as flax initializes them,
        drawn on the CPU from ``generator`` and then moved to ``device``."""
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: expected torch.float32 or torch.bfloat16")
        self.compute_dtype = compute_dtype
        if agg_fct not in ("mean", "max"):
            raise ValueError(f"agg_fct {agg_fct!r}: expected 'mean' or 'max'")
        blocks = STAGE_BLOCKS[backbone]
        self.shared_layers, self.agg_fct, self.spatials = shared_layers, agg_fct, tuple(spatials)
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.norm0 = Norm(norm_type, 64)
        cin = 64
        for si in range(shared_layers):
            setattr(self, f"layer{si + 1}", Stage(cin, STAGE_WIDTHS[si], blocks[si], 1 if si == 0 else 2, norm_type))
            cin = STAGE_WIDTHS[si]
        sizes = dict(zip(HEADS, (global_size, color_size, density_size, art_size)))
        self.heads = tuple(h for h in HEADS if sizes[h] > 0)
        pyramid = 64 + sum(STAGE_WIDTHS[:shared_layers])  # the stem's and the shared stages' channels
        for name in self.heads:
            c = cin
            for si in range(shared_layers, 4):
                setattr(self, f"{name}_layer{si + 1}", Stage(c, STAGE_WIDTHS[si], blocks[si], 2, norm_type))
                c = STAGE_WIDTHS[si]
            if name in self.spatials:
                setattr(self, f"{name}_pix", nn.Conv2d(pyramid + c, sizes[name], 1, device="meta"))
            else:
                setattr(self, f"{name}_fc", nn.Linear(c, sizes[name], device="meta"))
        self.to_empty(device="cpu")
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, m.weight[0].numel(), generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, m.in_features, generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, Norm) and m.norm_type == "group":
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
        self.to(default_device(device))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W) or (B, V, 3, H, W) in [-1, 1] -> {head: (B, C)},
        a pixel-aligned head's (B, C, H', W') with H' x W' the stem's map."""
        if x.ndim == 5:
            b, v = x.shape[:2]
            out = self(x.reshape(b * v, *x.shape[2:]))
            out = {k: o.reshape(b, v, *o.shape[1:]) for k, o in out.items()}
            if self.agg_fct == "mean":
                return {k: o.mean(dim=1) for k, o in out.items()}
            return {k: o.amax(dim=1) for k, o in out.items()}
        # fp32 mode keeps the weights' dtype (fp64 in an oracle)
        dtype = self.conv1.weight.dtype if self.compute_dtype == torch.float32 else self.compute_dtype
        with full_fp32():
            x = torch.relu(self.norm0(conv(self.conv1, x.to(dtype))))
            pyramid = [x]  # h/2: the pixel-aligned heads' scale
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for si in range(self.shared_layers):
                x = getattr(self, f"layer{si + 1}")(x)
                pyramid.append(x)
            out = {}
            for name in self.heads:
                h = x
                for si in range(self.shared_layers, 4):
                    h = getattr(self, f"{name}_layer{si + 1}")(h)
                if name in self.spatials:
                    pix = getattr(self, f"{name}_pix")
                    size = pyramid[0].shape[-2:]
                    levels = [F.interpolate(p.to(pix.weight.dtype), size=size, mode="bilinear", align_corners=False)
                              for p in pyramid + [h]]
                    out[name] = pix(torch.cat(levels, dim=1))
                else:
                    fc = getattr(self, f"{name}_fc")
                    out[name] = fc(h.to(fc.weight.dtype).mean(dim=(2, 3)))  # global average pool
        return out


@torch.no_grad()
def load_torchvision_resnet34(encoder: MultiHeadImgEncoder, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Copy a torchvision-layout ResNet34 state dict's convolutions into the
    shared stages and into every head's private layer4 (counterpart of
    ``init_from_torch_state_dict``). Both sides are OIHW, so nothing is
    transposed; norm affine parameters and ``fc`` are not taken, as in JAX."""
    blocks = STAGE_BLOCKS["resnet34"]

    def load_stage(stage: Stage, prefix: str, n_blocks: int) -> None:
        for i in range(n_blocks):
            blk = getattr(stage, f"block{i}")
            blk.conv1.weight.copy_(state_dict[f"{prefix}.{i}.conv1.weight"])
            blk.conv2.weight.copy_(state_dict[f"{prefix}.{i}.conv2.weight"])
            if blk.downsample is not None:
                blk.downsample.weight.copy_(state_dict[f"{prefix}.{i}.downsample.0.weight"])

    encoder.conv1.weight.copy_(state_dict["conv1.weight"])
    for si in range(encoder.shared_layers):
        load_stage(getattr(encoder, f"layer{si + 1}"), f"layer{si + 1}", blocks[si])
    for name in encoder.heads:
        for si in range(encoder.shared_layers, 4):
            load_stage(getattr(encoder, f"{name}_layer{si + 1}"), f"layer{si + 1}", blocks[si])
