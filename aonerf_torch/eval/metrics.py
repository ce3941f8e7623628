"""Image quality metrics: PSNR, object-masked PSNR, SSIM, LPIPS from an
exported weights file (``eval.lpips``), the reference's legacy variants and
split summaries (counterpart of ``aonerf.eval.metrics``).

SSIM: Wang et al. with an 11x11 Gaussian window (sigma 1.5), k1=0.01,
k2=0.03 on [0,1] images.
"""

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from aonerf_torch import full_fp32


def psnr_image(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR of one image (any shape), base-10 dB."""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log(mse) / math.log(10.0)


def masked_psnr(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSNR over foreground pixels only (object PSNR)."""
    m = mask.reshape(-1).to(torch.float32)
    p = pred.reshape(-1, pred.shape[-1])
    t = target.reshape(-1, target.shape[-1])
    num = torch.sum(m[:, None] * (p - t) ** 2)
    den = torch.clamp(torch.sum(m) * p.shape[-1], min=1.0)
    return -10.0 * torch.log(num / den) / math.log(10.0)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim_image(
    pred: torch.Tensor,
    target: torch.Tensor,
    max_val: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """SSIM of one (H, W, C) image pair, mean over pixels and channels."""
    kern = _gaussian_kernel(kernel_size, sigma).to(pred.device)[None, None]  # (1,1,k,k)

    def filt(img):
        # depthwise valid conv per channel: (H, W, C) -> (C, 1, H, W)
        out = F.conv2d(img.permute(2, 0, 1)[:, None], kern)
        return out[:, 0].permute(1, 2, 0)

    x = pred.to(torch.float32)
    y = target.to(torch.float32)
    # SSIM's variance terms (filt(x*x) - mu^2) cancel catastrophically in
    # TF32; the JAX reference forces HIGHEST precision for the same reason
    with full_fp32():
        mu_x, mu_y = filt(x), filt(y)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sigma_x = filt(x * x) - mu_x2
        sigma_y = filt(y * y) - mu_y2
        sigma_xy = filt(x * y) - mu_xy
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    )
    return torch.mean(ssim_map)


def lpips_image(
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: Union[str, Dict[str, torch.Tensor], None] = None,
) -> float:
    """LPIPS of one (H, W, 3) pair; NaN without weights. ``weights`` is the
    exported ``.npz`` path (read for this one call, as JAX's) or what
    ``eval.lpips.load_weights`` returned, which a caller scoring many
    images loads once."""
    if weights is None:
        return float("nan")
    from aonerf_torch.eval.lpips import lpips_from_npz

    return float(lpips_from_npz(weights, pred, target))


def mse_legacy(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Squared error, optionally restricted to the ``valid_mask`` pixels,
    mean-reduced or (any other ``reduction``) elementwise."""
    value = (pred - target) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr_legacy(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """-10 log10(mse_legacy), without psnr_each's clip to [0, 1]."""
    return -10.0 * torch.log10(mse_legacy(pred, target, valid_mask, reduction))


def psnr_each(preds: Sequence[torch.Tensor], gts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-image PSNR of a render set, prediction and target both clipped to
    [0, 1]; stacked."""
    return torch.stack([psnr_image(p.clamp(0.0, 1.0), g.clamp(0.0, 1.0)) for p, g in zip(preds, gts)])


def ssim_legacy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SSIM of one (H, W, C) pair, both clipped to [0, 1] first."""
    return ssim_image(pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0))


def ssim_each(preds: Sequence[torch.Tensor], gts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-image clipped SSIM of a render set; stacked."""
    return torch.stack([ssim_legacy(p, g) for p, g in zip(preds, gts)])


def depth_mae_rmse(pred: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmse, mae) of a depth render."""
    abs_diff = torch.abs(pred - target)
    return torch.sqrt(torch.mean(abs_diff**2)), torch.mean(abs_diff)


def summarize_metric(
    values: Sequence[float],
    i_train: Optional[Sequence[int]] = None,
    i_val: Optional[Sequence[int]] = None,
    i_test: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """Split summary: with no split indices everything lands in 'test';
    otherwise per-split means plus the overall mean under 'all'."""
    vals = np.asarray([float(v) for v in values])
    out: Dict[str, float] = {}
    if i_train is None and i_val is None and i_test is None:
        out["test"] = float(np.mean(vals)) if len(vals) else float("nan")
        return out
    for name, idx in (("train", i_train), ("val", i_val), ("test", i_test)):
        if idx is not None and len(idx):
            out[name] = float(np.mean(vals[np.asarray(idx)]))
    out["all"] = float(np.mean(vals)) if len(vals) else float("nan")
    return out
