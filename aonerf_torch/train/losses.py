"""Loss terms beyond plain MSE (counterpart of ``aonerf.train.losses``): the
auto-decoder's code regularization, and the auto-encoder's opacity losses
and foreground-only photometric loss.

``code_regularization`` is weight * sum over the three codes of the mean
over channels of the code's norm over axis 0: for the (1, C) codes of one
view that is the mean of |c_j|, not an L2 norm of the code.

The opacity losses take both levels' accumulated opacity and the instance
mask: ``opacity_loss_bce_prob`` (the default) treats acc as the probability
it is, clipped to [eps, 1 - eps] so saturated rays get no gradient;
``opacity_loss_bce`` is the reference's BCE-with-logits of acc;
``opacity_loss_mse`` the clamped MSE; ``opacity_loss_autorf`` the AutoRF
fg/bg form, whose fg terms both read the coarse level, as the reference's.
Masked means are where-averages, as in JAX.
"""

from typing import Dict, Sequence

import torch


def code_regularization(latents: Dict[str, torch.Tensor], weight: float = 1e-4) -> torch.Tensor:
    reg = 0.0
    for name in ("density", "color", "articulation"):
        code = torch.atleast_2d(latents[name])
        reg = reg + torch.mean(torch.sqrt(torch.sum(code * code, dim=0)))
    return weight * reg


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's min(max(x, lo), hi): at x exactly lo or hi the gradient is
    split in half between the tied arguments, where torch.clamp passes it
    whole."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def opacity_loss_mse(accs: Sequence[torch.Tensor], instance_mask: torch.Tensor) -> torch.Tensor:
    mask = instance_mask.to(torch.float32)
    loss = 0.0
    for acc in accs:
        loss = loss + torch.mean((_clip(acc, 0.0, 1.0) - mask) ** 2)
    return loss


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(-|x|)) for stability, as torch's BCEWithLogitsLoss
    return torch.mean(torch.relu(logits) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits))))


def opacity_loss_bce(
    accs: Sequence[torch.Tensor], instance_mask: torch.Tensor, opacity_lambda: float = 0.05
) -> torch.Tensor:
    mask = instance_mask.to(torch.float32)
    loss = 0.0
    for acc in accs:
        loss = loss + _bce_with_logits(acc, mask)
    return loss * opacity_lambda


def opacity_loss_bce_prob(
    accs: Sequence[torch.Tensor], instance_mask: torch.Tensor, opacity_lambda: float = 0.5, eps: float = 1e-2
) -> torch.Tensor:
    mask = instance_mask.to(torch.float32)
    loss = 0.0
    for acc in accs:
        p = _clip(acc, eps, 1.0 - eps)
        loss = loss + torch.mean(-(mask * torch.log(p) + (1.0 - mask) * torch.log1p(-p)))
    return loss * opacity_lambda


def opacity_loss_autorf(accs: Sequence[torch.Tensor], instance_mask: torch.Tensor) -> torch.Tensor:
    mask = instance_mask.to(torch.bool)
    coarse, fine = accs[0], accs[1]
    n = mask.numel()
    bg = ~mask
    bg_count, fg_count = bg.sum(), mask.sum()
    bg_ratio, fg_ratio = bg_count / n, fg_count / n

    def mean_where(x, m, count):
        mean = torch.sum(torch.where(m, x, torch.zeros_like(x))) / torch.clamp(count, min=1)
        return torch.where(count > 0, mean, torch.zeros_like(mean))

    loss = mean_where(coarse, bg, bg_count) * bg_ratio
    loss = loss + mean_where(fine, bg, bg_count) * bg_ratio
    loss = loss + fg_ratio * mean_where(1.0 - coarse, mask, fg_count)
    loss = loss + fg_ratio * mean_where(1.0 - coarse, mask, fg_count)
    return loss


def masked_mse(pred: torch.Tensor, target: torch.Tensor, instance_mask: torch.Tensor) -> torch.Tensor:
    """Foreground-only photometric MSE: the squared error summed over mask
    pixels and channels, over (mask pixels x channels), at least 1."""
    mask = instance_mask.to(torch.float32)[..., None]
    num = torch.sum(mask * (pred - target) ** 2)
    den = torch.clamp(torch.sum(mask) * pred.shape[-1], min=1.0)
    return num / den
