"""Scalar loss/metric math (counterpart of ``aonerf.ops.math``)."""

import math

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR in dB from an MSE value (natural-log formulation)."""
    return -10.0 * torch.log(mse) / math.log(10.0)
