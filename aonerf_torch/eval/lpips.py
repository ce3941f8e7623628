"""LPIPS (the VGG16 variant), parameterized by an exported weights file
(counterpart of ``aonerf.eval.lpips``).

The ``.npz`` is the layout ``tools/export_lpips_weights.py`` writes:
  features_{i}_kernel / features_{i}_bias  VGG16 conv kernels (HWIO) and
    biases, i the torchvision feature indices (0, 2, 5, 7, 10, 12, 14, 17,
    19, 21, 24, 26, 28)
  lin_{j}_kernel  the five 1x1 linear heads, j in 0..4
``load_weights`` reads it once and transposes each kernel to OIHW; the
network then runs NCHW through ``F.conv2d`` (library convolutions: the JAX
reference is ``lax.conv``, not a TPU kernel), in fp32 whatever the TF32
flags say. The features are tapped after relu1_2 .. relu5_3, with 2x2
max-pooling after features 2, 7, 14 and 21; each tap is unit-normalized over
channels (sqrt(sum + 1e-10)), and the distance is the sum over taps of the
head-weighted squared difference, averaged over pixels.

No exported file ships with the repository (nothing can be downloaded);
``write_random_weights`` writes one of the same layout from a seed, at
VGG16's widths by default, for tests and smoke runs.
"""

from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F

from aonerf_torch import DeviceLike, default_device, full_fp32

CONV_IDXS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
POOL_AFTER = frozenset((2, 7, 14, 21))  # max-pool after the relu of these features
TAPS = frozenset((2, 7, 14, 21, 28))  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

# each feature's output channels in VGG16 (its input: the previous one's, 3 first)
VGG16_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Weights = Dict[str, torch.Tensor]


def load_weights(path: str, device: DeviceLike = None) -> Weights:
    """The exported weights on ``device`` (cuda unless it says otherwise):
    conv kernels as OIHW, biases, and the five heads flattened to (C,)."""
    dev = default_device(device)
    out = {}
    with np.load(path) as data:
        for idx in CONV_IDXS:
            kernel = np.asarray(data[f"features_{idx}_kernel"], np.float32)
            out[f"features_{idx}_kernel"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            out[f"features_{idx}_bias"] = torch.from_numpy(np.asarray(data[f"features_{idx}_bias"], np.float32))
        for j in range(len(TAPS)):
            out[f"lin_{j}_kernel"] = torch.from_numpy(np.asarray(data[f"lin_{j}_kernel"], np.float32).reshape(-1))
    return {k: v.to(dev) for k, v in out.items()}


def vgg_features(weights: Weights, x: torch.Tensor) -> List[torch.Tensor]:
    """The five relu taps of an NCHW batch."""
    feats = []
    for idx in CONV_IDXS:
        x = torch.relu(F.conv2d(x, weights[f"features_{idx}_kernel"], weights[f"features_{idx}_bias"], padding=1))
        if idx in TAPS:
            feats.append(x)
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, 2)
    return feats


def lpips_distance(weights: Weights, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """LPIPS between two (H, W, 3) images in [0, 1], on the weights' device
    and in their dtype (fp32 as loaded): a 0-d tensor."""
    head = weights["lin_0_kernel"]
    dev, dtype = head.device, head.dtype
    shift = torch.tensor(_SHIFT, device=dev, dtype=dtype).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev, dtype=dtype).view(1, 3, 1, 1)

    def prep(img):
        x = img.to(device=dev, dtype=dtype).permute(2, 0, 1)[None] * 2.0 - 1.0
        return (x - shift) / scale

    with full_fp32():
        fx = vgg_features(weights, prep(pred))
        fy = vgg_features(weights, prep(target))
    total = torch.zeros((), device=dev, dtype=dtype)
    for j, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
        w = weights[f"lin_{j}_kernel"].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((a - b) ** 2 * w, dim=1))
    return total


def lpips_from_npz(weights: Union[str, Weights], pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """LPIPS between two (H, W, 3) images in [0, 1]: ``weights`` a path (read
    here, onto the images' device) or what ``load_weights`` returned."""
    if isinstance(weights, str):
        weights = load_weights(weights, pred.device)
    return lpips_distance(weights, pred, target)


def write_random_weights(path: str, seed: int, widths=VGG16_WIDTHS) -> None:
    """An ``.npz`` in the exported layout with random weights from ``seed``:
    each feature's HWIO kernel He-normal over its 3x3 fan-in, small biases,
    and non-negative heads (as LPIPS's are) over the taps' channels."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for idx, cout in zip(CONV_IDXS, widths):
        out[f"features_{idx}_kernel"] = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))).astype(
            np.float32)
        out[f"features_{idx}_bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
        cin = cout
    taps = [w for idx, w in zip(CONV_IDXS, widths) if idx in TAPS]
    for j, c in enumerate(taps):
        out[f"lin_{j}_kernel"] = (np.abs(rng.standard_normal(c)) / c).astype(np.float32)
    np.savez(path, **out)
