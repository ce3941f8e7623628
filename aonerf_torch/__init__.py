"""aonerf in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The JAX package ``aonerf`` is the reference; module names here mirror it so
each counterpart is easy to find. This package imports neither JAX nor
anything of ``aonerf``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no CPU request they raise.
"""

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no card is present; there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Keep float32 convolutions and matmuls out of TF32, and the fp32 sums
    of bf16 matmuls out of bf16, for the duration, whatever the
    process-wide flags say, and restore the flags after.

    cuDNN runs float32 convolutions in TF32 by default on the card, which
    keeps ~3 decimal digits; cuBLAS may add a bf16 matmul's split-K partial
    sums in bf16 by default, which flax's fp32 sums never do. A product's
    backward reads the flags when it runs, so a caller that differentiates
    holds this around the backward too.
    """
    cuda_matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, cuda_matmul.allow_tf32,
             cuda_matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    cuda_matmul.allow_tf32 = False
    cuda_matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, cuda_matmul.allow_tf32,
         cuda_matmul.allow_bf16_reduced_precision_reduction) = saved
