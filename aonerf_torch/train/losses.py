"""Loss terms beyond plain MSE (counterpart of ``aonerf.train.losses``; the
auto-decoder's code regularization only, the opacity losses belong to the
auto-encoder, which is not ported).

``code_regularization`` is weight * sum over the three codes of the mean
over channels of the code's norm over axis 0: for the (1, C) codes of one
view that is the mean of |c_j|, not an L2 norm of the code.
"""

from typing import Dict

import torch


def code_regularization(latents: Dict[str, torch.Tensor], weight: float = 1e-4) -> torch.Tensor:
    reg = 0.0
    for name in ("density", "color", "articulation"):
        code = torch.atleast_2d(latents[name])
        reg = reg + torch.mean(torch.sqrt(torch.sum(code * code, dim=0)))
    return weight * reg
