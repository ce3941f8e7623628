"""Test-time latent-code optimization (counterpart of
``aonerf.train.optimize``): fit a fresh (shape, appearance) code pair for
one instance to its posed views, with the trained field and the
articulation table frozen.

Each step samples a batch as the auto-decoder's train step does
(``sample_multi_batch`` on the instance's buffers), renders it with the
codes and the articulation table's row of the sampled articulation, and
takes a plain Adam step at a constant learning rate on the codes alone. The
loss is MSE(coarse) + MSE(fine) + reg_weight * (||density|| + ||color||):
an L2 norm of each code, unlike the training's ``code_regularization``.
"""

from typing import Dict, Optional, Tuple

import torch

from aonerf_torch import full_fp32
from aonerf_torch.ops.math import img2mse, mse2psnr
from aonerf_torch.train.optim import Adam
from aonerf_torch.train.step import sample_multi_batch

# Draws.for_step(seed, CODE_STEP) is the code optimization's one stream: a
# step index no training step reaches, so its numbers are not a train step's.
CODE_STEP = -17


def init_codes(draws, obj_code_dim: int = 128, scale: float = 0.01) -> Dict[str, torch.Tensor]:
    """Small normal codes ((1, obj_code_dim) each), so the field starts near
    its instance-agnostic mean."""
    return {
        "density": scale * draws.normal((1, obj_code_dim)),
        "color": scale * draws.normal((1, obj_code_dim)),
    }


def optimize_codes(
    model,
    art_table: torch.Tensor,
    buffers: Dict[str, torch.Tensor],
    draws,
    n_steps: int = 500,
    lr: float = 1e-2,
    batch_size: int = 1024,
    obj_code_dim: int = 128,
    white_bkgd: bool = True,
    near: float = 2.0,
    far: float = 6.0,
    reg_weight: float = 1e-4,
    inner_steps: int = 50,
    init: Optional[Dict[str, torch.Tensor]] = None,
    randomized: bool = True,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Fit codes for the one instance of ``buffers`` (device_buffers with
    n_i == 1) through the trained ``model`` (an ``ArticulatedNeRF``, left
    unchanged) and ``art_table`` (n_articulations, art_dim). ``draws`` gives
    every random number in order: the two codes' normals (unless ``init``),
    then each step's batch and render draws.

    Runs whole groups of ``inner_steps`` steps until ``n_steps`` are done;
    history['loss'] and history['psnr1'] hold the last step of each group.
    Returns (codes, history).
    """
    codes = init if init is not None else init_codes(draws, obj_code_dim)
    codes = {k: v.detach().clone().requires_grad_(True) for k, v in codes.items()}
    params = [codes["density"], codes["color"]]
    tx = Adam(lambda count: lr)
    opt_state = tx.init(params)
    art_table = art_table.detach()
    frozen = [p for p in model.parameters() if p.requires_grad]
    history = {"loss": [], "psnr1": []}
    try:
        for p in frozen:
            p.requires_grad_(False)
        done = 0
        while done < n_steps:
            for _ in range(inner_steps):
                batch = sample_multi_batch(buffers, draws, batch_size)
                latents = {
                    "density": codes["density"],
                    "color": codes["color"],
                    "articulation": torch.atleast_2d(art_table[batch["articulation_id"]]),
                }
                out = model(batch, randomized, white_bkgd, near, far, latents, draws=draws)
                loss0 = img2mse(out[0][0], batch["target"])
                loss1 = img2mse(out[1][0], batch["target"])
                reg = reg_weight * (torch.linalg.norm(codes["density"]) + torch.linalg.norm(codes["color"]))
                loss = loss0 + loss1 + reg
                with full_fp32():  # as the field's forward
                    grads = torch.autograd.grad(loss, params)
                opt_state = tx.update(params, list(grads), opt_state)
            done += inner_steps
            history["loss"].append(float(loss.detach()))
            history["psnr1"].append(float(mse2psnr(loss1.detach())))
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return {k: v.detach() for k, v in codes.items()}, history
