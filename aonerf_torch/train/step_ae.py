"""The auto-encoder's train step (counterpart of ``aonerf.train.step_ae``).

  loss = photometric(coarse) + photometric(fine)   fg pixels ('masked') or all
       + MSE(pred_state, deg)                       the joint-state regression
       + opacity(acc, mask) over both levels        OPACITY_LOSSES[name]

One step samples a random (instance, articulation, view) of the scene
buffers with ``batch_size`` of its pixels and the whole view as the source
image (``sample_multi_batch`` with ``src_hw``), encodes it with gradients,
renders both levels conditioned on its latents and on the embedding of the
ground-truth angle, and applies one Adam over the whole parameter set
(encoder, field, state decoder, degree embedding). Forward and backward run
under ``full_fp32``, so the encoder's convolutions stay fp32 whatever the
process-wide TF32 flag says (and, in bf16, every product sums in fp32).

``views_per_step`` V > 1 samples V independent views a step, each with
``batch_size // V`` of its pixels (``sample_multi_batch_multiview``), encodes
the V source views in one batch and conditions each view's rays on its own
latents and angle. Not ported yet (ROADMAP Queue 1 item 1): one encode for
several field-only steps (``encode_reuse``), which raises.
"""

from typing import Callable, Dict, List, Tuple

import torch

from aonerf_torch import full_fp32
from aonerf_torch.ops.math import mse2psnr
from aonerf_torch.ops.random import Draws
from aonerf_torch.train.losses import masked_mse, opacity_loss_bce, opacity_loss_bce_prob, opacity_loss_mse
from aonerf_torch.train.step import (
    Adam,
    TrainState,
    repeat_steps,
    sample_multi_batch,
    sample_multi_batch_multiview,
)

# The opacity-loss variants by the config's name. 'bce_prob', the default,
# has its optimum at acc == mask and no force on saturated rays; 'bce_logits'
# (the reference's active choice) and 'mse' are there for parity.
OPACITY_LOSSES = {
    "mse": lambda accs, mask, opacity_lambda: opacity_loss_mse(accs, mask) * opacity_lambda,
    "bce_prob": opacity_loss_bce_prob,
    "bce_logits": opacity_loss_bce,
    "none": lambda accs, mask, opacity_lambda: torch.zeros((), device=mask.device),
    "bce_prob+mse": lambda accs, mask, opacity_lambda: (
        opacity_loss_bce_prob(accs, mask, opacity_lambda=opacity_lambda)
        + opacity_loss_mse(accs, mask) * opacity_lambda
    ),
}


def ae_loss_and_grads(
    model, params: Dict[str, torch.Tensor], batch, draws, randomized: bool, white_bkgd: bool, near: float,
    far: float, opacity_lambda: float, opacity_loss: str = "bce_prob", photometric: str = "masked",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], List[torch.Tensor]]:
    """The auto-encoder's loss of ``batch`` (which holds ``src_imgs``), its
    parts (loss0, loss1, loss_state, loss_op) and its gradients with respect
    to ``params`` (in their order)."""
    opacity_fn = OPACITY_LOSSES[opacity_loss]
    with full_fp32():
        src = batch["src_imgs"]
        if src.ndim == 3:  # one view (3, H, W) -> a batch of one
            src = src[None]
        levels, _, pred_state = model(batch, src, batch["deg"], randomized, white_bkgd, near, far, draws=draws)
        mask = batch["instance_mask"].to(torch.float32)
        if photometric == "masked":
            loss0 = masked_mse(levels[0][0], batch["target"], mask)
            loss1 = masked_mse(levels[1][0], batch["target"], mask)
        else:  # 'full': every pixel (the targets are already composited on the background)
            loss0 = torch.mean((levels[0][0] - batch["target"]) ** 2)
            loss1 = torch.mean((levels[1][0] - batch["target"]) ** 2)
        loss_state = torch.mean((pred_state.reshape(-1) - torch.atleast_1d(batch["deg"])) ** 2)
        loss_op = opacity_fn([levels[0][1], levels[1][1]], mask, opacity_lambda=opacity_lambda)
        loss = loss0 + loss1 + loss_state + loss_op
        grads = torch.autograd.grad(loss, list(params.values()))
    parts = tuple(x.detach() for x in (loss0, loss1, loss_state, loss_op))
    return loss.detach(), parts, list(grads)


def make_ae_device_train_step(
    model,
    tx: Adam,
    white_bkgd: bool,
    near: float,
    far: float,
    img_wh: Tuple[int, int],
    batch_size: int = 4096,
    randomized: bool = True,
    opacity_lambda: float = 0.5,
    inner_steps: int = 1,
    opacity_loss: str = "bce_prob",
    photometric: str = "masked",
    views_per_step: int = 1,
    encode_reuse: int = 1,
) -> Callable:
    """Returns step(state, buffers, seed, draws=None) -> (state, metrics of
    the last step), ``inner_steps`` auto-encoder steps in a plain loop.
    ``buffers`` are ``SapienMultiDataset.device_buffers`` on the device;
    each step's draws come from ``Draws.for_step(seed, step)`` on their
    device, and ``draws`` replaces them for a single step. Metrics stay on
    the device."""
    if views_per_step > 1 and batch_size % views_per_step != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by views_per_step ({views_per_step}); otherwise "
            f"{batch_size % views_per_step} rays/step would silently be dropped"
        )
    if encode_reuse > 1 and views_per_step > 1:
        raise ValueError(
            "encode_reuse and views_per_step are alternative encoder-amortization levers; combine is not supported"
        )
    if encode_reuse > 1:
        raise NotImplementedError(
            f"encode_reuse={encode_reuse}: one encode a step only; several field-only steps on one encode are "
            "not ported yet (ROADMAP Queue 1 item 1)"
        )
    if opacity_loss not in OPACITY_LOSSES:
        raise KeyError(f"opacity_loss {opacity_loss!r}: expected one of {sorted(OPACITY_LOSSES)}")
    w, h = img_wh

    def one_step(state: TrainState, buffers, seed: int, draws=None):
        if draws is None:
            draws = Draws.for_step(seed, state.step, buffers["rgb"].device)
        if views_per_step > 1:
            batch = sample_multi_batch_multiview(buffers, draws, batch_size, views_per_step, src_hw=(h, w))
        else:
            batch = sample_multi_batch(buffers, draws, batch_size, src_hw=(h, w))
        loss, (loss0, loss1, loss_state, loss_op), grads = ae_loss_and_grads(
            model, state.params, batch, draws, randomized, white_bkgd, near, far, opacity_lambda,
            opacity_loss=opacity_loss, photometric=photometric,
        )
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = {
            "loss": loss,
            "loss_state": loss_state,
            "opacity_loss": loss_op,
            "psnr0": mse2psnr(loss0),
            "psnr1": mse2psnr(loss1),
            "lr": tx.schedule(state.step),
        }
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return one_step if inner_steps <= 1 else repeat_steps(one_step, inner_steps)
