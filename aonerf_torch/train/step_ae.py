"""The auto-encoder's train step (counterpart of ``aonerf.train.step_ae``).

  loss = photometric(coarse) + photometric(fine)   fg pixels ('masked') or all
       + MSE(pred_state, deg)                       the joint-state regression
       + opacity(acc, mask) over both levels        OPACITY_LOSSES[name]

One step samples a random (instance, articulation, view) of the scene
buffers with ``batch_size`` of its pixels and the whole view as the source
image (``sample_multi_batch`` with ``src_hw``), encodes it with gradients,
renders both levels conditioned on its latents and on the embedding of the
ground-truth angle, and applies one optimizer update over the whole parameter set
(encoder, field, state decoder, degree embedding). Forward and backward run
under ``full_fp32``, so the encoder's convolutions stay fp32 whatever the
process-wide TF32 flag says (and, in bf16, every product sums in fp32).

``views_per_step`` V > 1 samples V independent views a step, each with
``batch_size // V`` of its pixels (``sample_multi_batch_multiview``), encodes
the V source views in one batch and conditions each view's rays on its own
latents and angle.

``encode_reuse`` R > 1 trains groups of R steps on one sampled view: the
first a full step, steps 2..R field-only steps on its detached latents with
fresh pixels each (photometric + opacity, no encoder), whose masked update
(``masked_field_update``) leaves the encoder, the state decoder and the
degree embedding and their optimizer slots bit for bit as they were.

``make_ae_train_step`` is the step on a batch assembled on the host
(``SapienMultiDataset.sample_train``), for a dataset whose instances differ
in articulation or view count.

Data parallelism (a ``mesh`` with more than one rank on 'data', as in
``train.step``): the device step's ranks draw from their own streams
(``fold=`` the rank), each sampling and encoding its own views from the
buffers it holds (with ``sharded_views`` its view slice), and average the
gradients and the loss parts, the encode-reuse group's field-only steps
too; the host-batched step's ranks are given the same batch and keep their
rows of it, each part weighed by the rank's share of it (the masked
photometric loss by the batch's whole foreground count), so the sum over
the ranks is the one-device step.
"""

from typing import Callable, Dict, List, Optional, Tuple

import torch

from aonerf_torch import full_fp32
from aonerf_torch.ops.math import mse2psnr
from aonerf_torch.ops.random import Draws, RowDraws
from aonerf_torch.train.losses import masked_mse, opacity_loss_bce, opacity_loss_bce_prob, opacity_loss_mse
from aonerf_torch.train.optim import Optimizer, OptState
from aonerf_torch.train.step import (
    TrainState,
    all_reduce_step,
    batch_rows,
    check_sharded_views,
    data_parallel,
    repeat_steps,
    sample_multi_batch,
    sample_multi_batch_multiview,
    sample_view,
    sample_view_pixels,
    view_src_image,
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


class RowShare:
    """A rank's rows of a host batch: ``share`` = its rows / the batch's,
    and ``fg_den`` the masked photometric loss's denominator over the whole
    batch (its foreground pixels x channels, at least 1)."""

    def __init__(self, share: float, fg_den: torch.Tensor):
        self.share, self.fg_den = share, fg_den


def _photometric_and_opacity(levels, batch, opacity_fn, opacity_lambda, photometric, rows=None):
    mask = batch["instance_mask"].to(torch.float32)
    if photometric == "masked" and rows is not None:  # this rank's part of the batch's masked mean
        loss0, loss1 = (torch.sum(mask[:, None] * (lv[0] - batch["target"]) ** 2) / rows.fg_den for lv in levels[:2])
    elif photometric == "masked":
        loss0 = masked_mse(levels[0][0], batch["target"], mask)
        loss1 = masked_mse(levels[1][0], batch["target"], mask)
    else:  # 'full': every pixel (the targets are already composited on the background)
        loss0 = torch.mean((levels[0][0] - batch["target"]) ** 2)
        loss1 = torch.mean((levels[1][0] - batch["target"]) ** 2)
        if rows is not None:
            loss0, loss1 = loss0 * rows.share, loss1 * rows.share
    loss_op = opacity_fn([levels[0][1], levels[1][1]], mask, opacity_lambda=opacity_lambda)
    if rows is not None:
        loss_op = loss_op * rows.share
    return loss0, loss1, loss_op


def ae_loss_and_grads(
    model, params: Dict[str, torch.Tensor], batch, draws, randomized: bool, white_bkgd: bool, near: float,
    far: float, opacity_lambda: float, opacity_loss: str = "bce_prob", photometric: str = "masked",
    return_latents: bool = False, rows: Optional[RowShare] = None,
):
    """The auto-encoder's loss of ``batch`` (which holds ``src_imgs``), its
    parts (loss0, loss1, loss_state, loss_op) and its gradients with respect
    to ``params`` (in their order); with ``return_latents`` also the
    latents the field was conditioned on, detached. ``rows``: the batch is
    a rank's rows of a host batch, each part its share of the whole's."""
    opacity_fn = OPACITY_LOSSES[opacity_loss]
    with full_fp32():
        src = batch["src_imgs"]
        if src.ndim == 3:  # one view (3, H, W) -> a batch of one
            src = src[None]
        levels, latents, pred_state = model(batch, src, batch["deg"], randomized, white_bkgd, near, far, draws=draws)
        loss0, loss1, loss_op = _photometric_and_opacity(levels, batch, opacity_fn, opacity_lambda, photometric,
                                                         rows)
        loss_state = torch.mean((pred_state.reshape(-1) - torch.atleast_1d(batch["deg"])) ** 2)
        if rows is not None:
            loss_state = loss_state * rows.share
        loss = loss0 + loss1 + loss_state + loss_op
        grads = torch.autograd.grad(loss, list(params.values()))
    parts = tuple(x.detach() for x in (loss0, loss1, loss_state, loss_op))
    if return_latents:
        return loss.detach(), parts, list(grads), {k: v.detach() for k, v in latents.items()}
    return loss.detach(), parts, list(grads)


def field_update_mask(params: Dict[str, torch.Tensor]) -> List[bool]:
    """True for the field's parameters (updated on every step of an
    encode-reuse group), False for the encoder, the state decoder and the
    degree embedding (frozen on its field-only steps)."""
    return [name.split(".")[0] == "field" for name in params]


def ae_field_loss_and_grads(
    model, params: Dict[str, torch.Tensor], batch, latents, draws, randomized: bool, white_bkgd: bool,
    near: float, far: float, opacity_lambda: float, opacity_loss: str = "bce_prob", photometric: str = "masked",
):
    """The field-only loss on given (detached) latents: photometric +
    opacity, no encoder and no state loss. Its parts (loss0, loss1,
    loss_op) and the gradients of the field's parameters, None for the
    others (in ``params``' order)."""
    opacity_fn = OPACITY_LOSSES[opacity_loss]
    mask = field_update_mask(params)
    field = [p for p, m in zip(params.values(), mask) if m]
    with full_fp32():
        levels = model.render(batch, randomized, white_bkgd, near, far, latents, draws=draws)
        loss0, loss1, loss_op = _photometric_and_opacity(levels, batch, opacity_fn, opacity_lambda, photometric)
        loss = loss0 + loss1 + loss_op
        got = iter(torch.autograd.grad(loss, field))
    grads = [next(got) if m else None for m in mask]
    return loss.detach(), (loss0.detach(), loss1.detach(), loss_op.detach()), grads


def masked_field_update(tx: Optimizer, params: Dict[str, torch.Tensor], grads, opt_state: OptState) -> OptState:
    """``tx``'s update restricted to the field: the other parameters and
    every per-parameter slot of theirs (moments, traces, slow weights) stay
    as they were, so a stateful optimizer moves nothing frozen; the count
    advances, so a frozen parameter's next full step uses the advanced bias
    correction, as optax's ``tree_map_params`` leaves JAX's counts. A clip
    sees the field's gradients alone."""
    return tx.update(list(params.values()), grads, opt_state, mask=field_update_mask(params))


def _metrics(loss, loss0, loss1, loss_state, loss_op, lr) -> Dict:
    return {"loss": loss, "loss_state": loss_state, "opacity_loss": loss_op, "psnr0": mse2psnr(loss0),
            "psnr1": mse2psnr(loss1), "lr": lr}


def make_ae_train_step(
    model,
    tx: Optimizer,
    white_bkgd: bool,
    near: float,
    far: float,
    randomized: bool = True,
    opacity_lambda: float = 0.5,
    opacity_loss: str = "bce_prob",
    photometric: str = "masked",
    mesh=None,
) -> Callable:
    """Returns step(state, batch, seed, draws=None) -> (state, metrics): one
    step on a batch assembled on the host and copied to the device (one
    view's rays, targets, mask, angle, ids and ``src_imgs``). The render's
    draws come from ``Draws.for_step(seed, state.step)``, as JAX's from
    ``fold_in(base_key, step)``; ``draws`` replaces them. With a
    data-parallel ``mesh`` every rank is given the same batch, keeps its
    rows of the per-ray arrays (``RowDraws`` over the draws) and encodes the
    same source view; the parts, weighed by its ``RowShare``, and the
    gradients are summed over the ranks."""
    if opacity_loss not in OPACITY_LOSSES:
        raise KeyError(f"opacity_loss {opacity_loss!r}: expected one of {sorted(OPACITY_LOSSES)}")
    ddp = data_parallel(mesh)

    def train_step(state: TrainState, batch, seed: int, draws=None):
        device = batch["rays_o"].device
        if draws is None:
            draws = Draws.for_step(seed, state.step, device)
        rows = None
        if ddp:
            total = batch["rays_o"].shape[0]
            start, stop = batch_rows(mesh, total)
            fg = batch["instance_mask"].to(torch.float32)
            rows = RowShare((stop - start) / total, torch.clamp(torch.sum(fg) * batch["target"].shape[-1], min=1.0))
            per_ray = ("rays_o", "rays_d", "viewdirs", "target", "instance_mask")
            batch = {k: v[start:stop] if k in per_ray else v for k, v in batch.items()}
            draws = RowDraws(draws, start, stop, total)
        loss, (loss0, loss1, loss_state, loss_op), grads = ae_loss_and_grads(
            model, state.params, batch, draws, randomized, white_bkgd, near, far, opacity_lambda,
            opacity_loss=opacity_loss, photometric=photometric, rows=rows,
        )
        if ddp:
            grads, (loss, loss0, loss1, loss_state, loss_op) = all_reduce_step(
                grads, (loss, loss0, loss1, loss_state, loss_op), mesh, mean=False)
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = _metrics(loss, loss0, loss1, loss_state, loss_op, tx.schedule(state.step))
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return train_step


def make_ae_device_train_step(
    model,
    tx: Optimizer,
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
    mesh=None,
    sharded_views: bool = False,
) -> Callable:
    """Returns step(state, buffers, seed, draws=None) -> (state, metrics of
    the last step), ``inner_steps`` auto-encoder steps in a plain loop.
    ``buffers`` are ``SapienMultiDataset.device_buffers`` on the device;
    each step's draws come from ``Draws.for_step(seed, step)`` on their
    device, and ``draws`` replaces them for a single step. Metrics stay on
    the device.

    With ``encode_reuse`` R > 1 it is step(state, buffers, seed,
    draws_for=None): ``inner_steps // R`` groups, each step's draws from
    ``draws_for(step)`` (default ``Draws.for_step(seed, step)``): the
    group's first step draws the view, its pixels and the render, each
    field-only step its pixels and the render. A group's metrics: loss =
    the last field-only loss + the first step's state loss, the other
    parts of the last step, lr at the step after the group (as JAX's).

    With a data-parallel ``mesh`` each step's draws are the rank's own
    (``fold=`` its data index) and every step's gradients and parts are
    averaged over the ranks; ``sharded_views`` says the buffers are this
    rank's view slice."""
    check_sharded_views(mesh, sharded_views)
    ddp = data_parallel(mesh)
    fold = mesh.data_index if ddp else None

    def reduce(grads, parts):
        return all_reduce_step(grads, parts, mesh, mean=True) if ddp else (grads, parts)

    if views_per_step > 1 and batch_size % views_per_step != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by views_per_step ({views_per_step}); otherwise "
            f"{batch_size % views_per_step} rays/step would silently be dropped"
        )
    if encode_reuse > 1 and views_per_step > 1:
        raise ValueError(
            "encode_reuse and views_per_step are alternative encoder-amortization levers; combine is not supported"
        )
    if encode_reuse > 1 and inner_steps % encode_reuse != 0:
        raise ValueError(
            f"inner_steps ({inner_steps}) must be a multiple of encode_reuse ({encode_reuse}) so a dispatch holds "
            "whole groups"
        )
    if opacity_loss not in OPACITY_LOSSES:
        raise KeyError(f"opacity_loss {opacity_loss!r}: expected one of {sorted(OPACITY_LOSSES)}")
    w, h = img_wh
    losses = dict(opacity_lambda=opacity_lambda, opacity_loss=opacity_loss, photometric=photometric)

    def one_step(state: TrainState, buffers, seed: int, draws=None):
        if draws is None:
            draws = Draws.for_step(seed, state.step, buffers["rgb"].device, fold=fold)
        if views_per_step > 1:
            batch = sample_multi_batch_multiview(buffers, draws, batch_size, views_per_step, src_hw=(h, w))
        else:
            batch = sample_multi_batch(buffers, draws, batch_size, src_hw=(h, w))
        loss, parts, grads = ae_loss_and_grads(
            model, state.params, batch, draws, randomized, white_bkgd, near, far, **losses
        )
        grads, (loss, *parts) = reduce(grads, (loss, *parts))
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = _metrics(loss, *parts, tx.schedule(state.step))
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    if encode_reuse <= 1:
        return one_step if inner_steps <= 1 else repeat_steps(one_step, inner_steps)

    def group_step(state: TrainState, buffers, draws_for: Callable):
        draws = draws_for(state.step)
        view = sample_view(buffers, draws)
        batch = sample_view_pixels(view, buffers["directions"], draws, batch_size)
        batch["src_imgs"] = view_src_image(view, (h, w))
        loss, parts, grads, latents = ae_loss_and_grads(
            model, state.params, batch, draws, randomized, white_bkgd, near, far, return_latents=True, **losses
        )
        grads, (_, _, _, loss_state, _) = reduce(grads, (loss, *parts))
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        state = TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)
        for _ in range(encode_reuse - 1):
            draws = draws_for(state.step)
            batch = sample_view_pixels(view, buffers["directions"], draws, batch_size)
            loss, parts, grads = ae_field_loss_and_grads(
                model, state.params, batch, latents, draws, randomized, white_bkgd, near, far, **losses
            )
            grads, (loss, loss0, loss1, loss_op) = reduce(grads, (loss, *parts))
            opt_state = masked_field_update(tx, state.params, grads, state.opt_state)
            state = TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)
        return state, _metrics(loss + loss_state, loss0, loss1, loss_state, loss_op, tx.schedule(state.step))

    def reuse_steps(state: TrainState, buffers, seed: int, draws_for: Optional[Callable] = None):
        if draws_for is None:
            device = buffers["rgb"].device
            draws_for = lambda step: Draws.for_step(seed, step, device, fold=fold)  # noqa: E731
        metrics = {}
        for _ in range(inner_steps // encode_reuse):
            state, metrics = group_step(state, buffers, draws_for)
        return state, metrics

    return reuse_steps
