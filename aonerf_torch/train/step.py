"""The train steps (counterpart of ``aonerf.train.step``): batch sampling on
the device, the hierarchical render, MSE(coarse) + MSE(fine), gradients, and an
optimizer of ``train.optim`` (by default Adam with the log-lerp schedule).

  vanilla:      a gather of ``batch_size`` rays from the scene's ray buffers;
                both levels through the fused level kernels
  auto-decoder: one random (instance, articulation, view) and
                ``batch_size`` of its pixels, rays built from the stored c2w;
                the articulated field (plain PyTorch) conditioned on the
                codes of that instance and articulation; plus the code
                regularization, with one optimizer over the field and the
                codes (with ``latent_lr``, the codes by their own AdamW)

A step's random numbers come from ``Draws.for_step(seed, step)``, as JAX's
from ``fold_in(base_key, step)``, so a resumed run draws what an unbroken run
would. The model's parameters are updated in place; ``TrainState`` holds
them by name beside the step count and the optimizer state.

Data parallelism (``mesh`` with more than one rank on 'data', the JAX
steps' ``mesh=``; ``parallel.mesh``): every rank holds the same parameters
and ends each step with them, after one all-reduce of the gradients and
the loss parts.

  vanilla:      as JAX samples the global batch and XLA splits it, every
                rank draws the whole batch's numbers and keeps its
                contiguous rows (``RowDraws``); the gradient is
                sum over ranks of (rows_r / batch_size) x the rank's, the
                one-device step's
  auto-decoder: each rank draws its own ``batch_size`` from its own stream
                (``Draws.for_step(seed, step, fold=rank)``, as JAX folds
                ``axis_index('data')``), from the buffers it holds (all
                views, or with ``sharded_views`` its view slice,
                ``parallel.shard_multi_buffers``); gradients and losses are
                averaged over the ranks
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from aonerf_torch import full_fp32
from aonerf_torch.ops.kernels.fused_render import RAY_TILE
from aonerf_torch.ops.math import img2mse, mse2psnr
from aonerf_torch.ops.random import Draws, RowDraws
from aonerf_torch.parallel import distributed
from aonerf_torch.train.losses import code_regularization
from aonerf_torch.train.optim import Optimizer, OptState, make_adam  # noqa: F401 (make_adam: JAX keeps it here)


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState


def create_train_state(model: torch.nn.Module, tx: Optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=tx.init(list(params.values())))


def data_parallel(mesh) -> bool:
    """True when ``mesh`` has more than one rank on its data axis."""
    return mesh is not None and mesh.n_data > 1


def check_sharded_views(mesh, sharded_views: bool) -> None:
    if sharded_views and not data_parallel(mesh):
        raise ValueError("sharded_views requires a mesh with more than one rank on 'data'")


def all_reduce_step(grads: List[Optional[torch.Tensor]], parts, mesh, mean: bool):
    """The gradients (None stays None) and the loss parts summed over the
    ranks in one collective, then divided by the rank count when ``mean``
    (gloo has no average); returns (grads, parts)."""
    live = [g for g in grads if g is not None] + list(parts)
    distributed.all_reduce_sum_(live)
    if mean:
        for t in live:
            t.div_(mesh.n_data)
    return grads, tuple(parts)


def share_sum(grads: List[torch.Tensor], parts, share: float, mesh):
    """A rank's gradients and loss parts weighed by its share of the
    batch's rows, summed over the ranks: the whole batch's (grads, parts)."""
    for t in (*grads, *parts):
        t.mul_(share)
    return all_reduce_step(grads, parts, mesh, mean=False)


def batch_rows(mesh, batch_size: int, tile: int = 1) -> Tuple[int, int]:
    """This rank's rows of a ``batch_size`` batch, in whole ``tile``s.
    Raises when a rank would get none."""
    start, stop = mesh.rows(batch_size, tile)
    if stop <= start:
        raise ValueError(f"batch_size {batch_size} leaves rank {mesh.data_index} of {mesh.n_data} no rows")
    return start, stop


def sample_ray_batch(buffers: Dict[str, torch.Tensor], draws, batch_size: int) -> Dict[str, torch.Tensor]:
    """Uniform with-replacement gather of ``batch_size`` rays from the
    device-resident scene buffers."""
    n = buffers["rays_o"].shape[0]
    idx = draws.randint(n, (batch_size,))
    return {k: v[idx] for k, v in buffers.items()}


def vanilla_loss_and_grads(
    model, params: Dict[str, torch.Tensor], batch, draws, randomized: bool, white_bkgd: bool,
    near: float, far: float,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], List[torch.Tensor]]:
    """loss = MSE(coarse) + MSE(fine) of ``batch`` and its gradients with
    respect to ``params`` (in their order)."""
    out = model(batch, randomized, white_bkgd, near, far, draws=draws)
    loss0 = img2mse(out[0][0], batch["target"])
    loss1 = img2mse(out[1][0], batch["target"])
    loss = loss1 + loss0
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), (loss0.detach(), loss1.detach()), list(grads)


def make_vanilla_train_step(
    model,
    tx: Optimizer,
    white_bkgd: bool,
    near: float,
    far: float,
    batch_size: int = 2048,
    randomized: bool = True,
    mesh=None,
) -> Callable:
    """Returns step(state, buffers, seed, draws=None) -> (state, metrics).

    Per step: gather a batch, render both levels, MSE(coarse) + MSE(fine),
    backward, the optimizer. ``draws`` defaults to ``Draws.for_step(seed,
    state.step)`` on the buffers' device. Metrics stay on the device.

    With a data-parallel ``mesh`` each rank takes its rows of the batch
    (``batch_rows``, ``RowDraws`` over ``draws``, which draw the whole
    batch's numbers), weighs its gradients and losses by its share of the
    rows and sums them over the ranks: every rank holds the whole ray
    buffers, as the reference's DDP did.
    """
    ddp = data_parallel(mesh)

    def train_step(state: TrainState, buffers, seed: int, draws=None):
        device = buffers["rays_o"].device
        if draws is None:
            draws = Draws.for_step(seed, state.step, device)
        rows = batch_size
        if ddp:
            start, stop = batch_rows(mesh, batch_size, RAY_TILE)  # the fused backward's ray tile
            draws, rows = RowDraws(draws, start, stop, batch_size), stop - start
        batch = sample_ray_batch(buffers, draws, rows)
        loss, (loss0, loss1), grads = vanilla_loss_and_grads(
            model, state.params, batch, draws, randomized, white_bkgd, near, far
        )
        if ddp:
            grads, (loss, loss0, loss1) = share_sum(grads, (loss, loss0, loss1), rows / batch_size, mesh)
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = {
            "loss": loss,
            "psnr0": mse2psnr(loss0),
            "psnr1": mse2psnr(loss1),
            "lr": tx.schedule(state.step),
        }
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return train_step


def repeat_steps(one_step: Callable, inner_steps: int) -> Callable:
    """step(state, buffers, seed) -> (state, metrics of the last step):
    ``inner_steps`` calls of ``one_step`` in a plain loop. Each step's draws
    derive from (seed, step), so the result equals that many single steps."""

    def multi_step(state: TrainState, buffers, seed: int):
        metrics = {}
        for _ in range(inner_steps):
            state, metrics = one_step(state, buffers, seed)
        return state, metrics

    return multi_step


def make_vanilla_train_multi_step(
    model,
    tx: Optimizer,
    white_bkgd: bool,
    near: float,
    far: float,
    batch_size: int = 2048,
    inner_steps: int = 10,
    randomized: bool = True,
    mesh=None,
) -> Callable:
    """``inner_steps`` vanilla train steps in a plain loop (``repeat_steps``)."""
    return repeat_steps(
        make_vanilla_train_step(model, tx, white_bkgd, near, far, batch_size=batch_size, randomized=randomized,
                                mesh=mesh),
        inner_steps,
    )


def sample_view(buffers: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
    """One random (instance, articulation, view) of the scene buffers, drawn
    in that order, and that view's whole image data: c2w (3, 4), rgb (hw,
    3) uint8, mask (hw,), the articulation's angle and the ids (0-d)."""
    n_i, n_d, n_v = buffers["rgb"].shape[:3]
    ii = draws.randint(n_i, ())
    di = draws.randint(n_d, ())
    vi = draws.randint(n_v, ())
    return {
        "c2w": buffers["c2w"][ii, di, vi],
        "rgb": buffers["rgb"][ii, di, vi],
        "mask": buffers["mask"][ii, di, vi],
        "deg": buffers["deg"][di],
        "instance_id": ii,
        "articulation_id": di,
    }


def view_src_image(view: Dict[str, torch.Tensor], src_hw: Tuple[int, int]) -> torch.Tensor:
    """The auto-encoder's source image of a ``sample_view`` view: (3, h, w)
    in [-1, 1]."""
    h, w = src_hw
    src = view["rgb"].to(torch.float32) / 255.0 * 2.0 - 1.0
    return src.reshape(h, w, 3).permute(2, 0, 1)


def sample_view_pixels(
    view: Dict[str, torch.Tensor], directions: torch.Tensor, draws, batch_size: int
) -> Dict[str, torch.Tensor]:
    """``batch_size`` random pixels of a ``sample_view`` view: rays from its
    c2w (rays_d = viewdirs, unit), targets uint8 / 255, the mask, the angle
    and the ids."""
    pix = draws.randint(view["rgb"].shape[0], (batch_size,))
    c2w = view["c2w"]
    world_d = directions[pix] @ c2w[:, :3].T
    viewdirs = world_d / torch.linalg.norm(world_d, dim=-1, keepdim=True)
    return {
        "rays_o": c2w[:, 3].expand_as(viewdirs),
        "rays_d": viewdirs,
        "viewdirs": viewdirs,
        "target": view["rgb"][pix].to(torch.float32) / 255.0,
        "instance_mask": view["mask"][pix],
        "deg": view["deg"],
        "instance_id": view["instance_id"],
        "articulation_id": view["articulation_id"],
    }


def sample_multi_batch(
    buffers: Dict[str, torch.Tensor], draws, batch_size: int, src_hw: Optional[Tuple[int, int]] = None
) -> Dict[str, torch.Tensor]:
    """One random (instance, articulation, view) of the scene buffers
    (``SapienMultiDataset.device_buffers`` on the device) and ``batch_size``
    random pixels of it, drawn in that order (``sample_view``, then
    ``sample_view_pixels``). With ``src_hw`` = (h, w) also the whole view
    as ``src_imgs``, the auto-encoder's source image."""
    view = sample_view(buffers, draws)
    batch = sample_view_pixels(view, buffers["directions"], draws, batch_size)
    if src_hw is not None:
        batch["src_imgs"] = view_src_image(view, src_hw)
    return batch


def sample_multi_batch_multiview(
    buffers: Dict[str, torch.Tensor], draws, batch_size: int, n_views: int, src_hw: Tuple[int, int]
) -> Dict[str, torch.Tensor]:
    """``n_views`` independent draws of ``sample_multi_batch``, each of
    ``batch_size // n_views`` rays with its source view, one after the
    other: the rays grouped by view (V * per_view, ...), so (V, C) latents
    broadcast onto them; ``src_imgs`` (V, 3, h, w), ``deg``,
    ``instance_id`` and ``articulation_id`` (V,)."""
    views = [sample_multi_batch(buffers, draws, batch_size // n_views, src_hw=src_hw) for _ in range(n_views)]
    batch = {k: torch.cat([v[k] for v in views]) for k in ("rays_o", "rays_d", "target", "instance_mask")}
    batch["viewdirs"] = batch["rays_d"]
    batch.update({k: torch.stack([v[k] for v in views]) for k in ("src_imgs", "deg", "instance_id",
                                                                   "articulation_id")})
    return batch


def autodecoder_loss_and_grads(
    model, code_library, params: Dict[str, torch.Tensor], batch, draws, randomized: bool, white_bkgd: bool,
    near: float, far: float, reg_weight: float,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor], List[torch.Tensor]]:
    """loss = MSE(coarse) + MSE(fine) + the code regularization of the
    batch's codes, and its gradients with respect to ``params`` (in their
    order). The backward runs under ``full_fp32`` as the forward does."""
    latents = code_library(batch["instance_id"], batch["articulation_id"])
    latents = {k: torch.atleast_2d(v) for k, v in latents.items()}
    out = model(batch, randomized, white_bkgd, near, far, latents, draws=draws)
    loss0 = img2mse(out[0][0], batch["target"])
    loss1 = img2mse(out[1][0], batch["target"])
    reg = code_regularization(latents, weight=reg_weight)
    loss = loss1 + loss0 + reg
    with full_fp32():
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), (loss0.detach(), loss1.detach(), reg.detach()), list(grads)


def _autodecoder_metrics(loss, loss0, loss1, reg, lr) -> Dict:
    return {"loss": loss, "loss_reg": reg, "psnr0": mse2psnr(loss0), "psnr1": mse2psnr(loss1), "lr": lr}


def make_autodecoder_train_step(
    model,
    code_library,
    tx: Optimizer,
    white_bkgd: bool,
    near: float,
    far: float,
    randomized: bool = True,
    reg_weight: float = 1e-4,
    mesh=None,
) -> Callable:
    """Returns step(state, batch, seed, draws=None) -> (state, metrics): one
    auto-decoder step on a batch assembled on the host and copied to the
    device (``SapienMultiDataset.sample_train``: one view's rays, targets
    and ids). The render's draws come from ``Draws.for_step(seed,
    state.step)``; ``draws`` replaces them. With a data-parallel ``mesh``
    every rank is given the same batch and keeps its rows (``RowDraws``);
    its gradients and losses, weighed by its share of the rows, are summed
    over the ranks (``share_sum``): the one-device step."""
    ddp = data_parallel(mesh)

    def train_step(state: TrainState, batch, seed: int, draws=None):
        device = batch["rays_o"].device
        if draws is None:
            draws = Draws.for_step(seed, state.step, device)
        if ddp:
            total = batch["rays_o"].shape[0]
            start, stop = batch_rows(mesh, total)
            batch = {k: v[start:stop] if v.ndim >= 1 and v.shape[0] == total else v for k, v in batch.items()}
            draws = RowDraws(draws, start, stop, total)
        loss, parts, grads = autodecoder_loss_and_grads(
            model, code_library, state.params, batch, draws, randomized, white_bkgd, near, far, reg_weight
        )
        if ddp:
            grads, (loss, *parts) = share_sum(grads, (loss, *parts), (stop - start) / total, mesh)
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = _autodecoder_metrics(loss, *parts, tx.schedule(state.step))
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return train_step


def make_autodecoder_device_train_step(
    model,
    code_library,
    tx: Optimizer,
    white_bkgd: bool,
    near: float,
    far: float,
    batch_size: int = 4096,
    randomized: bool = True,
    reg_weight: float = 1e-4,
    inner_steps: int = 1,
    mesh=None,
    sharded_views: bool = False,
) -> Callable:
    """Returns step(state, buffers, seed, draws=None) -> (state, metrics of
    the last step), ``inner_steps`` auto-decoder steps in a plain loop.
    ``state.params`` holds the field's and the codes' parameters, updated by
    ``tx`` (one optimizer, its clip over both; or ``LatentSplit``). Each step samples a batch with
    ``sample_multi_batch`` from ``buffers`` and its draws from
    ``Draws.for_step(seed, step)`` on the buffers' device; ``draws``
    replaces them for a single step. Metrics stay on the device.

    With a data-parallel ``mesh`` each rank draws from its own stream
    (``fold=`` its data index) and the gradients and the loss parts are
    averaged over the ranks (the reference's DDP: a global batch of
    n_data x ``batch_size``). ``sharded_views`` says the buffers are this
    rank's view slice (``parallel.shard_multi_buffers``); the sampler reads
    their shapes, so nothing else changes."""
    check_sharded_views(mesh, sharded_views)
    ddp = data_parallel(mesh)
    fold = mesh.data_index if ddp else None

    def one_step(state: TrainState, buffers, seed: int, draws=None):
        if draws is None:
            draws = Draws.for_step(seed, state.step, buffers["rgb"].device, fold=fold)
        batch = sample_multi_batch(buffers, draws, batch_size)
        loss, (loss0, loss1, reg), grads = autodecoder_loss_and_grads(
            model, code_library, state.params, batch, draws, randomized, white_bkgd, near, far, reg_weight
        )
        if ddp:  # the reference's DDP gradient all-reduce
            grads, (loss, loss0, loss1, reg) = all_reduce_step(grads, (loss, loss0, loss1, reg), mesh, mean=True)
        opt_state = tx.update(list(state.params.values()), grads, state.opt_state)
        metrics = _autodecoder_metrics(loss, loss0, loss1, reg, tx.schedule(state.step))
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state), metrics

    return one_step if inner_steps <= 1 else repeat_steps(one_step, inner_steps)
