"""Training and test orchestration (counterpart of ``aonerf.train.loop``,
its 'vanilla', 'vanilla_autodecoder' and 'vanilla_ae_art' experiment types).

One device: the scene's buffers are uploaded once, each train step samples
its batch on the device, and ``fit`` is a host loop around the multi-step
with the JAX Trainer's logging, validation and checkpoint cadences.

  vanilla:      the NeRF through the fused level kernels, on a SAPIEN scene's
                ray buffers, in fp32 or (``compute_dtype='bf16'``) the
                kernels' bf16 mode; ``validate`` renders val views, ``test``
                every view of the test split
  auto-decoder: the articulated field and the code library, trained jointly
                on a sapien_multi scene's (instance, articulation, view)
                buffers; ``validate`` renders a rotating set of views (the
                held-out degrees when the scene has a val split, each with
                the nearest code of the interpolated sweep), ``test`` the
                spheric sweep of ``render_instance`` over the interpolated
                articulations, and ``optimize_instance_codes`` fits fresh
                codes for one instance with the field frozen
  auto-encoder: the articulated field conditioned on latents that a
                ResNet34 encodes from the sampled view (or each of
                ``ae_views_per_step`` views, or one view for
                ``ae_encode_reuse`` steps), trained jointly with the
                encoder, the joint-state decoder and the degree embedding on
                the same buffers; a dataset whose instances differ in
                articulation or view count trains on batches assembled on
                the host (``sample_train`` behind a ``Prefetcher``), one
                step a call; ``validate`` adds the joint-state error and
                conditions on the ground-truth angle, ``test`` renders the
                sweep conditioned on the predicted angle

The two articulated types share the multi-scene dataset, its held-out val/
split, the sweep and the checkpoint layout. ``compute_dtype='bf16'`` runs
their models as flax's bf16 modules compute them; parameters, gradients,
the optimizer's slots and checkpoints stay fp32, so either mode restores the
other's checkpoint.

The optimizer and its schedule come from ``train.optim.build_optimizer_from_config``
(the log-lerp Adam by default; sgd, AdamW, RAdam or Ranger with steplr,
cosine or poly and the warmup; the auto-decoder's codes by their own AdamW
with ``latent_lr``). A checkpoint holds the step, the parameters and the
optimizer's count and per-parameter slots by parameter name.

The reference's launcher variants: ``is_optimize`` and ``finetune_lpips``
checkpoint every ``steps_per_epoch`` steps, and ``is_optimize`` keeps every
checkpoint. ``noise_std`` reaches every model (randomized renders only).
``debug_nans`` raises ``FloatingPointError`` at the first step whose level
outputs, gradients or loss hold a NaN (it syncs the host a step; off, it
costs nothing). ``profile_steps`` writes a ``torch.profiler`` trace of that
many steps under ``run_dir/profile`` (``utils.profile.device_op_table``
reads it).

With ``run_eval`` the Trainer loads the test split instead of train and val.

Data parallelism: under torchrun (``parallel.distributed.initialize`` reads
its environment; without it nothing changes) every rank builds the same
Trainer, rank 0's parameters are broadcast at the start and after a
restore, and the train steps all-reduce the gradients (``train.step``,
``train.step_ae``). ``shard_scene_buffers`` (the default) gives each rank
only its cyclic view slice of the articulated scene buffers. Every rank
validates the same views (the one-rank numbers); ``test`` renders each
rank's ``local_shard_bounds`` of the views and gathers them
(``gather_images``). Logs, checkpoints, val grids, renders and
results.json are written by rank 0 alone; the profiler runs there too.
"""

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from aonerf_torch.data.prefetch import Prefetcher
from aonerf_torch.data.sapien import SapienDataset
from aonerf_torch.data.sapien_multi import SapienMultiDataset
from aonerf_torch.eval import io, lpips
from aonerf_torch.eval.metrics import lpips_image, masked_psnr, psnr_image, ssim_image, summarize_metric
from aonerf_torch.eval.render import make_image_renderer
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.models.codes import CodeLibraryArticulated
from aonerf_torch.models.mlp import COMPUTE_DTYPES
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc_dim
from aonerf_torch.ops.kernels import fused_render, fused_train
from aonerf_torch.ops.random import Draws
from aonerf_torch.parallel import distributed
from aonerf_torch.parallel.mesh import make_mesh, shard_multi_buffers
from aonerf_torch.train.optim import OptState, build_optimizer_from_config
from aonerf_torch.train.step import (
    TrainState,
    create_train_state,
    make_autodecoder_device_train_step,
    make_vanilla_train_multi_step,
)
from aonerf_torch.train.step_ae import make_ae_device_train_step, make_ae_train_step
from aonerf_torch.utils.ckpt import CheckpointManager
from aonerf_torch.utils.config import Config, jax_only_settings
from aonerf_torch.utils.logging import MetricLogger

# the dataset each experiment type trains on
DATASETS = {"vanilla": "sapien", "vanilla_autodecoder": "sapien_multi", "vanilla_ae_art": "sapien_multi"}
# seconds of idle card at each edge of a profile_steps trace (Trainer._start_profiler)
_PROFILE_MARGIN_S = 0.1


def _check_supported(cfg: Config) -> None:
    """Raise on a configuration the port does not run yet, naming the
    ROADMAP item that would port it."""
    todo = []
    if cfg.exp_type not in DATASETS:
        todo.append(f"exp_type={cfg.exp_type!r}")
    elif cfg.dataset_name != DATASETS[cfg.exp_type]:
        todo.append(f"dataset_name={cfg.dataset_name!r} for {cfg.exp_type}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        todo.append(f"compute_dtype={cfg.compute_dtype!r}")
    if cfg.exp_type == "vanilla":  # the fused kernels' layout bounds the encoded sample width
        todo.extend(_beyond_the_kernels_layout(cfg))
    todo.extend(f"{name}={value!r} (ROADMAP Queue 1 item 12, tensor parallelism)"
                for name, value in jax_only_settings(cfg).items())
    if todo:
        raise NotImplementedError("not ported yet: " + ", ".join(todo))


def _beyond_the_kernels_layout(cfg: Config) -> list:
    """The vanilla degrees whose encoded sample width the fused kernels'
    layout does not hold: where K1's block of one ray of the fine level's
    samples needs more shared memory than the H100 gives a block (encoded
    widths up to 288 at 64 + 128 samples, ``max_deg_point -
    min_deg_point`` <= 47); every ``deg_view`` fits."""
    pos = pos_enc_dim(3, cfg.min_deg_point, cfg.max_deg_point)
    S = cfg.num_coarse_samples + 1 + cfg.num_fine_samples
    need = fused_render.forward_smem_bytes(S, 1, pos)
    if need <= fused_render.H100_SMEM_PER_BLOCK:
        return []
    return [f"min_deg_point={cfg.min_deg_point}, max_deg_point={cfg.max_deg_point} (encoded width {pos}: the "
            f"fused kernels' block of one ray of {S} samples needs {need} bytes of shared memory, the H100 gives "
            f"{fused_render.H100_SMEM_PER_BLOCK}; ROADMAP Queue 2 item 11)"]


class _NanCheckedOptimizer:
    """``debug_nans``: an optimizer whose update raises FloatingPointError,
    naming the parameter, when a gradient holds a NaN; everything else is
    the wrapped optimizer's."""

    def __init__(self, tx, names):
        self._tx, self._names = tx, list(names)

    def __getattr__(self, name):
        return getattr(self._tx, name)

    def update(self, params, grads, state, **kwargs):
        for name, g in zip(self._names, grads):
            if g is not None and bool(torch.isnan(g).any()):
                raise FloatingPointError(f"debug_nans: the gradient of {name} holds a NaN (update {state.count})")
        return self._tx.update(params, grads, state, **kwargs)


def _raise_on_nan_levels(module, inputs, levels) -> None:
    """``debug_nans``: a forward hook of a two-level field that raises
    FloatingPointError when an output of a level holds a NaN."""
    for i, outputs in enumerate(levels):
        for name, x in zip(("comp_rgb", "acc", "depth"), outputs):
            if bool(torch.isnan(x).any()):
                level = ("coarse", "fine")[i] if i < 2 else str(i)
                raise FloatingPointError(f"debug_nans: the {level} level's {name} holds a NaN")


class _NoLogger:
    """The metric log of a rank other than 0: nothing is written."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, cfg: Config):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = distributed.initialize(cfg.platform)
        # the ranks' grid when data parallel; None on one device
        self.mesh = make_mesh() if distributed.world_size() > 1 else None
        self._is_main = distributed.is_main_process()
        self.run_dir = os.path.join(cfg.output_path, cfg.exp_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = MetricLogger(self.run_dir) if self._is_main else _NoLogger()
        # the launcher variants' cadence: every "epoch"; is_optimize keeps all
        if cfg.is_optimize or cfg.finetune_lpips:
            cfg.ckpt_every_steps = cfg.steps_per_epoch
        keep = None if cfg.is_optimize else cfg.ckpt_keep
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "ckpts"), keep=keep)
        # the auto-decoder and the auto-encoder: the multi-scene dataset and the sweep
        self.articulated = cfg.exp_type in ("vanilla_autodecoder", "vanilla_ae_art")
        self.autoencoder = cfg.exp_type == "vanilla_ae_art"
        # each rank holds only its view slice of the articulated scene buffers
        self.sharded_scene_buffers = self.articulated and self.mesh is not None and cfg.shard_scene_buffers
        generator = torch.Generator().manual_seed(cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)  # the host-batched auto-encoder's batches
        self._prefetcher = None
        self._inner_steps = max(1, cfg.inner_steps)
        split = "test" if cfg.run_eval else "train"

        if self.articulated:
            self.dataset = SapienMultiDataset(
                cfg.root_dir, split=split, img_wh=cfg.img_wh, white_back=cfg.white_back,
                eval_inference=cfg.render_name if cfg.run_eval else None, ray_batch_size=cfg.batch_size,
            )
            # held-out degrees when every instance has a val/ split, else the
            # train views (the reference's own practice)
            if not cfg.run_eval and SapienMultiDataset.has_val_split(cfg.root_dir):
                self.val_dataset = SapienMultiDataset(
                    cfg.root_dir, split="val", img_wh=cfg.img_wh, white_back=cfg.white_back
                )
            else:
                self.val_dataset = self.dataset
            self.near, self.far = self.dataset.near, self.dataset.far
            field_kwargs = dict(
                num_coarse_samples=cfg.num_coarse_samples, num_fine_samples=cfg.num_fine_samples,
                min_deg_point=cfg.min_deg_point, max_deg_point=cfg.max_deg_point, deg_view=cfg.deg_view,
                noise_std=cfg.noise_std, lindisp=cfg.lindisp, latent_dense=cfg.latent_dense, generator=generator,
                device=self.device, compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype],
            )
            if self.autoencoder:
                self.model = AutoEncoderArticulatedNeRF(
                    sigma_activation=cfg.ae_sigma_activation, embed_deg=cfg.ae_embed_deg, **field_kwargs
                )
                self.code_library = None
                trained = self.model
                self.tx, self.lr_fn = self._optimizer(build_optimizer_from_config(cfg), trained)
                self.step_fn = make_ae_device_train_step(
                    self.model, self.tx, cfg.white_back, self.near, self.far, img_wh=cfg.img_wh,
                    batch_size=cfg.batch_size, randomized=cfg.randomized, opacity_lambda=cfg.opacity_lambda,
                    inner_steps=self._inner_steps, opacity_loss=cfg.ae_opacity_loss, photometric=cfg.ae_photometric,
                    views_per_step=cfg.ae_views_per_step, encode_reuse=cfg.ae_encode_reuse, mesh=self.mesh,
                    sharded_views=self.sharded_scene_buffers,
                )
            else:
                self.model = ArticulatedNeRF(**field_kwargs)
                self.code_library = CodeLibraryArticulated(
                    n_max_objs=cfg.n_max_objs, obj_code_dim=cfg.obj_code_dim,
                    n_max_articulations=cfg.n_max_articulations, art_code_dim=cfg.art_code_dim,
                    generator=generator, device=self.device,
                )
                # one optimizer over the field and the codes, as in JAX's {'model', 'codes'}
                # (the codes after the field's parameters: latent_lr splits them off)
                trained = nn.ModuleDict({"model": self.model, "codes": self.code_library})
                self.tx, self.lr_fn = self._optimizer(
                    build_optimizer_from_config(cfg, n_model=len(list(self.model.parameters()))), trained
                )
                self.step_fn = make_autodecoder_device_train_step(
                    self.model, self.code_library, self.tx, cfg.white_back, self.near, self.far,
                    batch_size=cfg.batch_size, randomized=cfg.randomized, reg_weight=cfg.code_reg_weight,
                    inner_steps=self._inner_steps, mesh=self.mesh, sharded_views=self.sharded_scene_buffers,
                )
        else:
            self.dataset = SapienDataset(cfg.root_dir, split=split, img_wh=cfg.img_wh, white_back=cfg.white_back)
            if not cfg.run_eval:
                self.val_dataset = SapienDataset(
                    cfg.root_dir, split="val", img_wh=cfg.img_wh, white_back=cfg.white_back
                )
            self.near, self.far = self.dataset.near, self.dataset.far
            self.model = NeRF(
                num_coarse_samples=cfg.num_coarse_samples, num_fine_samples=cfg.num_fine_samples,
                lindisp=cfg.lindisp, generator=generator, device=self.device,
                compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype], noise_std=cfg.noise_std,
                min_deg_point=cfg.min_deg_point, max_deg_point=cfg.max_deg_point, deg_view=cfg.deg_view,
            )
            trained = self.model
            self.tx, self.lr_fn = self._optimizer(build_optimizer_from_config(cfg), trained)
            self.step_fn = make_vanilla_train_multi_step(
                self.model, self.tx, cfg.white_back, self.near, self.far, batch_size=cfg.batch_size,
                inner_steps=self._inner_steps, randomized=cfg.randomized, mesh=self.mesh,
            )
        self.state = create_train_state(trained, self.tx)
        if cfg.debug_nans:  # the levels' outputs (the gradients: _optimizer)
            (self.model.field if self.autoencoder else self.model).register_forward_hook(_raise_on_nan_levels)
        # the auto-encoder renders through its field with the encoded latents
        render = self.model.render if self.autoencoder else self.model
        self._renderer = make_image_renderer(render, cfg.white_back, self.near, self.far, chunk=cfg.chunk)

        if cfg.ckpt_path:
            self._load(CheckpointManager(cfg.ckpt_path).restore(map_location=self.device))
        elif cfg.weight_path:  # params only; the optimizer starts fresh
            self._load(CheckpointManager(cfg.weight_path).restore(map_location=self.device), params_only=True)
        elif self.ckpt.latest_step() is not None:
            self._load(self.ckpt.restore(map_location=self.device))
        # every rank starts from rank 0's parameters
        distributed.broadcast_(list(self.state.params.values()))
        if self.mesh is not None and self.device.type == "cuda" and not self.articulated:
            # rank 0 builds the level kernels at these widths, the others then load them
            if self._is_main:
                widths = (pos_enc_dim(3, cfg.min_deg_point, cfg.max_deg_point), pos_enc_dim(3, 0, cfg.deg_view))
                fused_render._library(*widths)
                fused_train._library(*widths)
            distributed.barrier()

    def _optimizer(self, built, trained: nn.Module):
        """(tx, lr_fn) as built, the optimizer checked for NaN gradients
        under ``debug_nans``."""
        tx, lr_fn = built
        if self.cfg.debug_nans:
            tx = _NanCheckedOptimizer(tx, (n for n, _ in trained.named_parameters()))
        return tx, lr_fn

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> Dict:
        """step, params by name and opt_state: the count and each slot
        (mu, nu, trace, slow) by parameter name."""
        s = self.state
        names = list(s.params)
        slots = {k: {n: t.cpu() for n, t in zip(names, v) if t is not None} for k, v in s.opt_state.slots.items()}
        return {
            "step": s.step,
            "params": {n: p.detach().cpu() for n, p in s.params.items()},
            "opt_state": {"count": s.opt_state.count, **slots},
        }

    def _load(self, saved: Dict, params_only: bool = False) -> None:
        with torch.no_grad():
            for n, p in self.state.params.items():
                p.copy_(saved["params"][n])
        if params_only:
            return
        names = list(self.state.params)
        opt = saved["opt_state"]
        slots = {}
        for k, fresh in self.state.opt_state.slots.items():
            if k not in opt:
                raise KeyError(f"the checkpoint's optimizer state has no slot {k!r}: another optimizer saved it")
            slots[k] = [None if t is None else opt[k][n].to(self.device) for n, t in zip(names, fresh)]
        self.state = TrainState(
            step=int(saved["step"]), params=self.state.params, opt_state=OptState(count=int(opt["count"]), slots=slots)
        )

    # ----------------------------------------------------------------- train

    def train_buffers(self) -> Dict[str, torch.Tensor]:
        """The scene's train buffers on the device: the ray buffers (viewdirs
        aliases rays_d), or for the articulated types ``device_buffers``
        (a ValueError when the instances differ in articulation or view
        count), with ``sharded_scene_buffers`` this rank's view slice of
        them, cut on the host."""
        if self.articulated:
            host = self.dataset.device_buffers()
            if self.sharded_scene_buffers:
                host = shard_multi_buffers(self.mesh, host)
            return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        host = self.dataset.train_buffers()
        buffers = {k: torch.from_numpy(host[k]).to(self.device) for k in ("rays_o", "rays_d", "target")}
        buffers["viewdirs"] = buffers["rays_d"]
        return buffers

    def fit(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        total = max_steps or (cfg.num_epochs * cfg.steps_per_epoch)
        start = self.state.step
        stride = self._inner_steps
        try:
            buffers = self.train_buffers()
        except ValueError:
            if not self.autoencoder:
                raise
            # the auto-encoder on a ragged dataset: batches assembled on the
            # host ahead of the step, one step a call
            buffers, stride = None, 1
            host_step = make_ae_train_step(
                self.model, self.tx, cfg.white_back, self.near, self.far, randomized=cfg.randomized,
                opacity_lambda=cfg.opacity_lambda, opacity_loss=cfg.ae_opacity_loss, photometric=cfg.ae_photometric,
                mesh=self.mesh,
            )
            self._prefetcher = Prefetcher(lambda: self.dataset.sample_train(self.rng))

        profiler = self._start_profiler() if cfg.profile_steps > 0 and self._is_main else None
        last: Dict[str, float] = {}
        step = start
        while step < total:
            if buffers is not None:
                self.state, metrics = self.step_fn(self.state, buffers, cfg.seed)
            else:
                batch = self._device_batch(self._prefetcher.get())
                self.state, metrics = host_step(self.state, batch, cfg.seed)
            prev, step = step, step + stride
            if cfg.debug_nans and bool(torch.isnan(metrics["loss"]).any()):
                raise FloatingPointError(f"debug_nans: the loss of step {step - 1} is NaN")

            def crossed(every):  # cadences fire when a stride crosses their boundary
                return (step // every) > (prev // every)

            if crossed(100) or prev == start:
                last = {k: float(v) for k, v in metrics.items()}
                self.logger.log(step, last, prefix="train")
            if crossed(cfg.val_every_steps):
                val = self.validate()
                self.logger.log(step, val, prefix="val")
                last.update({f"val_{k}": v for k, v in val.items()})
            if (crossed(cfg.ckpt_every_steps) or step >= total) and self._is_main:
                self.ckpt.save(step, self._state_dict(), last.get("val_psnr"))
            if profiler is not None and step - start >= cfg.profile_steps:
                self._stop_profiler(profiler, start)
                profiler = None
        if profiler is not None:
            self._stop_profiler(profiler, start)
        self._close_prefetcher()
        distributed.barrier()  # rank 0's checkpoints are on disk before any rank goes on
        return last

    def _start_profiler(self):
        """A started torch.profiler over the host's operations and, on the
        card, its kernels (the JAX Trainer's jax.profiler.start_trace)."""
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # A warm-up cycle before the recorded one: started cold, the trace
        # lost the first step's first kernels (one of its K1s launches) on
        # the H100 after many earlier profiler runs in the process. Late in
        # a long process it still lost the kernels of the recorded cycle's
        # first few ms (the trace keeps only kernels whose device times fall
        # inside the cycle), so the steps start _PROFILE_MARGIN_S into it.
        profiler = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        profiler.start()
        profiler.step()
        self._profile_margin()
        return profiler

    def _profile_margin(self) -> None:
        """The card idle for _PROFILE_MARGIN_S at an edge of the recorded
        cycle."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            time.sleep(_PROFILE_MARGIN_S)

    def _stop_profiler(self, profiler, start: int) -> str:
        """Stop ``profiler`` once the device is done and write its Chrome
        trace, ``run_dir/profile/trace_<start step>.json``; returns the path."""
        self._profile_margin()
        profiler.stop()
        trace_dir = os.path.join(self.run_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace_{start:08d}.json")
        profiler.export_chrome_trace(path)
        return path

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch copied to the device (in the main thread)."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _close_prefetcher(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    # ------------------------------------------------------------------ eval

    def _save_val_grid(self, target, rgb, depth, acc) -> None:
        """GT|pred|depth|opacity grid of the current val step."""
        from PIL import Image

        from aonerf_torch.eval.viz import visualize_val_rgb_opa_depth

        grid = visualize_val_rgb_opa_depth(self.cfg.img_wh, target, rgb, depth, acc)
        vis_dir = os.path.join(self.run_dir, "val_vis")
        os.makedirs(vis_dir, exist_ok=True)
        Image.fromarray(grid).save(os.path.join(vis_dir, f"step{self.state.step:07d}.png"))

    def _img_rays(self, img: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(img[k]).to(self.device) for k in ("rays_o", "rays_d", "viewdirs")}

    @torch.no_grad()
    def _latents_for(self, instance_id, articulation_id, is_test: bool = False) -> Dict[str, torch.Tensor]:
        """The (1, C) codes of an instance and an articulation (with
        ``is_test``, an index of the interpolated sweep)."""
        latents = self.code_library(int(instance_id), int(articulation_id), is_test=is_test)
        return {k: torch.atleast_2d(v) for k, v in latents.items()}

    def _interp_articulation_id(self, deg_rad: float) -> int:
        """The index of the nearest angle of the 2N-1 interpolated sweep: the
        train degrees at even indices, their midpoints at odd ones."""
        train_degs = self.dataset.degrees_rad()
        grid = np.empty(2 * len(train_degs) - 1, np.float64)
        grid[0::2] = train_degs
        grid[1::2] = 0.5 * (train_degs[:-1] + train_degs[1:])
        return int(np.argmin(np.abs(grid - deg_rad)))

    @torch.no_grad()
    def _render_setup(self, img: Dict, is_test: bool = False):
        """(latents, pred_state) an articulated view renders with. The
        auto-encoder encodes the view's ``src_imgs`` and predicts the joint
        state (radians, a float; None for the auto-decoder); it conditions
        on the ground-truth angle, or at test (and without one) on the
        predicted angle."""
        if not self.autoencoder:
            return self._latents_for(img["instance_id"], img["articulation_id"], is_test=is_test), None
        latents = self.model.encode(torch.from_numpy(img["src_imgs"]).to(self.device)[None])
        pred_state = self.model.predict_state(latents["articulation"]).reshape(())
        if self.model.embed_deg:
            deg = pred_state if (is_test or "deg" not in img) else torch.tensor(img["deg"], device=self.device)
            latents["articulation_deg"] = self.model.deg_code(deg)
        return {k: torch.atleast_2d(v) for k, v in latents.items()}, float(pred_state)

    def val_schedule(self, n: int):
        """The (instance, articulation, view) ids ``validate`` renders at the
        current step: ``n`` consecutive entries of the flattened grid, from
        (step // val_every_steps) * n, instances varying fastest, so a step
        always scores the same views and successive calls rotate."""
        ds = self.val_dataset
        base = (self.state.step // max(1, self.cfg.val_every_steps)) * n
        out = []
        for k in range(n):
            g = base + k
            ii = g % ds.n_instances
            g //= ds.n_instances
            di = g % ds.n_articulations(ii)
            g //= ds.n_articulations(ii)
            out.append((ii, di, g % ds.n_images(ii, di)))
        return out

    def validate(self, n_images: Optional[int] = None) -> Dict[str, float]:
        if not self.articulated:
            n = min(n_images or self.cfg.limit_val_batches, self.val_dataset.num_images)
            psnrs = []
            for i in range(n):
                s = self.val_dataset.get_image(i)
                rgb, acc, depth = self._renderer(self._view_rays(s))
                psnrs.append(float(psnr_image(rgb, torch.from_numpy(s.target).to(self.device))))
                if i == 0 and self._is_main:
                    self._save_val_grid(s.target, *(x.cpu().numpy() for x in (rgb, depth, acc)))
            return {"psnr": float(np.mean(psnrs))}

        ds = self.val_dataset
        psnrs, obj_psnrs, state_sq_errs, state_deg_errs = [], [], [], []
        for k, (ii, di, vi) in enumerate(self.val_schedule(n_images or self.cfg.limit_val_batches)):
            img = ds.get_image(ii, di, vi)
            if ds.uses_val_split and not self.autoencoder:
                # no learned code exists for a held-out degree: condition on
                # the nearest code of the interpolated sweep
                img = dict(img, articulation_id=np.int32(self._interp_articulation_id(float(img["deg"]))))
                latents, pred_state = self._render_setup(img, is_test=True)
            else:
                latents, pred_state = self._render_setup(img)
            if pred_state is not None:
                # the joint-state error: squared in radians, and in whole
                # degrees (Python's round on np.rad2deg, as JAX's Trainer)
                gt = float(img["deg"])
                state_sq_errs.append((pred_state - gt) ** 2)
                state_deg_errs.append(abs(round(np.rad2deg(pred_state)) - round(np.rad2deg(gt))))
            rgb, acc, depth = self._renderer(self._img_rays(img), latents)
            if k == 0 and self._is_main:
                self._save_val_grid(img["target"], *(x.cpu().numpy() for x in (rgb, depth, acc)))
            target = torch.from_numpy(img["target"]).to(self.device)
            psnrs.append(float(psnr_image(rgb, target)))
            obj_psnrs.append(float(masked_psnr(rgb, target, torch.from_numpy(img["instance_mask"]).to(self.device))))
        out = {"psnr": float(np.mean(psnrs)), "psnr_obj": float(np.mean(obj_psnrs))}
        if state_sq_errs:
            out["state_error_rad"] = float(np.mean(state_sq_errs))
            out["abs_state_error_deg"] = float(np.mean(state_deg_errs))
        return out

    def _view_rays(self, sample) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(getattr(sample, k)).to(self.device) for k in ("rays_o", "rays_d", "viewdirs")}

    def _test_view(self, i: int, render: bool = True):
        """(rgb, acc, depth) rendered for test view ``i`` (None without
        ``render``), its target (N, 3) and its instance mask (N,) as host
        arrays."""
        if self.articulated:  # the spheric sweep of cfg.render_instance
            img = self.dataset.get_test_image(self.cfg.render_instance, i)
            out = self._renderer(self._img_rays(img), self._render_setup(img, is_test=True)[0]) if render else None
            return out, img["target"], img["instance_mask"]
        s = self.dataset.get_image(i)
        return (self._renderer(self._view_rays(s)) if render else None), s.target, s.instance_mask

    def render_test_views(self):
        """Every test view rendered, as host arrays: (rgb (n, h, w, 3), depth
        (n, h, w), acc (n, h, w), target (n, h, w, 3), mask (n, h, w)). Each
        rank renders its ``local_shard_bounds`` of the views and the rows are
        gathered (``gather_images``), so every rank holds them all."""
        w, h = self.cfg.img_wh
        n_images = self.cfg.test_sweep_poses if self.articulated else self.dataset.num_images
        start, stop = distributed.local_shard_bounds(n_images)
        rgbs, depths, accs, targets, masks = [], [], [], [], []
        for i in range(n_images):
            out, target, mask = self._test_view(i, render=start <= i < stop)
            targets.append(target.reshape(h, w, 3))
            masks.append(mask.reshape(h, w))
            if out is not None:
                rgb, acc, depth = out
                rgbs.append(rgb.reshape(h, w, 3).cpu().numpy())
                depths.append(depth.reshape(h, w).cpu().numpy())
                accs.append(acc.reshape(h, w).cpu().numpy())

        def gather(rows, shape):
            local = np.stack(rows) if rows else np.zeros((0, *shape), np.float32)
            return distributed.gather_images(local, n_images)

        return (gather(rgbs, (h, w, 3)), gather(depths, (h, w)), gather(accs, (h, w)), np.stack(targets),
                np.stack(masks))

    def test(self) -> Dict[str, Dict[str, float]]:
        """Render every test view (vanilla: the test split; auto-decoder:
        ``test_sweep_poses`` spheric poses of ``render_instance``, pose i
        conditioned on the interpolated articulation i; auto-encoder: the
        same poses, each conditioned on the latents and the predicted angle
        encoded from the 0-degree train view of its index), score it (PSNR,
        SSIM, object PSNR through ``summarize_metric``) and write the jpg
        sequence, colour and raw depth, opacity maps and the video (GIF
        without an mp4 backend) under ``run_dir/render_name``, and
        ``run_dir/results.json``.

        LPIPS is scored when ``AONERF_LPIPS_WEIGHTS`` names an existing
        exported weights file (``eval.lpips``, loaded once onto the device),
        else it is NaN, as in JAX. Data parallel, each rank renders its share
        of the views (``render_test_views``), every rank scores them all and
        rank 0 writes the files.
        """
        cfg = self.cfg
        lpips_path = os.environ.get("AONERF_LPIPS_WEIGHTS", "")
        lpips_weights = lpips.load_weights(lpips_path, self.device) if os.path.isfile(lpips_path) else None
        rgbs, depths, accs, targets, masks = self.render_test_views()
        psnrs, ssims, obj_psnrs, lpipses = [], [], [], []
        for rgb, target, mask in zip(rgbs, targets, masks):
            img, target = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in (rgb, target))
            psnrs.append(float(psnr_image(img, target)))
            ssims.append(float(ssim_image(img, target)))
            obj_psnrs.append(float(masked_psnr(img, target, torch.from_numpy(mask).to(self.device))))
            if lpips_weights is not None:
                lpipses.append(lpips_image(img, target, lpips_weights))
        stats = {
            "psnr": summarize_metric(psnrs),
            "ssim": summarize_metric(ssims),
            "lpips": summarize_metric(lpipses) if lpips_weights is not None else {"test": float("nan")},
            "psnr_obj": summarize_metric(obj_psnrs),
        }
        if not self._is_main:
            return stats
        rgbs, depths, accs = list(rgbs), list(depths), list(accs)
        image_dir = os.path.join(self.run_dir, cfg.render_name)
        io.store_image(image_dir, rgbs, "image")
        io.store_depth_color(image_dir, depths)
        io.store_depth_raw(image_dir, depths)
        io.store_opacity(image_dir, accs)
        try:
            io.store_video(image_dir, rgbs)
        except RuntimeError:  # no mp4 backend: the GIF, as the JAX Trainer writes
            io.store_gif(image_dir, rgbs)
        io.write_stats(os.path.join(self.run_dir, "results.json"), **stats)
        return stats

    # ------------------------------------------- test-time code optimization

    def optimize_instance_codes(
        self,
        instance_idx: Optional[int] = None,
        n_steps: Optional[int] = None,
        lr: Optional[float] = None,
        batch_size: Optional[int] = None,
    ):
        """Fit fresh (shape, appearance) codes for one instance of the train
        split as if it were unseen, with the trained field and articulation
        table frozen (``train.optimize.optimize_codes``). Returns (codes,
        history) and writes them to ``run_dir/optimized_codes.npz``."""
        if self.cfg.exp_type != "vanilla_autodecoder":
            raise ValueError("code optimization requires the auto-decoder mode")
        from aonerf_torch.train.optimize import CODE_STEP, optimize_codes

        cfg = self.cfg
        instance_idx = cfg.optimize_instance if instance_idx is None else instance_idx
        buffers = self.train_buffers()
        for k in ("rgb", "mask", "c2w"):  # the target instance only
            buffers[k] = buffers[k][instance_idx : instance_idx + 1]
        codes, history = optimize_codes(
            self.model,
            self.code_library.embedding_instance_articulation.weight,
            buffers,
            Draws.for_step(cfg.seed, CODE_STEP, self.device),
            n_steps=n_steps or cfg.optimize_steps,
            lr=lr or cfg.optimize_lr,
            batch_size=batch_size or cfg.batch_size,
            obj_code_dim=cfg.obj_code_dim,
            white_bkgd=cfg.white_back,
            near=self.near,
            far=self.far,
        )
        if self._is_main:
            np.savez(
                os.path.join(self.run_dir, "optimized_codes.npz"),
                density=codes["density"].cpu().numpy(),
                color=codes["color"].cpu().numpy(),
                history_psnr1=np.asarray(history["psnr1"]),
            )
        return codes, history

    def close(self) -> None:
        self._close_prefetcher()
        self.logger.close()
