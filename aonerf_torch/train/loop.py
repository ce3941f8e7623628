"""Training and test orchestration for the vanilla NeRF (counterpart of the
vanilla branches of ``aonerf.train.loop.Trainer``).

One device: the scene's ray buffers are uploaded once, each train step
gathers its batch on the device, and ``fit`` is a host loop around the
multi-step with the JAX Trainer's logging, validation and checkpoint
cadences. ``validate`` renders val views through the tiled image renderer;
with ``run_eval`` the Trainer loads the test split instead, and ``test``
renders and scores every test view and writes the outputs. The articulated
experiment types are not ported yet.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

from aonerf_torch import default_device
from aonerf_torch.data.sapien import SapienDataset
from aonerf_torch.eval import io
from aonerf_torch.eval.metrics import masked_psnr, psnr_image, ssim_image, summarize_metric
from aonerf_torch.eval.render import make_image_renderer
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.train.step import AdamState, TrainState, create_train_state, make_adam, make_vanilla_train_multi_step
from aonerf_torch.utils.ckpt import CheckpointManager
from aonerf_torch.utils.config import Config, jax_only_settings
from aonerf_torch.utils.logging import MetricLogger


def _check_supported(cfg: Config) -> None:
    """Raise on a configuration the port does not run yet."""
    todo = []
    if cfg.exp_type != "vanilla":
        todo.append(f"exp_type={cfg.exp_type!r}")
    if cfg.dataset_name != "sapien":
        todo.append(f"dataset_name={cfg.dataset_name!r}")
    if cfg.noise_std:
        todo.append("noise_std")
    if cfg.compute_dtype != "f32":
        todo.append(f"compute_dtype={cfg.compute_dtype!r}")
    if cfg.optimizer != "adam" or cfg.lr_scheduler is not None:
        todo.append("optimizers other than the log-lerp Adam")
    shape = (cfg.min_deg_point, cfg.max_deg_point, cfg.deg_view, cfg.netdepth, cfg.netwidth)
    if shape != (NeRFMLP.min_deg_point, NeRFMLP.max_deg_point, NeRFMLP.deg_view, NeRFMLP.netdepth, NeRFMLP.netwidth):
        todo.append("MLP shapes other than 8x256 with 10/4 encoding degrees")
    todo.extend(f"{name}={value!r}" for name, value in jax_only_settings(cfg).items())
    if todo:
        raise NotImplementedError("not ported yet: " + ", ".join(todo))


class Trainer:
    def __init__(self, cfg: Config):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = default_device(cfg.platform)
        self.run_dir = os.path.join(cfg.output_path, cfg.exp_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = MetricLogger(self.run_dir)
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "ckpts"), keep=cfg.ckpt_keep)

        split = "test" if cfg.run_eval else "train"
        self.dataset = SapienDataset(cfg.root_dir, split=split, img_wh=cfg.img_wh, white_back=cfg.white_back)
        if not cfg.run_eval:
            self.val_dataset = SapienDataset(cfg.root_dir, split="val", img_wh=cfg.img_wh, white_back=cfg.white_back)
        self.near, self.far = self.dataset.near, self.dataset.far

        self.model = NeRF(
            num_coarse_samples=cfg.num_coarse_samples,
            num_fine_samples=cfg.num_fine_samples,
            lindisp=cfg.lindisp,
            generator=torch.Generator().manual_seed(cfg.seed),
            device=self.device,
        )
        self.tx = make_adam(
            lr_init=cfg.lr_init, lr_final=cfg.lr_final, max_steps=cfg.run_max_steps,
            lr_delay_steps=cfg.lr_delay_steps, lr_delay_mult=cfg.lr_delay_mult,
            grad_clip=cfg.grad_clip or None,
        )
        self._inner_steps = max(1, cfg.inner_steps)
        self.step_fn = make_vanilla_train_multi_step(
            self.model, self.tx, cfg.white_back, self.near, self.far, batch_size=cfg.batch_size,
            inner_steps=self._inner_steps, randomized=cfg.randomized,
        )
        self.state = create_train_state(self.model, self.tx)
        self._renderer = make_image_renderer(self.model, cfg.white_back, self.near, self.far, chunk=cfg.chunk)

        if cfg.ckpt_path:
            self._load(CheckpointManager(cfg.ckpt_path).restore(map_location=self.device))
        elif cfg.weight_path:  # params only; the optimizer starts fresh
            self._load(CheckpointManager(cfg.weight_path).restore(map_location=self.device), params_only=True)
        elif self.ckpt.latest_step() is not None:
            self._load(self.ckpt.restore(map_location=self.device))

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> Dict:
        s = self.state
        names = list(s.params)
        return {
            "step": s.step,
            "params": {n: p.detach().cpu() for n, p in s.params.items()},
            "opt_state": {
                "count": s.opt_state.count,
                "mu": {n: m.cpu() for n, m in zip(names, s.opt_state.mu)},
                "nu": {n: v.cpu() for n, v in zip(names, s.opt_state.nu)},
            },
        }

    def _load(self, saved: Dict, params_only: bool = False) -> None:
        with torch.no_grad():
            for n, p in self.state.params.items():
                p.copy_(saved["params"][n])
        if params_only:
            return
        names = list(self.state.params)
        opt = saved["opt_state"]
        self.state = TrainState(
            step=int(saved["step"]),
            params=self.state.params,
            opt_state=AdamState(
                count=int(opt["count"]),
                mu=[opt["mu"][n].to(self.device) for n in names],
                nu=[opt["nu"][n].to(self.device) for n in names],
            ),
        )

    # ----------------------------------------------------------------- train

    def train_buffers(self) -> Dict[str, torch.Tensor]:
        """The scene's ray buffers on the device (viewdirs aliases rays_d)."""
        host = self.dataset.train_buffers()
        buffers = {k: torch.from_numpy(host[k]).to(self.device) for k in ("rays_o", "rays_d", "target")}
        buffers["viewdirs"] = buffers["rays_d"]
        return buffers

    def fit(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        total = max_steps or (cfg.num_epochs * cfg.steps_per_epoch)
        start = self.state.step
        buffers = self.train_buffers()
        stride = self._inner_steps

        last: Dict[str, float] = {}
        step = start
        while step < total:
            self.state, metrics = self.step_fn(self.state, buffers, cfg.seed)
            prev, step = step, step + stride

            def crossed(every):  # cadences fire when a stride crosses their boundary
                return (step // every) > (prev // every)

            if crossed(100) or prev == start:
                last = {k: float(v) for k, v in metrics.items()}
                self.logger.log(step, last, prefix="train")
            if crossed(cfg.val_every_steps):
                val = self.validate()
                self.logger.log(step, val, prefix="val")
                last.update({f"val_{k}": v for k, v in val.items()})
            if crossed(cfg.ckpt_every_steps) or step >= total:
                self.ckpt.save(step, self._state_dict(), last.get("val_psnr"))
        return last

    # ------------------------------------------------------------------ eval

    def _save_val_grid(self, target, rgb, depth, acc) -> None:
        """GT|pred|depth|opacity grid of the current val step."""
        from PIL import Image

        from aonerf_torch.eval.viz import visualize_val_rgb_opa_depth

        grid = visualize_val_rgb_opa_depth(self.cfg.img_wh, target, rgb, depth, acc)
        vis_dir = os.path.join(self.run_dir, "val_vis")
        os.makedirs(vis_dir, exist_ok=True)
        Image.fromarray(grid).save(os.path.join(vis_dir, f"step{self.state.step:07d}.png"))

    def validate(self, n_images: Optional[int] = None) -> Dict[str, float]:
        n = min(n_images or self.cfg.limit_val_batches, self.val_dataset.num_images)
        psnrs = []
        for i in range(n):
            s = self.val_dataset.get_image(i)
            rgb, acc, depth = self._renderer(self._view_rays(s))
            psnrs.append(float(psnr_image(rgb, torch.from_numpy(s.target).to(self.device))))
            if i == 0:
                self._save_val_grid(s.target, *(x.cpu().numpy() for x in (rgb, depth, acc)))
        return {"psnr": float(np.mean(psnrs))}

    def _view_rays(self, sample) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(getattr(sample, k)).to(self.device) for k in ("rays_o", "rays_d", "viewdirs")}

    def test(self) -> Dict[str, Dict[str, float]]:
        """Render every test view, score it (PSNR, SSIM, object PSNR through
        ``summarize_metric``) and write the jpg sequence, colour and raw
        depth, opacity maps and the video (GIF without an mp4 backend) under
        ``run_dir/render_name``, and ``run_dir/results.json``.

        One process renders every view; sharding the views across processes
        (the JAX Trainer's ``local_shard_bounds`` / ``gather_images``) is not
        ported yet. LPIPS is not ported: it is NaN, and a run that names
        existing LPIPS weights in ``AONERF_LPIPS_WEIGHTS`` is refused rather
        than scored without them.
        """
        lpips_weights = os.environ.get("AONERF_LPIPS_WEIGHTS", "")
        if lpips_weights and os.path.exists(lpips_weights):
            raise NotImplementedError(
                f"LPIPS (AONERF_LPIPS_WEIGHTS={lpips_weights}) is not ported yet: ROADMAP Queue 1 item 7"
            )
        cfg = self.cfg
        w, h = cfg.img_wh
        rgbs, depths, accs, psnrs, ssims, obj_psnrs = [], [], [], [], [], []
        for i in range(self.dataset.num_images):
            s = self.dataset.get_image(i)
            rgb, acc, depth = self._renderer(self._view_rays(s))
            img = rgb.reshape(h, w, 3)
            target = torch.from_numpy(s.target).to(self.device).reshape(h, w, 3)
            psnrs.append(float(psnr_image(img, target)))
            ssims.append(float(ssim_image(img, target)))
            mask = torch.from_numpy(s.instance_mask).to(self.device).reshape(h, w)
            obj_psnrs.append(float(masked_psnr(img, target, mask)))
            rgbs.append(img.cpu().numpy())
            depths.append(depth.reshape(h, w).cpu().numpy())
            accs.append(acc.reshape(h, w).cpu().numpy())
        stats = {
            "psnr": summarize_metric(psnrs),
            "ssim": summarize_metric(ssims),
            "lpips": {"test": float("nan")},
            "psnr_obj": summarize_metric(obj_psnrs),
        }

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

    def close(self) -> None:
        self.logger.close()
