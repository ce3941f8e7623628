#!/usr/bin/env python3
"""Times the level kernels, the train step and a served view of whichever
``aonerf_torch`` comes first on the path, on one CUDA card, and prints one
JSON line.

    PYTHONPATH=. python3 tools/torch_train_compare.py --label change
    PYTHONPATH=build/parent python3 tools/torch_train_compare.py --label parent

To compare two trees, unpack the other one into a git-ignored directory and
run the two in turns in one call on one card (parent, change, change,
parent). At the train step's shapes (2048 rays, S = 65 and 193, random
inputs and weights from a seed) it times K1 (``fused_render_level``) and,
where the tree has it, K1s (``fused_level_fwd_spill``) by CUDA events, in
turns, and K1 at the serving tile's 4096 rays; K2's backward from saved
(``fused_level_bwd_saved``) by CUDA events and each of its passes
(integrator backward, B1, B2, reduce) by torch.profiler, in fp32 and, where
the tree has the bf16 mode (``dot_bf16``), in bf16 too; then a 320x240 view
rendered through ``make_image_renderer`` (chunk 4096, random NeRF from a
seed), seconds per view by the host clock over two views after one; then the
train step of ``config/vanilla.json`` (batch 2048, 64+128 samples) on an
8-view 320x240 synthetic scene, in fp32 and (where the tree has it) in bf16:
ms per step by the host clock around ``torch.cuda.synchronize()``, and the
peak device memory of a multi-step (``torch.cuda.max_memory_allocated()``);
and, in bf16, the step of ``config/vanilla_tpu_fast.json`` (batch 224) on
the same scene. With ``--fp32-step-only`` it times the fp32 step at batch
2048 alone (with the card's busy ms a step), with ``--bf16-step-only`` the
bf16 step at batch 2048 alone, and with ``--fast-step-only`` the fast
preset's step alone, for many short runs of two trees in turns.

With ``--forward-only`` it times K1 and K1s alone, in fp32 and (where the
tree has it) in bf16, at S = 65 and 193: K1 at the serving tile's 4096 rays
and K1s at the train step's 2048 by CUDA events; K1 at the fast preset's
chunk of 256 rays and K1s at its batch of 224 by their device time
(torch.profiler: there a launch's host work outlasts the kernel), at the
tile the wrapper takes by default and at 16 rays a block, in turns
(default, 16, 16, default; a tree whose wrappers take 16 by default times
16 four times), then at every tile of at most 16 rays that divides the
batch; and the host time of one K1 launch at 256 rays (the wrapper's work:
the packed weights, the tensor maps, the launch), from the host clock over
20 calls without a synchronize. ``--fwd-bf16-run N`` builds the kernels
with another run length of the bf16 forward's products (see
``torch_bf16_accuracy.py``), ``--b1-bf16-run N`` with another of B1's in
bf16 mode.

With ``--kernels-only`` it times the fp32 K1 and K1s as above (not the
view or the steps; K1 at 4096 rays in bf16 mode too), K2's backward from saved and its passes at 2048 rays
in both modes, and K2 in bf16 mode at the fast preset's batch of 224 rays
from K1s' saved: B1's device time (torch.profiler) at the tile the wrapper
takes by default and at 16 rays a block, in turns (default, 16, 16,
default), K2's passes at the default tile, and the host time of one K2 bf16
call at the default tile and at 16 (5 runs of 40 calls without a
synchronize each). ``--fast-step-only`` also
gives the card's busy time a step: the device time of every kernel over one
profiled multi-step, per step.
"""

import argparse
import inspect
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_TRAIN = 2048


def cuda_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def level_inputs(R: int, S: int, seed: int, device):
    from aonerf_torch.ops.encoding import pos_enc

    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    t, o, d, pts = (torch.from_numpy(a).to(device) for a in (t, o, d, pts))
    return t, o, d, pos_enc(d, 0, 4), pos_enc(pts, 0, 10)


def time_forward(device) -> dict:
    """K1 and K1s alone at the serving, training and fast preset's shapes
    (see --forward-only), ms per launch by CUDA events."""
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    modes = ({}, {"dot_bf16": True}) if has_bf16() else ({},)
    out = {}
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        row = {}
        for mode in modes:
            tag = "_bf16" if mode else ""
            iters = 10 if S > 100 else 20
            for name, fn, R in (("k1", fr.fused_render_level, 4096), ("k1s", ft.fused_level_fwd_spill, 2048)):
                args = (kp, *level_inputs(R, S, S, device), True)
                row[f"{name}{tag}_{R}_ms"] = cuda_ms(lambda: fn(*args, **mode), warmup=2, iters=iters)  # noqa: B023
                del args
            for name, fn, R, kernel in (("k1", fr.fused_render_level, 256, "fused_render_level_kernel"),
                                        ("k1s", ft.fused_level_fwd_spill, 224, "level_fwd_spill_kernel")):
                args = (kp, *level_inputs(R, S, S, device), True)
                default = lambda: fn(*args, **mode)  # noqa: E731,B023

                def dev(tile=None):
                    kw = {} if tile is None else {"ray_tile": tile}
                    by_name = kernel_ms(lambda: fn(*args, **kw, **mode), iters=20)  # noqa: B023
                    return sum(v for k, v in by_name.items() if kernel in k)  # noqa: B023

                times = [dev(), dev(16), dev(16), dev()]
                row[f"{name}{tag}_{R}_ms"] = [times[0], times[3]]
                row[f"{name}{tag}_{R}_t16_ms"] = [times[1], times[2]]
                row[f"{name}{tag}_{R}_by_tile_ms"] = {T: dev(T) for T in range(1, 17) if R % T == 0}
                if name == "k1":
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(20):
                        default()
                    row[f"k1{tag}_256_host_ms"] = (time.perf_counter() - t0) * 1e3 / 20
                    torch.cuda.synchronize()
                del args
        out[f"S={S}"] = row
    return out


def time_levels(device) -> dict:
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    spill = getattr(ft, "fused_level_fwd_spill", None)
    out = {}
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        args = (kp, *level_inputs(R_TRAIN, S, S, device), True)
        iters = 10 if S > 100 else 20
        k1 = lambda: fr.fused_render_level(*args)  # noqa: E731
        row = {"k1_ms": [cuda_ms(k1, warmup=2, iters=iters)]}
        if spill is not None:
            k1s = lambda: spill(*args)  # noqa: E731
            row["k1s_ms"] = [cuda_ms(k1s, warmup=2, iters=iters), cuda_ms(k1s, warmup=0, iters=iters)]
        row["k1_ms"].append(cuda_ms(k1, warmup=0, iters=iters))
        if spill is not None and has_bf16():
            k1s_bf16 = lambda: spill(*args, dot_bf16=True)  # noqa: E731
            row["k1s_bf16_ms"] = [cuda_ms(k1s_bf16, warmup=2, iters=iters), cuda_ms(k1s_bf16, warmup=0, iters=iters)]
        args4096 = (kp, *level_inputs(4096, S, S, device), True)
        row["k1_4096_ms"] = cuda_ms(lambda: fr.fused_render_level(*args4096), warmup=2, iters=iters // 2)
        if has_bf16():
            row["k1_4096_bf16_ms"] = cuda_ms(lambda: fr.fused_render_level(*args4096, dot_bf16=True), warmup=2,
                                             iters=iters // 2)
        out[f"S={S}"] = row
    return out


# K2's passes: what the kernel names of csrc/fused_train.cu start with -> pass
# (B2 is level_bwd_dw_kernel, and in bf16 mode level_bwd_dw_bf16_kernel)
K2_PASSES = {"level_bwd_integrator_kernel": "integrator", "level_bwd_delta_kernel": "B1",
             "level_bwd_dw_": "B2", "level_bwd_reduce_kernel": "reduce"}


def has_bf16() -> bool:
    from aonerf_torch.ops.kernels import fused_train as ft

    return "dot_bf16" in inspect.signature(ft.fused_level_bwd_saved).parameters


def kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of fn() by kernel name (torch.profiler), after one
    untimed call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = us / 1e3 / iters
    return out


def time_backward(device) -> dict:
    """K2 from K1s' saved at the train step's shapes: ms per call by CUDA
    events, and each pass's device ms per call."""
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    out = {}
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        args = (kp, *level_inputs(R_TRAIN, S, S, device))
        rng = np.random.default_rng(S + 1)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((R_TRAIN, 3)), rng.standard_normal(R_TRAIN), 0.1 * rng.standard_normal(R_TRAIN),
            rng.standard_normal((R_TRAIN, S))))
        row = {}
        for mode in ({}, {"dot_bf16": True}) if has_bf16() else ({},):
            tag = "_bf16" if mode else ""
            *_, saved, raw = ft.fused_level_fwd_spill(*args, True, **mode)
            k2 = lambda: ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, **mode)  # noqa: E731
            row[f"k2{tag}_ms"] = cuda_ms(k2, warmup=2, iters=5 if S > 100 else 10)
            by_name = kernel_ms(k2, iters=3)
            for kernel, name in K2_PASSES.items():
                row[f"{name}{tag}_ms"] = sum(v for k, v in by_name.items() if kernel in k)
            del saved, raw
        out[f"S={S}"] = row
    return out


def time_preset_backward(device) -> dict:
    """K2 in bf16 mode at the fast preset's batch (see --kernels-only)."""
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    R = 224
    out = {}
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        args = (kp, *level_inputs(R, S, S, device))
        rng = np.random.default_rng(S + 1)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
            rng.standard_normal((R, S))))
        *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)

        def k2(**kw):
            return ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=True, **kw)  # noqa: B023

        def b1(**kw):
            return sum(v for k, v in kernel_ms(lambda: k2(**kw), iters=20).items() if "level_bwd_delta_kernel" in k)

        times = [b1(), b1(ray_tile=16), b1(ray_tile=16), b1()]
        row = {"b1_bf16_224_ms": [times[0], times[3]], "b1_bf16_224_t16_ms": [times[1], times[2]],
               "ray_tile": getattr(ft, "bwd_tiles", {}).get((R, S, True), 16)}
        by_name = kernel_ms(k2, iters=5)
        for kernel, name in K2_PASSES.items():
            row[f"{name}_bf16_224_ms"] = sum(v for k, v in by_name.items() if kernel in k)
        for key, kw in (("k2_bf16_224_host_ms", {}), ("k2_bf16_224_t16_host_ms", {"ray_tile": 16})):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(40):
                    k2(**kw)
                runs.append((time.perf_counter() - t0) * 1e3 / 40)
                torch.cuda.synchronize()
            row[key] = runs
        del saved, raw
        out[f"S={S}"] = row
    return out


def time_view(device) -> dict:
    from aonerf_torch.data.camera import get_ray_directions_np, get_rays_np
    from aonerf_torch.data.synthetic import FOVY_DEG, random_pose_on_sphere
    from aonerf_torch.eval.render import make_image_renderer
    from aonerf_torch.models.nerf import NeRF

    H, W = 240, 320
    nerf = NeRF(generator=torch.Generator().manual_seed(0), device=device).eval()
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    c2w = random_pose_on_sphere(np.random.default_rng(1))
    rays_o, viewdirs, rays_d, _ = get_rays_np(get_ray_directions_np(H, W, focal), c2w[:3, :4])
    rays = {k: torch.from_numpy(v).to(device) for k, v in
            (("rays_o", rays_o), ("rays_d", rays_d), ("viewdirs", viewdirs))}
    render = make_image_renderer(nerf, True, 2.0, 6.0, chunk=4096)
    render(rays)  # warm-up view
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        render(rays)
    torch.cuda.synchronize()
    return {"seconds_per_view": (time.perf_counter() - t0) / 2}


def time_train_step(device, config: str = "vanilla.json", overrides: dict = None, multi_steps: int = 3,
                    busy: bool = False) -> dict:
    """ms per step of ``config`` (with ``overrides``) over ``multi_steps``
    multi-steps after an untimed one; with ``busy``, also the card's busy ms
    a step over one more multi-step, profiled."""
    from aonerf_torch.data.synthetic import generate_single_scene
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        root = generate_single_scene(os.path.join(tmp, "scene"), img_wh=(320, 240), n_train=8, n_val=1, n_test=0,
                                     seed=0)
        cfg = load_config(os.path.join(ROOT, "config", config), {
            "root_dir": root, "output_path": os.path.join(tmp, "out"), "exp_name": "compare",
            "img_wh": [320, 240], "lr_init": 1e-3, "lr_delay_steps": 0, "seed": 0, **(overrides or {}),
        })
        trainer = Trainer(cfg)
        try:
            buffers = trainer.train_buffers()
            trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)  # warm-up multi-step
            torch.cuda.synchronize()
            n_steps = multi_steps * trainer._inner_steps
            t0 = time.perf_counter()
            for _ in range(multi_steps):
                trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            busy_ms = None
            if busy:
                def multi_step():
                    trainer.state, _ = trainer.step_fn(trainer.state, buffers, cfg.seed)

                busy_ms = sum(kernel_ms(multi_step, iters=1).values()) / trainer._inner_steps
        finally:
            trainer.close()
    return {"step_ms": step_ms, "rays_per_s": cfg.batch_size / step_ms * 1e3, "steps_timed": n_steps,
            "peak_gb": peak / 1e9, "held_gb": held / 1e9, "busy_ms": busy_ms}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", required=True, help="name of the tree in the output line")
    parser.add_argument("--fp32-step-only", action="store_true",
                        help="time only the fp32 train step at batch 2048 (for many short runs in turns)")
    parser.add_argument("--bf16-step-only", action="store_true",
                        help="time only the bf16 train step at batch 2048 (for many short runs in turns)")
    parser.add_argument("--fast-step-only", action="store_true",
                        help="time only the fast preset's step at batch 224 (for many short runs in turns)")
    parser.add_argument("--forward-only", action="store_true",
                        help="time only K1 and K1s, at the serving, training and fast preset's shapes")
    parser.add_argument("--kernels-only", action="store_true",
                        help="time only K1 and K1s (fp32; K1s also bf16), K2 at 2048 rays and K2 bf16 at the fast "
                             "preset's batch")
    parser.add_argument("--fwd-bf16-run", type=int,
                        help="build the kernels with this run length of the bf16 forward's products "
                             "(AONERF_FWD_BF16_RUN, k16 steps a fresh accumulator: 1 or even)")
    parser.add_argument("--b1-bf16-run", type=int,
                        help="build the kernels with this run length of B1's products in bf16 mode "
                             "(AONERF_B1_BF16_RUN, k16 steps a fresh accumulator: 1 or even)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_compare: needs a CUDA card")
    defines = (*((f"AONERF_FWD_BF16_RUN={args.fwd_bf16_run}",) if args.fwd_bf16_run else ()),
               *((f"AONERF_B1_BF16_RUN={args.b1_bf16_run}",) if args.b1_bf16_run else ()))
    if defines:
        from aonerf_torch.ops.kernels import build

        build.DEFINES = defines
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import aonerf_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    device = torch.device("cuda")
    row = {"label": args.label, "package": os.path.relpath(os.path.dirname(aonerf_torch.__file__), ROOT),
           "card": smi[0] if smi else None}
    if args.forward_only:
        row["forward"] = time_forward(device)
        print(json.dumps(row), flush=True)
        return
    if args.kernels_only:
        row.update(levels=time_levels(device), backward=time_backward(device),
                   preset_backward=time_preset_backward(device))
        print(json.dumps(row), flush=True)
        return
    if args.fast_step_only:
        row["train_fast"] = time_train_step(device, "vanilla_tpu_fast.json", multi_steps=1, busy=True)
        print(json.dumps(row), flush=True)
        return
    if args.fp32_step_only:
        row["train"] = time_train_step(device, busy=True)
        print(json.dumps(row), flush=True)
        return
    if args.bf16_step_only:
        row["train_bf16"] = time_train_step(device, overrides={"compute_dtype": "bf16"})
        print(json.dumps(row), flush=True)
        return
    row.update(levels=time_levels(device), backward=time_backward(device), view=time_view(device),
               train=time_train_step(device))
    if has_bf16():
        row["train_bf16"] = time_train_step(device, overrides={"compute_dtype": "bf16"})
        row["train_fast"] = time_train_step(device, "vanilla_tpu_fast.json", multi_steps=1)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
