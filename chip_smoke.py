#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aonerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device  - a CUDA card is required; prints its name and power limit, and
               turns TF32 off so the plain versions run in full fp32.
  2. build   - compiles every CUDA source of the port with nvcc.
  3. kernels - the fused level kernel against its plain PyTorch version at
               the serving path's shapes (4096 rays, S = 65 and 193, both
               backgrounds), with times and the arithmetic bound.
  4. serving - a full-width NeRF from a seed renders two 320x240 test views of
               the analytic laptop scene through the image renderer; PSNR and
               SSIM against the ray-traced targets, rays/s, the kernel's launch
               count, and one view again through the plain version.
The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# Multiply-adds per sample of the fused level: 63x256 + 4x256x256 + 256x256
# + 63x256 + 2x256x256 + 256x1 + 256x256 + 256x128 + 128x3.
MACS_PER_SAMPLE = 589952
R = 4096  # rays per tile of the serving path
H, W = 240, 320
SEED = 0
# Tolerances of the kernel against its plain version: both fp32, different
# summation order and FMA placement.
TOL = {"comp": 1e-4, "acc": 1e-4, "weights": 1e-4, "depth": 1e-3}
# A whole view rendered through the kernel vs through the plain version: the
# kernel's 1e-4 on coarse weights moves fine t-values through the inverse CDF.
TOL_RENDER_RGB = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup: int, iters: int) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
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


def phase_device() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})"
    )


def phase_build() -> None:
    from aonerf_torch.ops.kernels import build

    names = build.all_sources()
    t0 = time.perf_counter()
    paths = build.build(names)
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s -> {[p.name for p in paths.values()]}")
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _view(rng, boxes, focal):
    """Rays and white-composited target of one random test view."""
    from aonerf_torch.data.camera import get_ray_directions_np, get_rays_np
    from aonerf_torch.data.synthetic import random_pose_on_sphere, render_scene

    c2w = random_pose_on_sphere(rng)
    rgb, alpha, _ = render_scene(boxes, c2w, H, W, focal)
    target = rgb * alpha[..., None] + (1.0 - alpha[..., None])
    rays_o, viewdirs, rays_d, _ = get_rays_np(get_ray_directions_np(H, W, focal), c2w[:3, :4])
    rays = {"rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs}
    return rays, target.astype(np.float32), alpha


def _bound_ms(S: int) -> tuple:
    flops = 2.0 * (R * S * MACS_PER_SAMPLE + R * 27 * 128)
    n_weights = MACS_PER_SAMPLE + 27 * 128 + 8 * 256 + 1 + 256 + 128 + 3
    bytes_moved = 4.0 * (R * S + R * 3 + R * 27 + R * S * 63 + n_weights  # inputs
                         + R * 3 + R + R + R * S)  # outputs
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(nerf, boxes, focal) -> dict:
    from aonerf_torch.ops import encoding, sampling
    from aonerf_torch.ops.kernels import fused_render as fr

    dev = torch.device("cuda")
    rays, _, _ = _view(np.random.default_rng(SEED + 100), boxes, focal)
    pick = np.random.default_rng(SEED + 101).choice(H * W, R, replace=False)
    o, d = (torch.from_numpy(rays[k][pick]).to(dev) for k in ("rays_o", "rays_d"))
    venc = encoding.pos_enc(d, 0, 4)
    t_c, pts = sampling.sample_along_rays(o, d, 64, 2.0, 6.0, False, False)
    t_c = t_c.contiguous()
    kp_c, kp_f = fr.kernel_params(nerf.coarse_mlp), fr.kernel_params(nerf.fine_mlp)
    xenc_c = encoding.pos_enc(pts, 0, 10)
    _, _, _, w_c = fr.fused_render_level(kp_c, t_c, o, d, venc, xenc_c, True)
    t_f, pts_f = sampling.sample_pdf(
        0.5 * (t_c[:, 1:] + t_c[:, :-1]), w_c[:, 1:-1], o, d, t_c, 128, False
    )
    t_f = t_f.contiguous()
    xenc_f = encoding.pos_enc(pts_f, 0, 10)

    levels = []
    for kp, t, xenc in ((kp_c, t_c, xenc_c), (kp_f, t_f, xenc_f)):
        S = t.shape[1]
        args = (kp, t, o, d, venc, xenc)
        errs = {}
        for white in (True, False):
            got = fr.fused_render_level(*args, white)
            torch.cuda.synchronize()
            want = fr.fused_render_level_ref(*args, white)
            for name, g, w in zip(("comp", "acc", "depth", "weights"), got, want):
                if not torch.isfinite(g).all():
                    fail(f"kernel S={S} white={white}: non-finite {name}")
                err = (g - w).abs().max().item()
                errs[name] = max(errs.get(name, 0.0), err)
        print(
            f"kernel fused_render_level S={S}: max abs err "
            + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items())
        )
        bad = [k for k, v in errs.items() if not v <= TOL[k]]
        if bad:
            fail(f"kernel S={S} disagrees with its plain version on {bad}")
        ms = cuda_ms(lambda: fr.fused_render_level(*args, True), warmup=3, iters=20 if S > 100 else 40)
        plain_ms = cuda_ms(lambda: fr.fused_render_level_ref(*args, True), warmup=1, iters=5)
        bound, bound_by = _bound_ms(S)
        print(
            f"  S={S}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
            f"({bound_by}; {2 * MACS_PER_SAMPLE * R * S / 1e12:.4f} TFLOP at 67 TFLOP/s fp32), "
            f"{2 * MACS_PER_SAMPLE * R * S / ms / 1e9:.2f} TFLOP/s achieved"
        )
        levels.append({
            "S": S, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": max(errs["comp"], errs["acc"], errs["weights"]),
            "depth_max_abs_err": errs["depth"],
        })
    return {"levels": levels}


def phase_serving(nerf, boxes, focal) -> dict:
    from aonerf_torch.eval.metrics import masked_psnr, psnr_image, ssim_image
    from aonerf_torch.eval.render import make_image_renderer
    from aonerf_torch.models import nerf as nerf_mod
    from aonerf_torch.ops.kernels import fused_render as fr

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    views = [_view(rng, boxes, focal) for _ in range(2)]
    views = [({k: torch.from_numpy(v).to(dev) for k, v in rays.items()}, tgt, alpha)
             for rays, tgt, alpha in views]
    render = make_image_renderer(nerf, True, 2.0, 6.0, chunk=R)
    n_tiles = -(-H * W // R)

    torch.cuda.synchronize()
    fr.launches = 0
    t0 = time.perf_counter()
    outs = [render(rays) for rays, _, _ in views]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fr.launches

    expected = 2 * n_tiles * len(views)
    print(f"serving: {len(views)} views of {W}x{H} in {seconds:.3f} s = "
          f"{len(views) * H * W / seconds:.1f} rays/s; fused_render_level launches {launches} "
          f"(expected 2 levels x {n_tiles} tiles x {len(views)} views = {expected})")
    if launches != expected:
        fail(f"fused_render_level launched {launches} times on the serving path, expected {expected}")
    for i, ((rgb, acc, depth), (_, target, alpha)) in enumerate(zip(outs, views)):
        if rgb.shape != (H * W, 3) or acc.shape != (H * W,) or depth.shape != (H * W,):
            fail(f"view {i}: output shapes {rgb.shape}, {acc.shape}, {depth.shape}")
        if not (torch.isfinite(rgb).all() and torch.isfinite(acc).all() and torch.isfinite(depth).all()):
            fail(f"view {i}: non-finite render")
        img = rgb.reshape(H, W, 3)
        tgt = torch.from_numpy(target).to(dev)
        psnr = psnr_image(img, tgt).item()
        ssim = ssim_image(img, tgt).item()
        obj = masked_psnr(img, tgt, torch.from_numpy(alpha).to(dev)).item()
        print(f"  view {i}: psnr {psnr:.4f} dB, ssim {ssim:.5f}, object psnr {obj:.4f} dB "
              "(random init: finite is what counts)")
        if not all(np.isfinite(v) for v in (psnr, ssim, obj)):
            fail(f"view {i}: non-finite metric")

    def plain(kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd,
              ray_tile=None):
        return fr.fused_render_level_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd
        )

    with mock.patch.object(nerf_mod, "fused_render_level", plain):
        rgb_plain, _, _ = render(views[0][0])
    diff = (outs[0][0] - rgb_plain).abs().max().item()
    print(f"  view 0 through the plain version: max rgb diff {diff:.3e} (tol {TOL_RENDER_RGB:g})")
    if not diff <= TOL_RENDER_RGB:
        fail("the kernel's render disagrees with the plain version's")
    return {"launches": launches, "seconds_per_view": seconds / len(views)}


def main() -> None:
    phase_device()
    phase_build()
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF

    nerf = NeRF(generator=torch.Generator().manual_seed(SEED), device="cuda").eval()
    boxes = laptop_scene(80.0)
    focal = 0.5 * H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    k = phase_kernels(nerf, boxes, focal)
    s = phase_serving(nerf, boxes, focal)

    lv = k["levels"]
    tile_ms = sum(x["ms"] for x in lv)
    n_tiles = -(-H * W // R)
    print(f"kernel share of a view: {n_tiles} tiles x {tile_ms:.3f} ms = {n_tiles * tile_ms:.1f} ms "
          f"of {s['seconds_per_view'] * 1e3:.1f} ms")
    entry = {
        "name": "fused_render_level",
        "route": "cuda",
        "source": "aonerf_torch/ops/kernels/csrc/fused_render.cu",
        "replaces": "aonerf/ops/kernels/fused_render.py:194",
        "launches": s["launches"],
        # one serving tile: a coarse (S=65) and a fine (S=193) launch
        "max_abs_err": max(x["max_abs_err"] for x in lv),
        "ms": tile_ms,
        "plain_ms": sum(x["plain_ms"] for x in lv),
        "bound_ms": sum(x["bound_ms"] for x in lv),
        "bound_by": "operations" if all(x["bound_by"] == "operations" for x in lv) else "bytes",
        "library_ms": None,
        "levels": lv,
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()
    }}))


if __name__ == "__main__":
    main()
