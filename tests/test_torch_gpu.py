"""CUDA kernels of aonerf_torch against their plain PyTorch versions, and the
articulated models' bf16 mode against the CPU's forms, on the card. Every
test here needs a CUDA card and skips without one.

This file imports neither JAX nor aonerf, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as rule
from aonerf_torch.eval.render import make_image_renderer
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _level_inputs(R, S, seed, device, min_deg_point=0, max_deg_point=10, deg_view=4):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    t, o, d, pts = (torch.from_numpy(a).to(device) for a in (t, o, d, pts))
    return t, o, d, pos_enc(d, 0, deg_view), pos_enc(pts, min_deg_point, max_deg_point)


# Both sides are fp32 and differ only in summation order (and FMA placement).
_TOLS = {"comp": 1e-4, "acc": 1e-4, "depth": 1e-3, "weights": 1e-4}


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_kernel_matches_plain_version(cuda, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    before = fr.launches
    got = fr.fused_render_level(kp, *args, white_bkgd)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    want = fr.fused_render_level_ref(kp, *args, white_bkgd)
    for name, g, w in zip(("comp", "acc", "depth", "weights"), got, want):
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= _TOLS[name], f"{name}: max abs err {err}"


# K1 against the plain version in fp64: each output's max abs error / max
# |fp64| at most max(1e-6, 4 x the fp32 plain version's own error on it).
# 3xTF32 keeps fp32's accuracy; one TF32 product misses this ~300x
# (tests/test_torch_tf32_fwd.py emulates both; chip_smoke.py phase 3 checks
# the same at the serving path's shapes).
_FWD_TOL, _FWD_FACTOR = 1e-6, 4.0


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_kernel_is_fp32_accurate(cuda, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5  # live densities, so the integrator's outputs depend on the MLP
    args = _level_inputs(256, S, S, cuda)
    got = fr.fused_render_level(kp, *args, white_bkgd)
    p32 = fr.fused_render_level_ref(kp, *args, white_bkgd)
    p64 = fr.fused_render_level_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args), white_bkgd)
    for name, g, w32, w64 in zip(("comp", "acc", "depth", "weights"), got, p32, p64):
        tol = max(_FWD_TOL, _FWD_FACTOR * _rel_err(w32, w64))
        rel = _rel_err(g, w64)
        assert rel <= tol, f"{name}: max abs err / max |fp64 plain| = {rel} > {tol}"


def test_kernel_rejects_what_it_does_not_take(cuda):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(0), device=cuda)
    kp = fr.kernel_params(mlp)
    t, o, d, venc, xenc = _level_inputs(64, 65, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render_level(kp, t.double(), o, d, venc, xenc, True)
    with pytest.raises(ValueError, match="shape"):
        fr.fused_render_level(kp, t, o, d, venc[:, :20], xenc, True)
    before = fr.launches
    with pytest.raises(RuntimeError, match="launch failed"):  # 64 x 65 needs 266 KB
        fr.fused_render_level(kp, t, o, d, venc, xenc, True, ray_tile=64)
    assert fr.launches == before
    fr.fused_render_level(kp, t, o, d, venc, xenc, True)  # no stale error left behind
    torch.cuda.synchronize()


def test_renderer_goes_through_the_kernel(cuda):
    nerf = NeRF(num_coarse_samples=64, num_fine_samples=128, generator=torch.Generator().manual_seed(1), device=cuda)
    rng = np.random.default_rng(1)
    d = rng.standard_normal((100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": torch.from_numpy(-4.0 * d).to(cuda), "rays_d": torch.from_numpy(d).to(cuda)}
    rays["viewdirs"] = rays["rays_d"]
    before = fr.launches
    rgb, acc, depth = make_image_renderer(nerf, True, 2.0, 6.0, chunk=64)(rays)
    torch.cuda.synchronize()
    assert fr.launches == before + 2 * 2  # 2 tiles x 2 levels
    assert rgb.shape == (100, 3) and acc.shape == (100,) and depth.shape == (100,)
    assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()


# K1s' saved activations and raw sigma/rgb against the plain version's: both
# fp32, other summation orders (chip_smoke.py's TOL).
_SPILL_TOL = 1e-4


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_fwd_spill_kernel_is_k1_and_matches_plain_version(cuda, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    before = ft.fwd_launches
    got = ft.fused_level_fwd_spill(kp, *args, white_bkgd)
    torch.cuda.synchronize()
    assert ft.fwd_launches == before + 1
    for name, g, w in zip(("comp", "acc", "depth", "weights"), got, fr.fused_render_level(kp, *args, white_bkgd)):
        assert torch.equal(g, w), name  # K1's bits
    want = ft.fused_level_fwd_spill_ref(kp, *args, white_bkgd)
    for name, g, w in zip(("saved", "raw"), got[4:], want[4:]):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= _SPILL_TOL, f"{name}: max abs err {err}"
    again = ft.fused_level_fwd_spill(kp, *args, white_bkgd)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# The weight stream's edges. A block of 16 rays walks ceil(16 S / 64) chunks
# of the forward's 152 16-deep weight slices through a 5-stage ring, so every
# chunk after the first starts mid-ring; S = 7, 65, 129, 193 leave a last
# chunk of 48, 16, 16, 16 rows, and R = 16 is a single block.
@pytest.mark.parametrize("R,S", [(16, 7), (16, 65), (16, 129), (16, 193), (256, 7), (256, 129)])
def test_forward_kernels_at_the_ring_edges(cuda, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(R, S, S, cuda)
    k1 = fr.fused_render_level(kp, *args, True)
    k1s = ft.fused_level_fwd_spill(kp, *args, True)
    torch.cuda.synchronize()
    want = ft.fused_level_fwd_spill_ref(kp, *args, True)
    for name, a, b, w in zip(("comp", "acc", "depth", "weights"), k1, k1s, want):
        assert torch.equal(a, b), name  # K1s gives K1's bits
        err = (a - w).abs().max().item()
        assert err <= _TOLS[name], f"{name}: max abs err {err}"
    for name, g, w in zip(("saved", "raw"), k1s[4:], want[4:]):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        assert err <= _SPILL_TOL, f"{name}: max abs err {err}"
    again_k1, again_k1s = fr.fused_render_level(kp, *args, True), ft.fused_level_fwd_spill(kp, *args, True)
    assert all(torch.equal(a, b) for a, b in zip(again_k1, k1))
    assert all(torch.equal(a, b) for a, b in zip(again_k1s, k1s))


# K1s' saved activations against the plain version in fp64, layer by layer:
# each layer's rms error at most 1.5 x the fp32 plain version's on it
# (chip_smoke.py's SAVED_RMS_FACTOR states why).
_SAVED_RMS_FACTOR = 1.5


@pytest.mark.parametrize("S", [65, 193])
def test_fwd_spill_kernel_saves_fp32_accurate_layers(cuda, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    saved = ft.fused_level_fwd_spill(kp, *args, True)[4]
    s32 = ft.fused_level_fwd_spill_ref(kp, *args, True)[4]
    s64 = ft.fused_level_fwd_spill_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args), True)[4]
    for i in range(10):
        cols = slice(256 * i, 256 * i + (128 if i == 9 else 256))
        e_k, e_p = ((x[:, cols].double() - s64[:, cols]).pow(2).mean().sqrt().item() for x in (saved, s32))
        assert e_k <= _SAVED_RMS_FACTOR * e_p, f"saved layer {i}: rms err {e_k} > {_SAVED_RMS_FACTOR} x {e_p}"


def _cotangents(R, S, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S)),
    )
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


# K2 and its fp32 plain version are both held against the plain version in
# fp64: each gradient's max abs error / max |fp64| must be at most
# max(1e-4, 4 x the fp32 plain version's error on that gradient). ReLU masks of
# pre-activations within rounding of 0 flip between summation orders and move
# trunk gradients by up to ~1e-3 (chip_smoke.py states the measurement).
_GRAD_TOL, _GRAD_FACTOR = 1e-4, 4.0


def _rel_err(got, want64):
    return ((got.double() - want64).abs().max() / want64.abs().max().clamp_min(1e-300)).item()


def _check_bwd_kernel(device, R, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(R, S, S, device)
    cot = _cotangents(R, S, S + 1, device)
    before = ft.launches
    got = ft.fused_level_bwd(kp, *args, *cot, white_bkgd)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    p32 = ft.fused_level_bwd_ref(kp, *args, *cot, white_bkgd)
    p64 = ft.fused_level_bwd_ref(
        {n: v.double() for n, v in kp.items()}, *(a.double() for a in args), *(c.double() for c in cot), white_bkgd
    )
    for name in fr.WEIGHT_NAMES:
        g = got[name]
        assert g.shape == p64[name].shape and torch.isfinite(g).all(), name
        tol = max(_GRAD_TOL, _GRAD_FACTOR * _rel_err(p32[name], p64[name]))
        rel = _rel_err(g, p64[name])
        assert rel <= tol, f"{name}: max abs err / max |fp64 plain| = {rel} > {tol}"
    again = ft.fused_level_bwd(kp, *args, *cot, white_bkgd)  # deterministic: no atomics
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, white_bkgd)
    before = ft.launches
    split = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, white_bkgd)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    for name in fr.WEIGHT_NAMES:
        assert torch.equal(again[name], got[name]), name
        assert torch.equal(split[name], got[name]), name  # the backward from K1s' saved


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bwd_kernel_matches_plain_version(cuda, S, white_bkgd):
    _check_bwd_kernel(cuda, 256, S, white_bkgd)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bwd_kernel_at_a_ragged_size(cuda, white_bkgd):
    # 48 x 65 = 3120 rows: not a multiple of B1's 64-row chunk, of B2's
    # 64-row step or of its row range (16 ranges of 256 rows: 12 full, one of
    # 48 rows, three empty)
    _check_bwd_kernel(cuda, 48, 65, white_bkgd)


@pytest.mark.parametrize("R", [16, 256])
def test_bwd_kernel_at_a_partial_chunk(cuda, R):
    # S = 7: a block's 112 rows end in a chunk of 48, and B1's stream of 136
    # weight slices a chunk wraps mid-ring (5 stages)
    _check_bwd_kernel(cuda, R, 7, True)


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(0), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    t, o, d, venc, xenc = _level_inputs(64, 65, 0, cuda)
    gc, ga, gd, gw = _cotangents(64, 65, 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        ft.fused_level_bwd(kp, t, o, d, venc, xenc, gc.double(), ga, gd, gw, True)
    with pytest.raises(ValueError, match="shape"):
        ft.fused_level_bwd(kp, t, o, d, venc, xenc, gc, ga, gd, gw[:, :10], True)
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_level_bwd(kp, t, o, d, venc, xenc, gc, ga, gd, gw.t().contiguous().t(), True)
    before = ft.fwd_launches, ft.launches
    with pytest.raises(RuntimeError, match="launch failed"):  # B1's block of 64 rays needs 250 KB
        ft.fused_level_bwd(kp, t, o, d, venc, xenc, gc, ga, gd, gw, True, ray_tile=64)
    with pytest.raises(RuntimeError, match="launch failed"):
        ft.fused_level_fwd_spill(kp, t, o, d, venc, xenc, True, ray_tile=64)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, t, o, d, venc, xenc, True)
    with pytest.raises(ValueError, match="shape"):
        ft.fused_level_bwd_saved(kp, t, o, d, venc, xenc, saved[:-1], raw, gc, ga, gd, gw, True)
    # the composition's K1s ran before its backward was refused; then one K1s
    assert (ft.fwd_launches, ft.launches) == (before[0] + 2, before[1])
    ft.fused_level_bwd(kp, t, o, d, venc, xenc, gc, ga, gd, gw, True)  # no stale error left behind
    torch.cuda.synchronize()


def test_train_cli_goes_through_the_kernels(cuda, tmp_path):
    import json

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_single_scene

    root = generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=0)
    cfg = {
        "root_dir": root, "output_path": str(tmp_path / "out"), "exp_name": "gpu", "img_wh": [16, 12],
        "num_coarse_samples": 64, "num_fine_samples": 128, "batch_size": 64, "chunk": 64,
        "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": 10, "ckpt_every_steps": 10,
        "limit_val_batches": 1, "inner_steps": 10,
    }
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    k1, k1s, k2 = fr.launches, ft.fwd_launches, ft.launches
    metrics = cli.main(["--config", str(path), "--max_steps", "10"])
    torch.cuda.synchronize()
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    val_tiles = -(-16 * 12 // 64)
    assert fr.launches - k1 == 2 * val_tiles  # K1 serves validation only: both levels of every val tile
    assert ft.fwd_launches - k1s == 2 * 10  # K1s: both levels' forward of every step
    assert ft.launches - k2 == 2 * 10  # K2: both levels' backward of every step


def test_test_path_goes_through_the_kernel(cuda, tmp_path, monkeypatch):
    import json
    import os
    from unittest import mock

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_single_scene
    from aonerf_torch.models import nerf as nerf_mod
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=2)
    cfg = {
        "root_dir": root, "output_path": str(tmp_path / "out"), "exp_name": "gpu", "img_wh": [16, 12],
        "num_coarse_samples": 64, "num_fine_samples": 128, "batch_size": 64, "chunk": 64,
    }
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    # a checkpoint of the seed's random weights: the field is not empty, so the
    # kernel and its plain version are compared on more than white background
    first = Trainer(load_config(str(path)))
    first.ckpt.save(first.state.step, first._state_dict())
    first.close()
    k1, k1s, k2 = fr.launches, ft.fwd_launches, ft.launches
    stats = cli.main(["--config", str(path), "--run_eval"])
    torch.cuda.synchronize()
    tiles = -(-16 * 12 // 64)
    assert fr.launches - k1 == 2 * tiles * 2  # both levels of every tile of the 2 test views
    assert (ft.fwd_launches, ft.launches) == (k1s, k2)
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj")) and np.isnan(stats["lpips"]["test"])
    render_dir = tmp_path / "out" / "gpu" / "render"
    files = set(os.listdir(render_dir))
    assert {"image001.jpg", "depth001.png", "depth001.npy", "depth_raw001.png", "depth_raw.npz", "opacity001.png"} <= files
    assert len(files & {"video.gif", "video.mp4"}) == 1

    trainer = Trainer(load_config(str(path), {"run_eval": True}))  # the same checkpoint again
    try:
        rays = trainer._view_rays(trainer.dataset.get_image(0))
        rgb, acc, depth = trainer._renderer(rays)
        assert acc.mean().item() > 0.1
        np.testing.assert_array_equal(depth.reshape(12, 16).cpu().numpy(), np.load(render_dir / "depth000.npy"))

        def plain(kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile=None,
                  dot_bf16=False):
            return fr.fused_render_level_ref(kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc,
                                             white_bkgd, dot_bf16=dot_bf16)

        with mock.patch.object(nerf_mod, "fused_render_level", plain):
            rgb_plain, _, _ = trainer._renderer(rays)
        assert (rgb - rgb_plain).abs().max().item() <= 1e-3  # chip_smoke.py's TOL_RENDER_RGB
    finally:
        trainer.close()


# The articulated field (plain PyTorch, no fused kernel) on the card against
# the same weights on the CPU in fp64: each output's max abs error at most
# max(1e-5, 4 x the CPU fp32 render's own error). One TF32 product per layer
# misses it ~15x on rgb (chip_smoke.py's TOL_AD).
@pytest.mark.parametrize("latent_dense", [True, False])
def test_articulated_field_is_fp32_accurate_on_the_card(cuda, latent_dense):
    import copy

    from aonerf_torch.models.articulated import ArticulatedNeRF

    g = torch.Generator().manual_seed(0)
    model = ArticulatedNeRF(latent_dense=latent_dense, generator=g, device=cuda)
    latents = {k: 0.1 * torch.randn((1, c), generator=g) for k, c in (("density", 128), ("color", 128),
                                                                       ("articulation", 32))}
    rng = np.random.default_rng(0)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": torch.from_numpy(-4.0 * d), "rays_d": torch.from_numpy(d), "viewdirs": torch.from_numpy(d)}
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        card = model({k: v.to(cuda) for k, v in rays.items()}, False, True, 2.0, 6.0,
                     {k: v.to(cuda) for k, v in latents.items()})[-1]
        cpu32 = cpu(rays, False, True, 2.0, 6.0, latents)[-1]
        want = cpu.double()({k: v.double() for k, v in rays.items()}, False, True, 2.0, 6.0,
                            {k: v.double() for k, v in latents.items()})[-1]
    for name, c, p, w in zip(("rgb", "acc", "depth"), card, cpu32, want):
        assert torch.isfinite(c).all(), name
        e_card, e_cpu = ((x.cpu().double() - w).abs().max().item() for x in (c, p))
        assert e_card <= max(1e-5, 4.0 * e_cpu), (name, e_card, e_cpu)


def test_autodecoder_fits_tests_and_optimizes_on_the_card(cuda, tmp_path, monkeypatch):
    import json
    import os

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_multi_scene

    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = generate_multi_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_instances=2, degrees=(0, 10, 20),
                                n_images=2, val_degrees=(5, 15), n_val_images=1)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                           "autodecoder.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": str(tmp_path / "out"), "exp_name": "gpu", "img_wh": [16, 12],
                "batch_size": 256, "chunk": 64, "lr_init": 1e-3, "lr_delay_steps": 0, "val_every_steps": 10,
                "ckpt_every_steps": 10, "limit_val_batches": 2, "inner_steps": 5})
    path = tmp_path / "ad.json"
    path.write_text(json.dumps(cfg))
    fused = fr.launches, ft.fwd_launches, ft.launches
    metrics = cli.main(["--config", str(path), "--max_steps", "10"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "loss_reg", "psnr1", "val_psnr", "val_psnr_obj"))
    stats = cli.main(["--config", str(path), "--run_eval"])
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    assert len(os.listdir(tmp_path / "out" / "gpu" / "render")) == 19 * 5 + 2  # the sweep, depth_raw.npz, video
    out = cli.main(["--config", str(path), "--run_optimize", "--optimize_steps", "1"])
    assert len(out["psnr1"]) == 1 and np.isfinite(out["psnr1"]).all()
    torch.cuda.synchronize()
    assert (fr.launches, ft.fwd_launches, ft.launches) == fused  # no fused kernel on the articulated path


# The auto-encoder's encoder on the card with the process-wide TF32 flags
# ON (cuDNN's is on by PyTorch's default): its convolutions and heads must
# stay fp32. At 320x240
# against the CPU in fp64, each head's max abs error / max |fp64| at most
# max(1e-5, 4 x the CPU fp32 encoder's own error); TF32 convolutions keep
# ~3 decimal digits and miss it.
def test_encoder_is_fp32_with_the_global_tf32_flags_on(cuda):
    import copy

    from aonerf_torch.models.resnet import MultiHeadImgEncoder

    enc = MultiHeadImgEncoder(generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 240, 320)).astype(np.float32))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    card = copy.deepcopy(enc).to(cuda)
    with torch.no_grad():
        got = card(x.to(cuda))
        cpu32 = enc(x)
        want = copy.deepcopy(enc).double()(x.double())
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32  # restored
    for k, w in want.items():
        scale = w.abs().max().item()
        e_card = (got[k].cpu().double() - w).abs().max().item() / scale
        e_cpu = (cpu32[k].double() - w).abs().max().item() / scale
        assert e_card <= max(1e-5, 4.0 * e_cpu), (k, e_card, e_cpu)


class _Replay:
    """Draws (``ops.random.Draws``'s methods) that hand out given host
    arrays in order, on ``device``."""

    def __init__(self, arrays, device):
        self.arrays, self.device = list(arrays), device

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(self.device)

    def randint(self, high, shape):
        return self._next(shape)

    def uniform(self, shape):
        return self._next(shape)

    def exponential(self, shape):
        return self._next(shape)


# One auto-encoder train step on the card against the CPU step, from the
# same weights, batch and draws, with cuDNN's process-wide TF32 flag ON
# (PyTorch's default; the matmul flag at its default, off): each loss part
# within max(1e-4 relative, 4 x the CPU fp32 part's error) of the CPU in
# fp64, each gradient's ||card - CPU|| / ||CPU|| at most 0.2
# (tests/test_torch_ae_grads.py's FRO_TOL), every parameter after the Adam
# update within 2 lr of the CPU's.
def test_ae_step_on_the_card_matches_the_cpu_step(cuda, tmp_path):
    from aonerf_torch.data.sapien_multi import SapienMultiDataset
    from aonerf_torch.data.synthetic import generate_multi_scene
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
    from aonerf_torch.train import step as tstep
    from aonerf_torch.train import step_ae

    wh, b, lr = (64, 48), 64, 1e-3
    root = generate_multi_scene(str(tmp_path / "scene"), img_wh=wh, n_instances=2, degrees=(0, 10, 20), n_images=2)
    bufs = SapienMultiDataset(root, split="train", img_wh=wh).device_buffers()
    rng = np.random.default_rng(0)
    draws = [np.array(rng.integers(0, n)) for n in bufs["c2w"].shape[:3]] + [
        rng.integers(0, wh[0] * wh[1], b), rng.uniform(size=(b, 65)), rng.exponential(size=(b, 129))]
    torch.backends.cudnn.allow_tf32 = True
    results = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
                             ("card", cuda, torch.float32)):
        model = AutoEncoderArticulatedNeRF(latent_dense=True, generator=torch.Generator().manual_seed(0),
                                           device=dev).to(dtype)
        tx = tstep.make_adam(lr_init=lr, lr_delay_steps=0)
        state = tstep.create_train_state(model, tx)
        host = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
        host.update({k: host[k].to(dtype) for k in ("c2w", "directions", "deg")})
        batch = tstep.sample_multi_batch(host, _Replay(draws[:4], dev), b, src_hw=wh[::-1])
        replay = _Replay([a.astype(np.float64 if dtype == torch.float64 else np.float32) for a in draws[4:]], dev)
        loss, parts, grads = step_ae.ae_loss_and_grads(model, state.params, batch, replay, True, True, 2.0, 6.0, 0.5)
        assert not replay.arrays
        tx.update(list(state.params.values()), grads, state.opt_state)
        results[name] = ([x.item() for x in (loss, *parts)], [g.cpu().double() for g in grads],
                         [p.detach().cpu() for p in state.params.values()])
    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32  # restored
    (cpu_parts, cpu_grads, cpu_params), (exact, _, _), (card_parts, card_grads, card_params) = (
        results["cpu"], results["cpu64"], results["card"])
    for got, cpu32, want in zip(card_parts, cpu_parts, exact):
        assert np.isfinite(got) and abs(got - want) <= max(1e-4 * abs(want), 4 * abs(cpu32 - want)), (got, cpu32, want)
    for g, w in zip(card_grads, cpu_grads):
        assert torch.isfinite(g).all() and torch.linalg.norm(g - w) <= 0.2 * torch.linalg.norm(w) + 1e-30
    for p, w in zip(card_params, cpu_params):
        assert (p - w).abs().max().item() <= 2 * lr


def test_ae_fits_and_tests_on_the_card(cuda, tmp_path, monkeypatch):
    import json
    import os

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_multi_scene

    monkeypatch.delenv("AONERF_LPIPS_WEIGHTS", raising=False)
    root = generate_multi_scene(str(tmp_path / "scene"), img_wh=(64, 48), n_instances=2, degrees=(0, 10, 20),
                                n_images=2, val_degrees=(5, 15), n_val_images=1)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                           "ae_art.json")) as f:
        cfg = json.load(f)
    cfg.update({"root_dir": root, "output_path": str(tmp_path / "out"), "exp_name": "gpu", "img_wh": [64, 48],
                "batch_size": 256, "chunk": 1024, "lr_delay_steps": 0, "val_every_steps": 10,
                "ckpt_every_steps": 10, "limit_val_batches": 2, "inner_steps": 5, "test_sweep_poses": 3})
    path = tmp_path / "ae.json"
    path.write_text(json.dumps(cfg))
    fused = fr.launches, ft.fwd_launches, ft.launches
    metrics = cli.main(["--config", str(path), "--max_steps", "10"])
    keys = ("loss", "loss_state", "opacity_loss", "psnr1", "val_psnr", "val_psnr_obj", "val_state_error_rad",
            "val_abs_state_error_deg")
    assert all(np.isfinite(metrics[k]) for k in keys), metrics
    stats = cli.main(["--config", str(path), "--run_eval"])
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    assert len(os.listdir(tmp_path / "out" / "gpu" / "render")) == 3 * 5 + 2  # the sweep, depth_raw.npz, video
    torch.cuda.synchronize()
    assert (fr.launches, ft.fwd_launches, ft.launches) == fused  # no fused kernel on the AE path


# bf16 mode (the TPU kernels' dot_bf16), held to chip_smoke.py's bf16 rule
# (TOL_BF16_*, BF16_ORDERS): each output of K1, each saved layer of K1s and
# each of K2's gradients against the plain version in bf16 mode summed in
# fp64; the fp32 kernel must miss it on at least one output, which shows that
# it tells the modes apart.
def _bf16_ratios(got, orders, p64, floor):
    return rule.bf16_ratios(got, p64, rule.bf16_limits(orders, p64, floor))


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bf16_forward_kernels_meet_the_bf16_rule(cuda, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5  # live densities
    args = _level_inputs(256, S, S, cuda)
    args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in args))
    before = fr.launches, fr.bf16_launches, ft.bf16_fwd_launches
    k1 = fr.fused_render_level(kp, *args, white_bkgd, dot_bf16=True)
    k1s = ft.fused_level_fwd_spill(kp, *args, white_bkgd, dot_bf16=True)
    torch.cuda.synchronize()
    assert (fr.launches, fr.bf16_launches, ft.bf16_fwd_launches) == (before[0], before[1] + 1, before[2] + 1)
    names = rule.OUTPUTS
    for name, a, b in zip(names, k1, k1s):
        assert torch.equal(a, b), name  # K1s gives K1's bits in bf16 mode too
    orders = {k: dict(zip(names, fr.fused_render_level_ref(kp, *args, white_bkgd, mm=mm, dot_bf16=True)))
              for k, mm in rule.BF16_ORDERS.items()}
    *p64, p64_saved, _ = ft.fused_level_fwd_spill_ref(*args64, white_bkgd, dot_bf16=True)
    p64 = dict(zip(names, p64))
    ratios = _bf16_ratios(dict(zip(names, k1)), orders, p64, rule.TOL_BF16_FWD)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    fp32 = dict(zip(names, fr.fused_render_level(kp, *args, white_bkgd)))
    fp32 = _bf16_ratios(fp32, orders, p64, rule.TOL_BF16_FWD)
    assert any(r > 1.0 for r in fp32.values()), fp32
    saved = rule.saved_layers(k1s[4])
    assert all(torch.equal(fr.round_bf16(v), v) for v in saved.values())  # the rounded activations
    orders = {k: rule.saved_layers(ft.fused_level_fwd_spill_ref(kp, *args, white_bkgd, mm=mm, dot_bf16=True)[4])
              for k, mm in rule.BF16_ORDERS.items()}
    ratios = _bf16_ratios(saved, orders, rule.saved_layers(p64_saved), rule.TOL_BF16_FWD)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    again = ft.fused_level_fwd_spill(kp, *args, white_bkgd, dot_bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(again, k1s))


def test_bf16_forward_rounds_ties_to_even(cuda):
    # encoded inputs exactly halfway between two bf16 values: rounding them
    # away from zero would move h0 on ~5% of its elements (chip_smoke.py's
    # TIE_SHARE; tests/test_torch_bf16_kernels.py emulates both modes)
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(2), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    t, o, d, venc, xenc = _level_inputs(256, 65, 2, cuda)
    ties = (fr.round_bf16(xenc).view(torch.int32) + 0x8000).view(torch.float32)
    h0 = ft.fused_level_fwd_spill(kp, t, o, d, venc, ties, True, dot_bf16=True)[4][:, :256]
    h0_plain = ft.fused_level_fwd_spill_ref(kp, t, o, d, venc, ties, True, dot_bf16=True)[4][:, :256]
    assert (h0 != h0_plain).double().mean().item() <= rule.TIE_SHARE


# The forward walk's ray tile: the wrappers choose it per launch
# (fr.choose_ray_tile from the card's SMs and shared memory and the
# library's count of a block's; on the H100 2 at the fast preset's 224 and
# 256 rays, 16 at 2048, 15 at 3840, 8 at 224 and 256 rays of 7 samples), and
# a row's outputs do not depend on it.
_H100_TILES = {**{(R, S): 2 for R in (224, 256) for S in (65, 193)}, (2048, 65): 16, (2048, 193): 16,
               (3840, 65): 15, (224, 7): 8, (256, 7): 8}
@pytest.mark.parametrize("R,S", [(224, 65), (224, 193), (256, 65), (256, 193), (2048, 65), (2048, 193),
                                 (224, 7), (256, 7)])
def test_bf16_k1_and_k1s_give_the_same_bits(cuda, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(R + S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5  # live densities
    args = _level_inputs(R, S, S, cuda)
    k1 = fr.fused_render_level(kp, *args, True, dot_bf16=True)
    k1s = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=True)
    torch.cuda.synchronize()
    assert fr.launch_tiles[(R, S, True)] == ft.fwd_tiles[(R, S, True)] == _H100_TILES[(R, S)]
    for name, a, b in zip(rule.OUTPUTS, k1, k1s):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dot_bf16", [False, True])
@pytest.mark.parametrize("R,S", [(224, 65), (224, 193), (256, 65), (256, 193), (3840, 65)])
def test_outputs_at_the_chosen_tile_equal_those_at_16(cuda, dot_bf16, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    args = _level_inputs(R, S, S + 1, cuda)
    for fn in (fr.fused_render_level, ft.fused_level_fwd_spill):
        chosen = fn(kp, *args, True, dot_bf16=dot_bf16)
        tiles = fr.launch_tiles if fn is fr.fused_render_level else ft.fwd_tiles
        assert tiles[(R, S, dot_bf16)] == _H100_TILES[(R, S)] != 16
        at16 = fn(kp, *args, True, ray_tile=16, dot_bf16=dot_bf16)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(chosen, at16)), fn.__name__
        del chosen, at16
    assert fr.launch_tiles[(R, S, dot_bf16)] == 16 and ft.fwd_tiles[(R, S, dot_bf16)] == 16


@pytest.mark.parametrize("S", [65, 193])
def test_bf16_walk_meets_the_rule_at_the_presets_shapes(cuda, S):
    # K1 at the fast preset's chunk of 256 rays (its validation and test
    # launches), K1s' saved layers at its batch of 224 (its training
    # launches), each at the tile the wrapper chooses (2)
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + 7), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    for R in (256, 224):
        args = _level_inputs(R, S, S + 7, cuda)
        args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in args))
        *p64, p64_saved, _ = ft.fused_level_fwd_spill_ref(*args64, True, dot_bf16=True)
        if R == 256:
            names = rule.OUTPUTS
            got = dict(zip(names, fr.fused_render_level(kp, *args, True, dot_bf16=True)))
            orders = {k: dict(zip(names, fr.fused_render_level_ref(kp, *args, True, mm=mm, dot_bf16=True)))
                      for k, mm in rule.BF16_ORDERS.items()}
            ratios = _bf16_ratios(got, orders, dict(zip(names, p64)), rule.TOL_BF16_FWD)
        else:
            got = rule.saved_layers(ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=True)[4])
            orders = {k: rule.saved_layers(ft.fused_level_fwd_spill_ref(kp, *args, True, mm=mm, dot_bf16=True)[4])
                      for k, mm in rule.BF16_ORDERS.items()}
            ratios = _bf16_ratios(got, orders, rule.saved_layers(p64_saved), rule.TOL_BF16_FWD)
        assert (fr.launch_tiles if R == 256 else ft.fwd_tiles)[(R, S, True)] == 2
        assert all(r <= 1.0 for r in ratios.values()), (R, ratios)


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bf16_bwd_kernel_meets_the_bf16_rule(cuda, S, white_bkgd):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    cot = _cotangents(256, S, S + 1, cuda)
    before = ft.launches, ft.bf16_launches
    got = ft.fused_level_bwd(kp, *args, *cot, white_bkgd, dot_bf16=True)
    torch.cuda.synchronize()
    assert (ft.launches, ft.bf16_launches) == (before[0], before[1] + 1)
    orders = {}
    for k, mm in rule.BF16_ORDERS.items():
        saved, raw = ft.fused_level_fwd_spill_ref(kp, *args, white_bkgd, mm=mm, dot_bf16=True)[4:]
        orders[k] = ft.fused_level_bwd_saved_ref(kp, *args, saved, raw, *cot, white_bkgd, mm=mm, dot_bf16=True)
    del saved, raw
    p64 = ft.fused_level_bwd_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args),
                                 *(c.double() for c in cot), white_bkgd, dot_bf16=True)
    assert all(torch.isfinite(g).all() for g in got.values())
    ratios = _bf16_ratios(got, orders, p64, rule.TOL_BF16_GRAD)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    fp32 = _bf16_ratios(ft.fused_level_bwd(kp, *args, *cot, white_bkgd), orders, p64, rule.TOL_BF16_GRAD)
    assert any(r > 1.0 for r in fp32.values()), fp32
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, white_bkgd, dot_bf16=True)
    split = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, white_bkgd, dot_bf16=True)
    again = ft.fused_level_bwd(kp, *args, *cot, white_bkgd, dot_bf16=True)
    for name in fr.WEIGHT_NAMES:
        assert torch.equal(split[name], got[name]) and torch.equal(again[name], got[name]), name


# The bf16 kernels at sizes whose rows end mid-chunk, mid-step and mid-range
# (48 x 65: B1's 64-row chunk, B2's 64-row step and its 16 row ranges; 16 x
# 7: a block's 112 rows, a weight stream that ends mid-ring), held to the
# same rays inside a 256-ray launch, where the other rays' cotangents are 0
# and so add exactly 0: K1 and K1s give the same bits (a block's rays are
# computed alike), K2 the same gradients but for B2's other row ranges and
# B1's head sums over other ray tiles (1 and 2 at 48 and 256 rays of 65
# samples), fp32 summation orders (at most 1e-5 of a gradient's largest
# entry). At so few rows the bf16 rule's spread is a handful of rounding
# flips, so these sizes are held to the launch the rule holds.
_PARTIAL_TOL = 1e-5


@pytest.mark.parametrize("R,S", [(48, 65), (16, 7)])
def test_bf16_kernels_at_partial_sizes(cuda, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    cot = _cotangents(256, S, S + 1, cuda)
    part = tuple(a[:R].contiguous() for a in args)
    k1, k1_all = fr.fused_render_level(kp, *part, True, dot_bf16=True), fr.fused_render_level(kp, *args, True,
                                                                                              dot_bf16=True)
    k1s = ft.fused_level_fwd_spill(kp, *part, True, dot_bf16=True)
    for a, b, c in zip(k1, k1s, k1_all):
        assert torch.equal(a, b) and torch.equal(a, c[:R])
    zero = tuple(torch.cat([c[:R], torch.zeros_like(c[R:])]).contiguous() for c in cot)
    got = ft.fused_level_bwd(kp, *part, *(c[:R].contiguous() for c in cot), True, dot_bf16=True)
    want = ft.fused_level_bwd(kp, *args, *zero, True, dot_bf16=True)
    torch.cuda.synchronize()
    for name in fr.WEIGHT_NAMES:
        rel = _rel_err(got[name], want[name].double())
        assert rel <= _PARTIAL_TOL, f"{name}: {rel}"


# B2 alone, in each mode: its gradients against the products of the very
# operands it read, K1s' saved activations (xenc for w0, w5i) and B1's deltas
# from the call's own scratch (in bf16 mode both scratches bf16), summed in
# fp64 (rounded to bf16 first in bf16 mode, level_bwd_dw_bf16_kernel),
# within chip_smoke.py's B2_TOL in bf16 (B2's own fp32 sums: 32-row
# tensor-core runs, the range, the 16 ranges) and B2_FP32_TOL in fp32
# (level_bwd_dw_kernel: 3xTF32 products, 64-row tensor-core runs, the range,
# the 16 ranges); each bias in fp32 against its deltas summed in fp64
# (B2_FP32_TOL), in bf16 mode, where B1 sums the biases from the fp32 deltas
# it holds, against the fp64 sums of the fp64 products of B1's operands
# (B1_BIAS_TOL). The sizes walk the edges of
# the fp32 B2's ring of four 32-row stages: 256 x 65 rows end in a partial
# last range (15 ranges of 1088 rows, one of 320), 48 x 65 in a range of 48
# rows and three empty ones, 16 x 7 in two short ranges, the second of 48
# rows, its last stage wholly past the rows; at 16 x 33 every range holds
# one 64-row step, two stages, fewer than the ring has.
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R,S", [(256, 65), (48, 65), (16, 7), (16, 33)],
                         ids=["partial-last-range", "short-and-empty-ranges", "past-the-rows", "one-step-ranges"])
def test_bf16_b2_is_the_bf16_product_of_what_it_read(cuda, R, S, dot_bf16):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = (kp, *_level_inputs(R, S, S, cuda))
    cot = _cotangents(R, S, S + 1, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=dot_bf16)
    _check_b2(args, saved, raw, cot, dot_bf16)


def _check_b2(args, saved, raw, cot, dot_bf16):
    R, S = args[1].shape
    before = ft.launches, ft.bf16_launches
    got, delta, grow = rule.backward_operands(args, saved, raw, cot, True, dot_bf16)
    torch.cuda.synchronize()
    assert (ft.launches, ft.bf16_launches) == (before[0] + (not dot_bf16), before[1] + dot_bf16)
    assert saved.dtype == delta.dtype == ft.saved_dtype(dot_bf16)
    operand = fr.round_bf16 if dot_bf16 else (lambda x: x)
    tol = rule.B2_TOL if dot_bf16 else rule.B2_FP32_TOL
    for name, (h, d) in rule.b2_operands(saved, args[5].reshape(R * S, -1), delta).items():
        want = operand(h).double().t() @ operand(d).double()
        assert got[name].shape == want.shape and torch.isfinite(got[name]).all(), name
        rel = _rel_err(got[name], want)
        assert rel <= tol, f"{name}: {rel}"
    if dot_bf16:
        _check_b1_bias_sums(args[0], saved, grow, delta, got)
    else:
        for name, col in rule.B2_BIASES.items():
            want = delta[:, col: col + (128 if name == "bv" else 256)].double().sum(0)
            rel = _rel_err(got[name].reshape(-1), want)
            assert rel <= tol, f"{name}: {rel}"
    again = ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, dot_bf16=dot_bf16)
    for name in fr.WEIGHT_NAMES:
        assert torch.equal(again[name], got[name]), name  # no atomics: the same bits


def _check_b1_bias_sums(kp, saved, grow, delta, got):
    """B1's ten bias sums in bf16 mode against the fp64 sums of the fp64
    products of the operands it read (chip_smoke.py's B1_BIAS_TOL)."""
    for layer, _, want in rule.b1_products(kp, saved, grow, delta, torch.float64):
        name = rule.B1_BIASES[layer]
        assert got[name].shape == (1, want.shape[1]) and torch.isfinite(got[name]).all(), name
        rel = _rel_err(got[name].reshape(-1), want.sum(0))
        assert rel <= rule.B1_BIAS_TOL, f"{name}: {rel}"


# The bf16 scratches, at sizes of their own. B2 where a range ends inside a
# 32-row step after the 8-stage ring (4 slots for xenc's tiles) has
# wrapped: 72 x 65 = 4,680 rows, 14 ranges of 320 rows (10 steps), one of
# 200 (6 steps and 8 rows) and an empty one.
def test_bf16_b2_where_a_range_ends_inside_a_step(cuda):
    R, S = 72, 65
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + 1), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    args = (kp, *_level_inputs(R, S, S + 1, cuda))
    cot = _cotangents(R, S, S + 2, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    _check_b2(args, saved, raw, cot, True)


# B2's swizzled bf16 tiles (TMA's 128-byte swizzle, xenc's tiles rounded into
# the same layout) at row counts that are no multiple of a 32-row stage:
# 31 rows (less than one stage), 111 (3 stages and 15 rows), 65 (2 and 1).
@pytest.mark.parametrize("R,S", [(1, 31), (3, 37), (5, 13)])
def test_bf16_b2_swizzled_tiles_at_rows_off_a_stage(cuda, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + 2), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    args = (kp, *_level_inputs(R, S, S + 2, cuda))
    cot = _cotangents(R, S, S + 3, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    _check_b2(args, saved, raw, cot, True)


# B1's ten bias sums (bf16 mode) at the fast preset's batch, at the tile K2
# chooses (2) and at 16 rays a block: each within B1_BIAS_TOL of the fp64
# sums of its deltas' fp64 products; the deltas it writes do not depend on
# the tile.
@pytest.mark.parametrize("S", [65, 193])
def test_bf16_b1_bias_sums_are_the_sums_of_its_fp32_deltas(cuda, S):
    R = 224
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + 3), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    args = (kp, *_level_inputs(R, S, S + 3, cuda))
    cot = _cotangents(R, S, S + 4, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    deltas = []
    for tile in (None, 16):
        got, delta, grow = ft.fused_level_bwd_saved(*args, saved, raw, *cot, True, ray_tile=tile, dot_bf16=True,
                                                    deltas=True)
        torch.cuda.synchronize()
        assert ft.bwd_tiles[(R, S, True)] == (2 if tile is None else 16)
        _check_b1_bias_sums(kp, saved, grow, delta, got)
        deltas.append(delta.clone())
    assert torch.equal(deltas[0], deltas[1])


def _exact_level(R, S, device):
    """Weights and inputs whose every product sums one or two nonzero terms,
    multiples of 1/16 below 8 (the product weights are 0/1 selections, w5i's
    halves, xenc on a grid of 1/8, the biases multiples of 1/8, wvb zero): in
    bf16 mode every activation is exact in any summation order, and a bf16
    value."""
    rng = np.random.default_rng(R + S)
    kp = {}
    for n in ("w1", "w2", "w3", "w4", "w5x", "w6", "w7", "wb", "wva"):
        cols = 128 if n == "wva" else 256
        w = np.zeros((256, cols), np.float32)
        w[rng.permutation(256)[:cols], np.arange(cols)] = 1.0
        kp[n] = w
    kp["w0"] = np.zeros((63, 256), np.float32)
    kp["w0"][np.arange(256) % 63, np.arange(256)] = 1.0
    kp["w5i"] = np.zeros((63, 256), np.float32)
    kp["w5i"][rng.integers(0, 63, 256), np.arange(256)] = 0.5
    for n, width in (*((f"b{i}", 256) for i in range(8)), ("bb", 256), ("bv", 128)):
        kp[n] = (rng.integers(-2, 3, (1, width)) / 8).astype(np.float32)
    kp["wvb"] = np.zeros((27, 128), np.float32)
    kp["wd"], kp["wr"] = ((0.1 * rng.standard_normal(shape)).astype(np.float32) for shape in ((256, 1), (128, 3)))
    kp["bd"], kp["br"] = np.full((1, 1), 0.5, np.float32), np.zeros((1, 3), np.float32)
    kp = {n: torch.from_numpy(kp[n]).to(device) for n in fr.WEIGHT_NAMES}
    t, o, d, venc, xenc = _level_inputs(R, S, R + S, device)
    return kp, (t, o, d, venc, torch.round(8 * xenc) / 8)


# K1s bf16 writes its saved activations as torch.bfloat16 (R*S, 2432): each
# warp stmatrix-es its epilogue's bf16 pairs into a 128-byte-swizzled tile in
# the weight ring's last two stages, and thread 0 TMA-stores it in 64x64
# boxes. Where every sum is exact in any order, they equal the plain
# version's bit for bit, at a partial last chunk (48 x 65) and at the train
# step's S (256 x 193).
@pytest.mark.parametrize("R,S", [(48, 65), (256, 193)])
def test_bf16_k1s_saved_equals_the_plain_version_on_exact_sums(cuda, R, S):
    kp, args = _exact_level(R, S, cuda)
    saved = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=True)[4]
    plain = ft.fused_level_fwd_spill_ref(kp, *args, True, dot_bf16=True)[4]
    torch.cuda.synchronize()
    assert saved.dtype == plain.dtype == torch.bfloat16 and saved.shape == plain.shape == (R * S, ft.SAVED_FLOATS)
    layers = rule.saved_layers(plain)
    assert all((v != 0).double().mean().item() > 0.1 for v in layers.values())  # every layer lives
    assert torch.equal(saved, plain)


# B1 in bf16 mode alone (level_bwd_delta_kernel<true>, native bf16 products
# from the wrapper's bf16 pack): each delta it wrote (bf16) against the
# product of the operands it read (the delta of the layer above from its own
# scratch, g_raw from the integrator backward's, the rounded weights, the
# saved activations' masks) rounded to bf16 and summed in fp64, beyond half a
# bf16 ulp (rule.b1_delta_error), and its head gradients wd, bd, wr, br
# against their operands' fp64 sums, within chip_smoke.py's B1_TOL (its own
# fp32 sums). The sizes are the B2 test's:
# 48 x 65 ends mid-chunk, 16 x 7 mid-ring.
@pytest.mark.parametrize("R,S", [(256, 65), (48, 65), (16, 7)])
def test_bf16_b1_is_the_bf16_product_of_what_it_read(cuda, R, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5  # live densities: g_raw_sigma is not all 0
    args = (kp, *_level_inputs(R, S, S, cuda))
    cot = _cotangents(R, S, S + 1, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, True, dot_bf16=True)
    got, delta, grow = rule.backward_operands(args, saved, raw, cot, True, True)
    torch.cuda.synchronize()
    assert grow[:, 0].abs().max() > 0 and grow[:, 1:].abs().max() > 0
    assert delta.dtype == torch.bfloat16
    for name, d, want in rule.b1_products(kp, saved, grow, delta, torch.float64):
        assert torch.isfinite(d).all() and want.abs().max() > 0, name
        rel = rule.b1_delta_error(d, want)  # beyond half a bf16 ulp: it writes its fp32 deltas rounded
        assert rel <= rule.B1_TOL, f"{name}: {rel}"
    for name, want in rule.b1_heads(saved, grow).items():
        rel = _rel_err(got[name].reshape(-1), want.reshape(-1))
        assert rel <= rule.B1_TOL, f"{name}: {rel}"


# K2's ray tile: in bf16 mode chosen per launch from B1's shared memory
# (2 at the fast preset's 224 rays: 112 blocks of 3 / 7 chunks, where 16
# rays a block give 14 blocks of 17 / 49); the order of its head and bias
# sums (B1's per-block sums) moves with it, so K2 at the chosen tile and at
# 16 are each held to the bf16 rule, and B2's 11 weight products, from B1's
# deltas, which no tile moves, keep their bits.
@pytest.mark.parametrize("S", [65, 193])
def test_bf16_k2_at_the_chosen_tile_and_at_16_meet_the_rule(cuda, S):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + 7), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    R = 224
    args = _level_inputs(R, S, S + 7, cuda)
    cot = _cotangents(R, S, S + 8, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=True)
    chosen = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, dot_bf16=True)
    assert ft.bwd_tiles[(R, S, True)] == 2
    at16 = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, ray_tile=16, dot_bf16=True)
    assert ft.bwd_tiles[(R, S, True)] == 16
    torch.cuda.synchronize()
    for name in rule.B2_PRODUCTS:
        assert torch.equal(chosen[name], at16[name]), name
    orders = {}
    for k, mm in rule.BF16_ORDERS.items():
        p_saved, p_raw = ft.fused_level_fwd_spill_ref(kp, *args, True, mm=mm, dot_bf16=True)[4:]
        orders[k] = ft.fused_level_bwd_saved_ref(kp, *args, p_saved, p_raw, *cot, True, mm=mm, dot_bf16=True)
    del p_saved, p_raw
    p64 = ft.fused_level_bwd_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args),
                                 *(c.double() for c in cot), True, dot_bf16=True)
    for got in (chosen, at16):
        assert all(torch.isfinite(g).all() for g in got.values())
        ratios = _bf16_ratios(got, orders, p64, rule.TOL_BF16_GRAD)
        assert all(r <= 1.0 for r in ratios.values()), ratios


def test_fp32_k2_keeps_16_rays_a_block(cuda):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(3), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    R, S = 224, 65  # where bf16 mode takes 2
    args = _level_inputs(R, S, 3, cuda)
    cot = _cotangents(R, S, 4, cuda)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True)
    default = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True)
    assert ft.bwd_tiles[(R, S, False)] == 16
    at16 = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, ray_tile=16)
    whole = ft.fused_level_bwd(kp, *args, *cot, True)
    # the composition's K1s takes its own tile (2 at 224 rays; its outputs do
    # not depend on it), its backward keeps 16
    assert ft.bwd_tiles[(R, S, False)] == 16 and ft.fwd_tiles[(R, S, False)] == 2
    torch.cuda.synchronize()
    for name in fr.WEIGHT_NAMES:
        assert torch.equal(default[name], at16[name]) and torch.equal(whole[name], at16[name]), name


def test_b1_pack_on_the_card_is_the_cpu_pack(cuda):
    rng = np.random.default_rng(11)
    kp = {n: torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
          for n, v in fr.kernel_params(NeRFMLP(generator=torch.Generator().manual_seed(0))).items()}
    for v in kp.values():  # every fourth weight exactly halfway between two bf16 values
        v.view(-1)[::4] = (fr.round_bf16(v).view(torch.int32) + 0x8000).view(torch.float32).view(-1)[::4]
    on_card = ft.b1_weights_bf16({n: v.to(cuda) for n, v in kp.items()})
    assert on_card.device.type == "cuda" and on_card.dtype == torch.bfloat16
    assert torch.equal(on_card.cpu().view(torch.int16), ft.b1_weights_bf16(kp).view(torch.int16))
    lib = ft._library()  # the library's counts, which the wrapper and tests/test_torch_b1_bf16.py use
    assert lib.aonerf_fused_level_b1_bf16_bytes() == 2 * ft.B1_PACK_ELEMS
    assert [lib.aonerf_fused_level_bwd_smem_bytes(S, T) for S, T in ((193, 16), (65, 2), (7, 1))] == [
        225408, 218240, 217728]


def test_bf16_train_cli_goes_through_the_kernels(cuda, tmp_path):
    import json
    import os

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_single_scene

    root = generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=1)
    fast = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", "vanilla_tpu_fast.json")
    overrides = {"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": [16, 12], "inner_steps": 5,
                 "lr_delay_steps": 0, "val_every_steps": 10, "ckpt_every_steps": 10, "limit_val_batches": 1}
    args = [x for k, v in overrides.items() for x in (f"--{k}", json.dumps(v) if not isinstance(v, str) else v)]
    counts = fr.launches, ft.fwd_launches, ft.launches, fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches
    metrics = cli.main(["--config", fast, *args, "--max_steps", "10"])
    torch.cuda.synchronize()
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    now = fr.launches, ft.fwd_launches, ft.launches, fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches
    val_tiles = -(-16 * 12 // 256)  # chunk 256
    assert [b - a for a, b in zip(counts, now)] == [0, 0, 0, 2 * val_tiles, 2 * 10, 2 * 10]
    counts = now
    stats = cli.main(["--config", fast, *args, "--run_eval"])
    torch.cuda.synchronize()
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    now = fr.launches, ft.fwd_launches, ft.launches, fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches
    assert [b - a for a, b in zip(counts, now)] == [0, 0, 0, 2 * val_tiles, 0, 0]


# ------------------------------------------------ the articulated models in bf16


def _articulated_rule_inputs(latent_dense, n_rays=64, seed=18):
    from aonerf_torch.models.articulated import ArticulatedNeRF

    g = torch.Generator().manual_seed(seed)
    f32 = ArticulatedNeRF(num_coarse_samples=16, num_fine_samples=32, latent_dense=latent_dense, generator=g,
                          device="cpu")
    rule._random_biases(f32, g)
    latents = {k: 0.3 * torch.randn((2, c), generator=g) for k, c in (("density", 128), ("color", 128),
                                                                      ("articulation", 32))}
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.3 * rng.standard_normal((n_rays, 3))).astype(np.float32)
    rays = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d), "viewdirs": torch.from_numpy(d)}
    return f32, rays, latents


@pytest.mark.parametrize("latent_dense", [False, True], ids=["concat", "latent_dense"])
def test_bf16_articulated_field_meets_the_rule_on_the_card(cuda, latent_dense):
    # the card's bf16 field against the CPU's forms under the articulated
    # bf16 rule, end to end and layer by layer; the card's fp32 field misses
    f32, rays, latents = _articulated_rule_inputs(latent_dense)
    res = rule.articulated_bf16_rule(f32, rays, latents, 2.0, 6.0, True, cuda)
    assert res["ok"], (res["e2e"]["card bf16"], max(res["layers"], key=lambda x: x[1][1] / x[2]))
    assert not res["fp32_ok"]
    assert len(res["layers"]) == 20


def test_bf16_ae_step_on_the_card(cuda, tmp_path):
    # one bf16 auto-encoder step with two source views on a 64x48 scene:
    # finite fp32 gradients for every parameter, the parameters moved; and
    # the bf16 forward under the rule against the CPU's forms
    from aonerf_torch.data import sapien_multi as sm
    from aonerf_torch.data.synthetic import generate_multi_scene
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
    from aonerf_torch.ops.random import Draws
    from aonerf_torch.train import step as tstep
    from aonerf_torch.train import step_ae as tstep_ae

    root = generate_multi_scene(str(tmp_path / "multi"), img_wh=(64, 48), degrees=(0, 10, 20), n_images=2)
    bufs = {k: torch.from_numpy(v).to(cuda) for k, v in
            sm.SapienMultiDataset(root, split="train", img_wh=(64, 48)).device_buffers().items()}
    model = AutoEncoderArticulatedNeRF(num_coarse_samples=16, num_fine_samples=32, compute_dtype=torch.bfloat16,
                                       generator=torch.Generator().manual_seed(0), device=cuda)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    draws = Draws.for_step(0, 0, cuda)
    batch = tstep.sample_multi_batch_multiview(bufs, draws, 256, 2, src_hw=(48, 64))
    named = dict(model.named_parameters())
    loss, parts, grads = tstep_ae.ae_loss_and_grads(model, named, batch, draws, True, True, 2.0, 6.0, 0.5)
    assert torch.isfinite(loss) and all(torch.isfinite(p) for p in parts)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    tx = tstep.make_adam(lr_delay_steps=0)
    step = tstep_ae.make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=(64, 48), batch_size=256,
                                              views_per_step=2)
    state, m = step(tstep.create_train_state(model, tx), bufs, 0)
    assert state.step == 1 and np.isfinite(m["loss"].item())
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters() if n.startswith("field."))

    ae32 = AutoEncoderArticulatedNeRF(num_coarse_samples=16, num_fine_samples=32,
                                      generator=torch.Generator().manual_seed(1), device="cpu")
    _, rays, _ = _articulated_rule_inputs(True, n_rays=64)
    src = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 48, 64)).astype(np.float32))
    res = rule.ae_bf16_rule(ae32, rays, src, torch.tensor([0.3, 1.0]), 2.0, 6.0, True, cuda)
    assert res["ok"], res["parts"]["card bf16"]


@pytest.mark.parametrize("name", ["autodecoder_tpu_fast", "ae_art_tpu_quality", "ae_art_tpu_fast"])
def test_bf16_preset_fits_and_sweeps_through_the_cli(cuda, tmp_path, name):
    # each articulated bf16 preset as published but for a small scene, 4 + 8
    # samples and 2 steps a dispatch: fit with a validation and an fp32
    # checkpoint, the sweep (2 poses), no fused level kernel
    import json
    import os

    from aonerf_torch.cli import train as cli
    from aonerf_torch.data.synthetic import generate_multi_scene

    wh = (16, 12) if name.startswith("autodecoder") else (64, 48)
    root = generate_multi_scene(str(tmp_path / "multi"), img_wh=wh, degrees=(0, 10, 20), n_images=2,
                                val_degrees=(5, 15), n_val_images=1)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", f"{name}.json")
    overrides = {"root_dir": root, "output_path": str(tmp_path / "out"), "img_wh": list(wh), "num_coarse_samples": 4,
                 "num_fine_samples": 8, "batch_size": 32, "inner_steps": 2, "lr_delay_steps": 0,
                 "val_every_steps": 4, "ckpt_every_steps": 4, "limit_val_batches": 1}
    args = [x for k, v in overrides.items() for x in (f"--{k}", json.dumps(v) if not isinstance(v, str) else v)]
    counts = fr.launches + fr.bf16_launches, ft.fwd_launches + ft.bf16_fwd_launches, ft.launches + ft.bf16_launches
    metrics = cli.main(["--config", path, *args, "--max_steps", "4"])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    with open(path) as f:
        exp_name = json.load(f)["exp_name"]
    saved = torch.load(os.path.join(str(tmp_path / "out"), exp_name, "ckpts", "ckpt_00000004.pt"), map_location="cpu")
    assert all(v.dtype == torch.float32 for v in saved["params"].values())
    stats = cli.main(["--config", path, *args, "--run_eval", "--test_sweep_poses", "2"])
    torch.cuda.synchronize()
    assert all(np.isfinite(stats[k]["test"]) for k in ("psnr", "ssim", "psnr_obj"))
    now = fr.launches + fr.bf16_launches, ft.fwd_launches + ft.bf16_fwd_launches, ft.launches + ft.bf16_launches
    assert now == counts


# K1s with sigma noise (models/nerf.py's noise_std): raw sigma is the
# noiseless raw sigma plus the noise (one fp32 add), everything else the
# noiseless bits; the outputs and raw against the plain version with the
# same noise, in fp32 within _TOLS and _SPILL_TOL, in bf16 by
# chip_smoke.py's bf16 rule.
@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_k1s_with_noise_matches_plain_version(cuda, S, dot_bf16):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    noise = torch.from_numpy(np.random.default_rng(S + 1).uniform(size=(256, S)).astype(np.float32)).to(cuda)
    before = ft.bf16_fwd_launches if dot_bf16 else ft.fwd_launches
    got = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=dot_bf16, noise=noise)
    torch.cuda.synchronize()
    assert (ft.bf16_fwd_launches if dot_bf16 else ft.fwd_launches) == before + 1
    quiet = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=dot_bf16)
    assert torch.equal(got[4], quiet[4]) and torch.equal(got[5][:, 1:], quiet[5][:, 1:])
    assert torch.equal(got[5][:, 0], quiet[5][:, 0] + noise.reshape(-1))
    want = ft.fused_level_fwd_spill_ref(kp, *args, True, dot_bf16=dot_bf16, noise=noise)
    if not dot_bf16:
        assert (got[5] - want[5]).abs().max().item() <= _SPILL_TOL
        for name, g, w in zip(("comp", "acc", "depth", "weights"), got, want):
            err = (g - w).abs().max().item()
            assert err <= _TOLS[name], f"{name}: max abs err {err}"
        return

    def outputs(run):
        return {**dict(zip(rule.OUTPUTS, run[:4])), "raw": run[5]}

    args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in args))
    orders = {k: outputs(ft.fused_level_fwd_spill_ref(kp, *args, True, mm=mm, dot_bf16=True, noise=noise))
              for k, mm in rule.BF16_ORDERS.items()}
    ref = outputs(ft.fused_level_fwd_spill_ref(*args64, True, dot_bf16=True, noise=noise.double()))
    ratios = rule.bf16_ratios(outputs(got), ref, rule.bf16_limits(orders, ref, rule.TOL_BF16_FWD))
    assert all(r <= 1.0 for r in ratios.values()), ratios


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_k1s_without_noise_keeps_its_bits(cuda, dot_bf16):
    # noise=None is the call without the argument, and a zero noise gives
    # the same bits as none
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(3), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, 65, 3, cuda)
    plain = ft.fused_level_fwd_spill(kp, *args, False, dot_bf16=dot_bf16)
    none = ft.fused_level_fwd_spill(kp, *args, False, dot_bf16=dot_bf16, noise=None)
    zero = ft.fused_level_fwd_spill(kp, *args, False, dot_bf16=dot_bf16, noise=torch.zeros((256, 65), device=cuda))
    for a, b, c in zip(plain, none, zero):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="noise"):
        ft.fused_level_fwd_spill(kp, *args, False, dot_bf16=dot_bf16, noise=torch.zeros((256, 64), device=cuda))


@pytest.mark.parametrize("S", [65, 193])
def test_k2_from_noisy_saved_matches_plain_version(cuda, S):
    # K2 from what K1s saved with noise, against its plain version from the
    # same saved and raw: each gradient within max(1e-4, 4 x the fp32 plain
    # version's error) against fp64 (chip_smoke.py's TOL_GRAD rule)
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = _level_inputs(256, S, S, cuda)
    noise = torch.from_numpy(np.random.default_rng(S + 2).uniform(size=(256, S)).astype(np.float32)).to(cuda)
    cot = _cotangents(256, S, S, cuda)
    saved, raw = ft.fused_level_fwd_spill(kp, *args, True, noise=noise)[4:]
    got = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True)

    p32 = ft.fused_level_bwd_saved_ref(kp, *args, saved, raw, *cot, True)
    p64 = ft.fused_level_bwd_saved_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args),
                                       saved, raw.double(), *(c.double() for c in cot), True)
    for n in fr.WEIGHT_NAMES:
        scale = p64[n].abs().max().clamp_min(1e-300)
        e_k = ((got[n].double() - p64[n]).abs().max() / scale).item()
        e_p = ((p32[n].double() - p64[n]).abs().max() / scale).item()
        assert e_k <= max(rule.TOL_GRAD, rule.TOL_GRAD_FACTOR * e_p), (n, e_k, e_p)


def test_lpips_on_the_card_matches_the_cpu(cuda, tmp_path):
    # random weights at VGG16's widths; the card's convolutions in fp32
    # (eval.lpips holds TF32 off), the CPU's the reference: within 1e-4
    from aonerf_torch.eval import lpips

    path = str(tmp_path / "lpips.npz")
    lpips.write_random_weights(path, seed=5)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(size=(48, 64, 3)).astype(np.float32))
    b = (a + 0.1 * torch.from_numpy(rng.standard_normal((48, 64, 3)).astype(np.float32))).clamp(0, 1)
    torch.backends.cudnn.allow_tf32 = True  # lpips turns it off for its own convolutions
    card = lpips.lpips_distance(lpips.load_weights(path), a.to(cuda), b.to(cuda))
    cpu = lpips.lpips_distance(lpips.load_weights(path, "cpu"), a, b)
    assert card.device.type == "cuda" and torch.isfinite(card)
    assert abs(card.item() - cpu.item()) <= 1e-4 * abs(cpu.item())


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", rule.NAN_CASES)
@pytest.mark.parametrize("S", [65, 193])
def test_kernels_keep_a_planted_nan_where_the_plain_versions_do(cuda, S, case, dot_bf16):
    # one NaN in a trunk weight, a view-branch weight, a cotangent or one
    # sample's encoded input (torch's NaN, or the card's arithmetic's
    # 0x7fffffff or its negation): K1, K1s and K2 NaN exactly where their
    # plain versions are (a NaN through the forward's ReLU and clamps, none
    # through a closed backward mask); the outputs and gradients the NaN
    # cannot reach keep the clean call's bits
    _planted_nan_case(cuda, S, case, dot_bf16, NeRFMLP(generator=torch.Generator().manual_seed(S), device=cuda))


def _planted_nan_case(cuda, S, case, dot_bf16, mlp):
    with torch.no_grad():
        kp0 = fr.kernel_params(mlp)
    args0 = _level_inputs(256, S, S, cuda, mlp.min_deg_point, mlp.max_deg_point, mlp.deg_view)
    cot0 = _cotangents(256, S, S + 1, cuda)
    kp, cot, xenc = rule.plant_nan(kp0, cot0, case, args0[4])
    args = (kp, *args0[:4], xenc)
    k1 = fr.fused_render_level(*args, True, dot_bf16=dot_bf16)
    k1s = ft.fused_level_fwd_spill(*args, True, dot_bf16=dot_bf16)
    k2 = ft.fused_level_bwd_saved(*args, k1s[4], k1s[5], *cot, True, dot_bf16=dot_bf16)
    p1 = fr.fused_render_level_ref(*args, True, dot_bf16=dot_bf16)
    p1s = ft.fused_level_fwd_spill_ref(*args, True, dot_bf16=dot_bf16)
    p2 = ft.fused_level_bwd_saved_ref(*args, k1s[4], k1s[5], *cot, True, dot_bf16=dot_bf16)
    for i, n in enumerate(rule.OUTPUTS):
        assert torch.equal(torch.isnan(k1[i]), torch.isnan(p1[i])), ("K1", n)
        assert torch.equal(torch.isnan(k1s[i]), torch.isnan(p1s[i])), ("K1s", n)
        assert torch.equal(k1s[i].isnan(), k1[i].isnan()) and torch.equal(k1s[i].nan_to_num(), k1[i].nan_to_num())
    for n in fr.WEIGHT_NAMES:
        assert torch.equal(torch.isnan(k2[n]), torch.isnan(p2[n])), ("K2", n)

    clean1s = ft.fused_level_fwd_spill(kp0, *args0, True, dot_bf16=dot_bf16)
    clean2 = ft.fused_level_bwd_saved(kp0, *args0, clean1s[4], clean1s[5], *cot0, True, dot_bf16=dot_bf16)
    place = case.split()[0]  # the case's bits after the place: the NaN's, where not torch's
    if place == "view":  # acc, depth and weights do not see the view branch
        assert torch.isnan(k1s[0]).all()
        for i in (1, 2, 3):
            assert torch.equal(k1s[i], clean1s[i])
    if place == "cotangent":  # the outputs and the view branch's gradients do not see the acc cotangent
        for i in range(4):
            assert torch.equal(k1s[i], clean1s[i])
        for n in ("wb", "bb", "wva", "wvb", "bv", "wr", "br"):
            assert torch.equal(k2[n], clean2[n]), n
        assert torch.isnan(k2["wd"]).all()
    if place == "xenc":  # only the planted sample's ray sees it, and the fp32 products must not read it as 0
        ray = rule.XENC_NAN_RAY
        assert torch.isnan(k1s[0][ray]).all() and torch.isnan(k1s[3][ray, rule.XENC_NAN_SAMPLE])
        others = torch.arange(256, device=cuda) != ray
        for i in range(4):
            assert torch.equal(k1s[i][others], clean1s[i][others])
        assert torch.isnan(k2["w0"][k2["w0"].shape[0] // 2]).all() and torch.isnan(k2["w5i"][k2["w5i"].shape[0] // 2]).all()


# Other encoded widths (the libraries built for them at first use): the
# sample and view widths -> (min_deg_point, max_deg_point, deg_view)
_DEGREE_WIDTHS = {"51/15": (0, 8, 2), "75/39": (0, 12, 6)}


def _degree_level(cuda, degrees, R, S):
    lo, hi, view = degrees
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S + hi), device=cuda, min_deg_point=lo, max_deg_point=hi,
                  deg_view=view)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5  # live densities
    args = _level_inputs(R, S, S, cuda, lo, hi, view)
    assert (args[4].shape[-1], args[3].shape[-1]) == fr.widths(kp) == (3 + 6 * (hi - lo), 3 + 6 * view)
    return kp, args, _cotangents(R, S, S + 1, cuda)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("widths", list(_DEGREE_WIDTHS))
def test_degrees_kernels_match_their_plain_versions(cuda, widths, S, dot_bf16):
    _check_degree_kernels(cuda, _DEGREE_WIDTHS[widths], S, dot_bf16)


# Every sample width the degrees 0-12 give (3 to 75), each with the view
# width of degrees d mod 9, so every view width from 3 to 51 runs too; their
# libraries are built in one call, every nvcc at once. fp32 only: the bf16
# rule, held at 75 / 39 and 51 / 15 above, turns away right kernels at some
# seeds and widths (at the default widths too), and at sample width 3 its
# fp32 orders of a 3-term sum do not spread at all (PERF.md section 6;
# tools/torch_bf16_rule_widths.py prints it at every width).
_SWEEP = tuple((0, d, d % 9) for d in range(13))


@pytest.fixture(scope="module")
def sweep_libraries():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from aonerf_torch.ops.kernels import build

    build.build([(n, build.width_defines(3 + 6 * hi, 3 + 6 * view)) for _, hi, view in _SWEEP
                 for n in build.all_sources()])


@pytest.mark.parametrize("degrees", _SWEEP, ids=lambda d: f"{3 + 6 * d[1]}/{3 + 6 * d[2]}")
def test_degrees_every_encoded_width(cuda, sweep_libraries, degrees):
    _check_degree_kernels(cuda, degrees, 65, False)


def _check_degree_kernels(cuda, degrees, S, dot_bf16):
    # K1, K1s and K2 at other encoded widths against their plain versions
    # under the rules of the default widths: fp32 K1 within _TOLS, K1s K1's
    # bits and its saved/raw within _SPILL_TOL, K2 the per-gradient rule
    # against fp64 on its own inputs; bf16 K1 and K1s the same bits, K1's
    # outputs, K1s' saved layers and K2's gradients by the bf16 rule
    kp, args, cot = _degree_level(cuda, degrees, 256, S)
    white = S == 65
    before = (fr.launches, ft.fwd_launches, ft.launches) if not dot_bf16 else \
        (fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches)
    k1 = fr.fused_render_level(kp, *args, white, dot_bf16=dot_bf16)
    k1s = ft.fused_level_fwd_spill(kp, *args, white, dot_bf16=dot_bf16)
    got = ft.fused_level_bwd_saved(kp, *args, k1s[4], k1s[5], *cot, white, dot_bf16=dot_bf16)
    torch.cuda.synchronize()
    after = (fr.launches, ft.fwd_launches, ft.launches) if not dot_bf16 else \
        (fr.bf16_launches, ft.bf16_fwd_launches, ft.bf16_launches)
    assert after == tuple(b + 1 for b in before)
    for name, a, b in zip(rule.OUTPUTS, k1, k1s):
        assert torch.equal(a, b), name  # K1s gives K1's bits
    args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in args))
    cot64 = tuple(c.double() for c in cot)
    if not dot_bf16:
        want = ft.fused_level_fwd_spill_ref(kp, *args, white)
        for name, g, w in zip(rule.OUTPUTS, k1, want):
            assert torch.isfinite(g).all() and (g - w).abs().max().item() <= _TOLS[name], name
        for name, g, w in zip(("saved", "raw"), k1s[4:], want[4:]):
            assert (g - w).abs().max().item() <= _SPILL_TOL, name
        # K2 on its own inputs: against the plain backward in fp64 from the
        # same saved and raw, its limit from the fp32 plain backward's error
        # on them (K1s is held above; chip_smoke.py phase 27 says why the
        # composition's form is printed there, not held)
        saved, raw = k1s[4], k1s[5]
        p32 = ft.fused_level_bwd_saved_ref(kp, *args, saved, raw, *cot, white)
        p64 = ft.fused_level_bwd_saved_ref(*args64, saved.double(), raw.double(), *cot64, white)
        for name in fr.WEIGHT_NAMES:
            assert got[name].shape == p64[name].shape and torch.isfinite(got[name]).all(), name
            tol = max(_GRAD_TOL, _GRAD_FACTOR * _rel_err(p32[name], p64[name]))
            assert _rel_err(got[name], p64[name]) <= tol, name
        return
    *p64, p64_saved, _ = ft.fused_level_fwd_spill_ref(*args64, white, dot_bf16=True)
    orders = {k: dict(zip(rule.OUTPUTS, fr.fused_render_level_ref(kp, *args, white, mm=mm, dot_bf16=True)))
              for k, mm in rule.BF16_ORDERS.items()}
    ratios = _bf16_ratios(dict(zip(rule.OUTPUTS, k1)), orders, dict(zip(rule.OUTPUTS, p64)), rule.TOL_BF16_FWD)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    orders = {k: rule.saved_layers(ft.fused_level_fwd_spill_ref(kp, *args, white, mm=mm, dot_bf16=True)[4])
              for k, mm in rule.BF16_ORDERS.items()}
    ratios = _bf16_ratios(rule.saved_layers(k1s[4]), orders, rule.saved_layers(p64_saved), rule.TOL_BF16_FWD)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    orders = {k: rule.bf16_k2_plain((kp, *args), cot, white, mm=mm) for k, mm in rule.BF16_ORDERS.items()}
    p64 = ft.fused_level_bwd_ref(*args64, *cot64, white, dot_bf16=True)
    ratios = _bf16_ratios(got, orders, p64, rule.TOL_BF16_GRAD)
    assert all(r <= 1.0 for r in ratios.values()), ratios


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("widths", list(_DEGREE_WIDTHS))
def test_degrees_kernels_keep_a_planted_xenc_nan(cuda, widths, dot_bf16):
    lo, hi, view = _DEGREE_WIDTHS[widths]
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(65), device=cuda, min_deg_point=lo, max_deg_point=hi,
                  deg_view=view)
    _planted_nan_case(cuda, 65, "xenc 0x7fffffff", dot_bf16, mlp)


def test_degrees_tile_rule_takes_what_the_block_holds(cuda):
    # at 75 / 39 the xs tile's K pads to 96: a forward block of 16 rays of
    # 193 samples needs 232,832 bytes, more than the H100's 232,448, so the
    # tile rule takes 8 at 2048 rays; 16 still fits at 65 samples and at 51 / 15
    for widths, S, tile in (("75/39", 193, 8), ("75/39", 65, 16), ("51/15", 193, 16)):
        kp, args, _ = _degree_level(cuda, _DEGREE_WIDTHS[widths], 2048, S)
        assert (fr.forward_smem_bytes(S, 16, fr.widths(kp)[0]) > fr.H100_SMEM_PER_BLOCK) == (tile == 8)
        k1 = fr.fused_render_level(kp, *args, True)
        k1s = ft.fused_level_fwd_spill(kp, *args, True)
        assert fr.launch_tiles[(2048, S, False)] == ft.fwd_tiles[(2048, S, False)] == tile
        assert all(torch.equal(a, b) for a, b in zip(k1, k1s))
        if tile == 8:
            with pytest.raises(RuntimeError, match="launch failed"):
                fr.fused_render_level(kp, *args, True, ray_tile=16)
            at4 = fr.fused_render_level(kp, *args, True, ray_tile=4)  # a row's outputs do not depend on the tile
            assert all(torch.equal(a, b) for a, b in zip(k1, at4))


def _ddp_config(root, out, name):
    """The vanilla NeRF at full width (8x256, 64 + 128 samples) on a 16x12
    scene, batch 64: two fp32 ray tiles a rank at 2 ranks."""
    return {"root_dir": root, "output_path": out, "exp_name": name, "img_wh": [16, 12], "num_coarse_samples": 64,
            "num_fine_samples": 128, "batch_size": 64, "chunk": 64, "lr_init": 1e-3, "lr_delay_steps": 0,
            "inner_steps": 1, "val_every_steps": 6, "ckpt_every_steps": 6, "limit_val_batches": 1, "seed": 0}


def _ddp_scene(tmp_path):
    from aonerf_torch.data.synthetic import generate_single_scene

    return generate_single_scene(str(tmp_path / "scene"), img_wh=(16, 12), n_train=2, n_val=1, n_test=3)


def test_ddp_one_rank_under_nccl_is_the_one_device_trainer(cuda, tmp_path):
    # chip_smoke.py phase 28's first check at a smaller size
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    root, out = _ddp_scene(tmp_path), str(tmp_path / "out")
    got = rule.run_dp(1, None, [("fit", "dp_fit", {"cfg": _ddp_config(root, out, "nccl1"), "max_steps": 4,
                                                   "params": True})])[0]["fit"]
    ref = Trainer(load_config(None, _ddp_config(root, out, "plain")))
    try:
        ref.fit(max_steps=4)
        np.testing.assert_array_equal(got["params"], rule.flat_params(ref.state.params.values()))
    finally:
        ref.close()
    assert got["launches"][1:] == (2 * 4, 2 * 4)  # K1s and K2, both levels of every step


def test_ddp_two_ranks_sharing_the_card_fit_test_and_meet_k2s_rule(cuda, tmp_path):
    # phase 28's two-rank checks at a smaller size: each rank's K2 by its
    # per-gradient rule against the fp64 backward of its own K1s saved, the
    # all-reduced gradient within DP_ULPS of the fp64 sum of the shares
    # (dp_first_step raises otherwise), the parameters equal on both ranks
    # after every step, test() gathered equal to one device's bit for bit
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    root, out = _ddp_scene(tmp_path), str(tmp_path / "out")
    cfg = _ddp_config(root, out, "two")
    two = rule.run_dp(2, "cuda:0", [("first", "dp_first_step", {"cfg": _ddp_config(root, out, "first")}),
                                    ("fit", "dp_fit", {"cfg": cfg, "max_steps": 6}),
                                    ("test", "dp_test", {"cfg": cfg})])
    for res in two:
        assert res["first"]["reduce_ulps"] <= rule.DP_ULPS and all(x["ratio"] <= 1 for x in res["first"]["k2"])
        assert res["fit"]["checked"] == 6 and res["fit"]["step"] == 6
        k1, k1s, k2 = res["fit"]["launches"]
        assert k1 > 0 and k1s == k2 == 2 * 6  # validation through K1, every step through K1s and K2
        assert res["test"]["launches"][0] > 0 and res["test"]["launches"][1:] == (0, 0)
    one = Trainer(load_config(None, {**cfg, "run_eval": True}))
    try:
        rgbs, depths, accs, _, _ = one.render_test_views()
    finally:
        one.close()
    for k, want in (("rgb", rgbs), ("depth", depths), ("acc", accs)):
        np.testing.assert_array_equal(two[0]["test"][k], want, err_msg=k)


def test_ddp_dryrun_on_one_card(cuda):
    from aonerf_torch.entry import dryrun_multichip

    assert dryrun_multichip(2, platform="cuda:0").startswith("dryrun_multichip ok: mesh=(2x1) on cuda:0")
