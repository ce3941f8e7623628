"""CUDA kernels of aonerf_torch against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor aonerf, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest``.
"""

import numpy as np
import pytest
import torch

from aonerf_torch.eval.render import make_image_renderer
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import fused_render as fr

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


def _level_inputs(R, S, seed, device):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    t, o, d, pts = (torch.from_numpy(a).to(device) for a in (t, o, d, pts))
    return t, o, d, pos_enc(d, 0, 4), pos_enc(pts, 0, 10)


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


def test_kernel_rejects_what_it_does_not_take(cuda):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(0), device=cuda)
    kp = fr.kernel_params(mlp)
    t, o, d, venc, xenc = _level_inputs(64, 65, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render_level(kp, t.double(), o, d, venc, xenc, True)
    with pytest.raises(ValueError, match="shape"):
        fr.fused_render_level(kp, t, o, d, venc[:, :20], xenc, True)
    before = fr.launches
    with pytest.raises(RuntimeError, match="launch failed"):  # 64 x 65 needs 241 KB
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
