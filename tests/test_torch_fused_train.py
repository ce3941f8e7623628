"""Port parity: the level weight gradient (K2) and the differentiable
two-level forward of aonerf_torch against aonerf's Pallas backward, run in
interpret mode on the CPU as tests/test_kernels.py runs it. The CUDA kernel
itself is held against its plain version in tests/test_torch_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRF as JaxNeRF
from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf.ops import encoding as jenc
from aonerf.ops import sampling as jsamp
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf.ops.kernels.fused_train import _fused_level_bwd_impl
from aonerf.ops.kernels.fused_train import fused_nerf_forward as jax_fused_nerf_forward
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from aonerf_torch.utils.bridge import mlp_state_dict_from_flax, nerf_flax_tree, nerf_state_dict_from_flax

torch.set_num_threads(1)


def _level(R, S, seed):
    """A level's inputs, flax params with live densities, and cotangents."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    coords = o[:, None] + t[..., None] * d[:, None]
    xenc = np.array(jenc.pos_enc(jnp.asarray(coords), 0, 10))
    venc = np.array(jenc.pos_enc(jnp.asarray(d), 0, 4))
    params = JaxNeRFMLP().init(jax.random.PRNGKey(seed), jnp.asarray(xenc), jnp.asarray(venc))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["density"]["bias"] = params["params"]["density"]["bias"] + 0.5
    cot = (
        rng.standard_normal((R, 3)).astype(np.float32),
        rng.standard_normal(R).astype(np.float32),
        rng.standard_normal(R).astype(np.float32) * 0.1,
        rng.standard_normal((R, S)).astype(np.float32),
    )
    return params, (t, o, d, venc, xenc), cot


def _torch_kp(params):
    mlp = NeRFMLP(device="cpu")
    mlp.load_state_dict(mlp_state_dict_from_flax(params))
    with torch.no_grad():
        return fr.kernel_params(mlp)


def _assert_grads_close(got, want, what):
    """Each gradient within 1e-4 of its largest entry: both fp32, summed in
    other orders over R*S rows (the tolerance of tests/test_kernels.py)."""
    for name in fr.WEIGHT_NAMES:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, (what, name)
        scale = np.max(np.abs(w)) + 1e-8
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4, rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("S", [9, 65])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bwd_ref_matches_pallas_interpret(S, white_bkgd):
    params, inputs, cot = _level(8, S, seed=S + white_bkgd)
    want = _fused_level_bwd_impl(
        mlp_params_from_flax(params), *map(jnp.asarray, inputs), *map(jnp.asarray, cot),
        white_bkgd, 4, True, False,
    )
    got = ft.fused_level_bwd(
        _torch_kp(params), *map(torch.from_numpy, inputs), *map(torch.from_numpy, cot),
        white_bkgd, ray_tile=4,
    )
    _assert_grads_close(got, want, f"S={S} white={white_bkgd}")


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bwd_ref_matches_autograd(white_bkgd):
    params, inputs, cot = _level(8, 17, seed=3)
    kp = {n: v.clone().requires_grad_(True) for n, v in _torch_kp(params).items()}
    args = [torch.from_numpy(a) for a in inputs]
    outs = fr.fused_render_level_ref(kp, *args, white_bkgd)
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cot))
    want = dict(zip(fr.WEIGHT_NAMES, torch.autograd.grad(loss, [kp[n] for n in fr.WEIGHT_NAMES])))
    got = ft.fused_level_bwd_ref(kp, *args, *map(torch.from_numpy, cot), white_bkgd)
    _assert_grads_close({k: v.detach() for k, v in got.items()}, want, "autograd")


def _two_level_setup(R=8):
    rng = np.random.default_rng(0)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    target = rng.uniform(size=(R, 3)).astype(np.float32)
    rays = {"rays_o": o, "rays_d": d, "viewdirs": d}
    model = JaxNeRF(num_coarse_samples=4, num_fine_samples=8)
    params = model.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in rays.items()}, False, True, 2.0, 6.0)
    params = jax.tree_util.tree_map(np.array, params)
    for m in ("coarse_mlp", "fine_mlp"):  # live gradients at init
        params["params"][m]["density"]["bias"] = params["params"][m]["density"]["bias"] + 0.3
    return model, params, rays, target


def test_two_level_loss_and_grads_match_jax():
    model, params, rays, target = _two_level_setup()
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}

    def loss_ref(p):
        out = model.apply(p, jrays, False, True, 2.0, 6.0)
        return sum(jnp.mean((lvl[0] - target) ** 2) for lvl in out)

    def loss_fused(p):
        out = jax_fused_nerf_forward(
            p, jrays, True, 2.0, 6.0, key=None, num_coarse_samples=4, num_fine_samples=8,
            randomized=False, ray_tile_coarse=4, ray_tile_fine=4, interpret=True,
        )
        return sum(jnp.mean((lvl[0] - target) ** 2) for lvl in out)

    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    out = ft.fused_nerf_forward(
        nerf.coarse_mlp, nerf.fine_mlp, {k: torch.from_numpy(v) for k, v in rays.items()},
        False, True, 2.0, 6.0, 4, 8, level=functools.partial(ft.fused_level, ray_tile=4),
    )
    loss = sum(torch.mean((lvl[0] - torch.from_numpy(target)) ** 2) for lvl in out)
    loss.backward()
    got = nerf_flax_tree(nerf, grads=True)["params"]
    for name, fn in (("fused", loss_fused), ("xla", loss_ref)):
        # both fp32; rtol 1e-5 as tests/test_kernels.py holds the JAX pair
        np.testing.assert_allclose(loss.item(), float(fn(params)), rtol=1e-5, err_msg=name)
        want = jax.grad(fn)(params)["params"]
        for m in want:
            for layer in want[m]:
                for a in want[m][layer]:
                    A, B = np.asarray(want[m][layer][a]), got[m][layer][a]
                    scale = np.max(np.abs(A)) + 1e-8
                    np.testing.assert_allclose(
                        B / scale, A / scale, atol=1e-4, err_msg=f"{name}: {m}/{layer}/{a}"
                    )


def test_cpu_bwd_does_not_count_a_launch():
    params, inputs, cot = _level(8, 9, seed=0)
    before = ft.launches
    ft.fused_level_bwd(_torch_kp(params), *map(torch.from_numpy, inputs), *map(torch.from_numpy, cot), True, ray_tile=4)
    assert ft.launches == before


def test_cpu_bwd_saved_refuses_to_return_deltas():
    # B1's deltas come from the kernel's scratch; the plain version keeps none
    params, inputs, cot = _level(8, 9, seed=0)
    kp, args = _torch_kp(params), [torch.from_numpy(x) for x in inputs]
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True, ray_tile=4)
    with pytest.raises(ValueError, match="deltas"):
        ft.fused_level_bwd_saved(kp, *args, saved, raw, *map(torch.from_numpy, cot), True, ray_tile=4, deltas=True)


def test_padded_offsets_align_every_gradient():
    shapes = [tuple(v.shape) for v in _torch_kp(_level(4, 3, 0)[0]).values()]
    offsets = ft._padded_offsets(shapes)
    assert all(o % 4 == 0 for o in offsets)
    sizes = [int(np.prod(s)) for s in shapes]
    assert sum(sizes) == 595844  # the 26 weights of one level
    assert offsets[-1] - sum(sizes) < 4 * len(shapes)
