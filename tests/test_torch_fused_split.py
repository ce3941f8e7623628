"""The split of the training level into K1s (the forward that saves the
activations) and the backward from what it saved, on the CPU through the
plain versions: K1s' outputs against K1's and aonerf's Pallas forward in
interpret mode, its saved columns against the MLP's own layers, the two
halves composed against the whole backward, and gradients through
``FusedLevel`` against aonerf's ``make_fused_level`` in interpret mode. The
kernels themselves are held against these plain versions in
tests/test_torch_gpu.py, on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf.ops import encoding as jenc
from aonerf.ops.kernels import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf.ops.kernels.fused_train import make_fused_level
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from aonerf_torch.utils.bridge import mlp_state_dict_from_flax

torch.set_num_threads(1)

OUTPUTS = ("comp", "acc", "depth", "weights")
# The port's plain forward against the Pallas kernel in interpret mode: both
# fp32, other summation orders (tests/test_torch_kernels.py's tolerances).
FWD_TOL = {"comp": 2e-6, "acc": 2e-6, "weights": 2e-6, "depth": 2e-5}


def _level(R, S, seed):
    """A level's inputs (numpy), flax params with live densities, and
    cotangents of its four outputs."""
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


def _torch_mlp(params):
    mlp = NeRFMLP(device="cpu")
    mlp.load_state_dict(mlp_state_dict_from_flax(params))
    return mlp


def _kp(params):
    with torch.no_grad():
        return fr.kernel_params(_torch_mlp(params))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("R,S", [(8, 5), (16, 9)])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_fwd_spill_matches_k1_and_pallas_interpret(R, S, white_bkgd):
    params, inputs, _ = _level(R, S, seed=S + white_bkgd)
    kp, args = _kp(params), _torch(inputs)
    got = ft.fused_level_fwd_spill(kp, *args, white_bkgd, ray_tile=4)
    assert len(got) == 6
    comp, acc, depth, weights, saved, raw = got
    assert saved.shape == (R * S, ft.SAVED_FLOATS) and raw.shape == (R * S, 4)
    k1 = fr.fused_render_level_ref(kp, *args, white_bkgd)
    for name, g, w in zip(OUTPUTS, got[:4], k1):
        assert torch.equal(g, w), name
    want = jax_fused_render_level(
        mlp_params_from_flax(params), *map(jnp.asarray, inputs), white_bkgd, ray_tile=4, interpret=True,
    )
    for name, g, w in zip(OUTPUTS, got[:4], want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL[name], rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_saved_columns_are_the_mlp_activations(seed):
    """saved holds h0..h7 (256 each), the bottleneck (256) and the view hidden
    layer (128), raw the raw sigma and rgb, each as the MLP's own layers
    compute them (nn.Linear on the concatenated skip and view inputs, so
    other summation orders: 1e-5 of each block's largest entry)."""
    R, S = 8, 5
    params, inputs, _ = _level(R, S, seed=seed)
    mlp = _torch_mlp(params)
    t, o, d, venc, xenc = _torch(inputs)
    layers = [f"pts_{i}" for i in range(8)] + ["bottleneck", "views_0"]
    seen = {}
    hooks = [getattr(mlp, n).register_forward_hook(lambda m, i, out, n=n: seen.__setitem__(n, out))
             for n in layers]
    with torch.no_grad():
        raw_rgb, raw_density = mlp(xenc.reshape(R, S, -1), venc)
        *_, saved, raw = ft.fused_level_fwd_spill(fr.kernel_params(mlp), t, o, d, venc, xenc, True, ray_tile=4)
    for h in hooks:
        h.remove()
    cols = [256] * 9 + [128]
    starts = np.cumsum([0] + cols)
    for n, a, b in zip(layers, starts[:-1], starts[1:]):
        want = seen[n] if n == "bottleneck" else torch.relu(seen[n])
        scale = want.abs().max().item() + 1e-8
        np.testing.assert_allclose(saved[:, a:b].numpy() / scale, want.numpy() / scale, atol=1e-5, err_msg=n)
    assert starts[-1] == ft.SAVED_FLOATS
    for name, got, want in (("sigma", raw[:, :1], raw_density), ("rgb", raw[:, 1:], raw_rgb)):
        want = want.reshape(R * S, -1)
        scale = want.abs().max().item() + 1e-8
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bwd_saved_after_fwd_spill_is_the_whole_backward(white_bkgd):
    R, S = 8, 9
    params, inputs, cot = _level(R, S, seed=7 + white_bkgd)
    kp, args, cot = _kp(params), _torch(inputs), _torch(cot)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, white_bkgd, ray_tile=4)
    split = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, white_bkgd, ray_tile=4)
    whole = ft.fused_level_bwd_ref(kp, *args, *cot, white_bkgd)
    composed = ft.fused_level_bwd(kp, *args, *cot, white_bkgd, ray_tile=4)
    for n in fr.WEIGHT_NAMES:
        assert split[n].shape == kp[n].shape, n
        assert torch.equal(split[n], whole[n]) and torch.equal(composed[n], whole[n]), n
    # and against autograd through the plain forward: both fp32, other
    # orders; 1e-4 of each gradient's largest entry (tests/test_kernels.py)
    leaves = {n: v.clone().requires_grad_(True) for n, v in kp.items()}
    outs = fr.fused_render_level_ref(leaves, *args, white_bkgd)
    loss = sum(torch.sum(a * b) for a, b in zip(outs, cot))
    want = torch.autograd.grad(loss, [leaves[n] for n in fr.WEIGHT_NAMES])
    for n, w in zip(fr.WEIGHT_NAMES, want):
        scale = w.abs().max().item() + 1e-8
        np.testing.assert_allclose(split[n].numpy() / scale, w.numpy() / scale, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_fused_level_grads_match_jax_make_fused_level(white_bkgd):
    R, S = 16, 9
    params, inputs, cot = _level(R, S, seed=11 + white_bkgd)
    jkp = mlp_params_from_flax(params)
    level = make_fused_level(white_bkgd, ray_tile=4, interpret=True)
    jout, vjp = jax.vjp(lambda p: level(p, *map(jnp.asarray, inputs)), jkp)
    (jgrad,) = vjp(tuple(map(jnp.asarray, cot)))

    leaves = {n: v.clone().requires_grad_(True) for n, v in _kp(params).items()}
    fwd, bwd = ft.fwd_launches, ft.launches
    outs = ft.fused_level(leaves, *_torch(inputs), white_bkgd, ray_tile=4)
    loss = sum(torch.sum(a * b) for a, b in zip(outs, _torch(cot)))
    loss.backward()
    assert (ft.fwd_launches, ft.launches) == (fwd, bwd)  # the CPU runs the plain versions
    for name, g, w in zip(OUTPUTS, outs, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=FWD_TOL[name], rtol=0, err_msg=name)
    # both fp32, other summation orders: 1e-4 of each gradient's largest
    # entry, as tests/test_torch_fused_train.py holds K2's plain version
    for n in fr.WEIGHT_NAMES:
        w = np.asarray(jgrad[n])
        scale = np.max(np.abs(w)) + 1e-8
        np.testing.assert_allclose(leaves[n].grad.numpy() / scale, w / scale, atol=1e-4, err_msg=n)


def test_fused_level_drops_what_it_saved_after_backward():
    params, inputs, _ = _level(8, 5, seed=3)
    leaves = {n: v.clone().requires_grad_(True) for n, v in _kp(params).items()}
    comp, acc, depth, weights = ft.fused_level(leaves, *_torch(inputs), True, ray_tile=4)
    node = comp.grad_fn
    assert node.saved_acts.shape == (8 * 5, ft.SAVED_FLOATS) and node.raw.shape == (8 * 5, 4)
    (comp.sum() + acc.sum()).backward()
    assert node.saved_acts is None and node.raw is None
    assert all(leaves[n].grad is not None for n in fr.WEIGHT_NAMES)


def test_cpu_calls_count_no_launch():
    params, inputs, cot = _level(8, 5, seed=0)
    kp, args, cot = _kp(params), _torch(inputs), _torch(cot)
    before = (fr.launches, ft.fwd_launches, ft.launches)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, False, ray_tile=4)
    ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, False, ray_tile=4)
    ft.fused_level_bwd(kp, *args, *cot, False, ray_tile=4)
    assert (fr.launches, ft.fwd_launches, ft.launches) == before


def test_split_rejects_a_ray_count_off_the_tile():
    params, inputs, cot = _level(8, 5, seed=0)
    kp, args, cot = _kp(params), _torch(inputs), _torch(cot)
    with pytest.raises(ValueError, match="ray_tile"):
        ft.fused_level_fwd_spill(kp, *args, True, ray_tile=3)
    *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True, ray_tile=4)
    with pytest.raises(ValueError, match="ray_tile"):
        ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, ray_tile=3)
