"""Port parity of the training level's bf16 mode (the TPU kernels' dot_bf16)
on the CPU: K1s' saved layers against the activations the Pallas body keeps
in bf16, K2's 26 gradients against aonerf's Pallas backward with
dot_bf16=True in interpret mode, and the two-level loss and gradients
against aonerf's fused forward with dot_bf16=True. The CUDA kernels are held
against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 13)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops.kernels import mlp_params_from_flax
from aonerf.ops.kernels.fused_train import _dot, _fused_level_bwd_impl
from aonerf.ops.kernels.fused_train import fused_nerf_forward as jax_fused_nerf_forward
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from aonerf_torch.utils.bridge import nerf_flax_tree, nerf_state_dict_from_flax
from tests.test_torch_fused_train import _level, _torch_kp, _two_level_setup

torch.set_num_threads(1)

TILE = 4  # rays per Pallas grid step
LAYERS = [f"h{i}" for i in range(8)] + ["bottleneck", "view"]


@functools.partial(jax.jit, static_argnums=(3,))
def _kept_tile(w, xe, cond, S):
    """One grid step of the Pallas backward's forward recompute with bf16
    dots (``_bwd_kernel``, its own ``_dot``): h0..h7 as it keeps them (in
    bf16), the bottleneck and the view hidden layer rounded to bf16, and raw
    sigma and rgb."""
    keep = lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    hs = []
    x = jnp.maximum(_dot(xe, w["w0"], True) + w["b0"], 0.0)
    hs.append(keep(x))
    for i in (1, 2, 3, 4):
        x = jnp.maximum(_dot(x, w[f"w{i}"], True) + w[f"b{i}"], 0.0)
        hs.append(keep(x))
    x = jnp.maximum(_dot(x, w["w5x"], True) + _dot(xe, w["w5i"], True) + w["b5"], 0.0)
    hs.append(keep(x))
    for i in (6, 7):
        x = jnp.maximum(_dot(x, w[f"w{i}"], True) + w[f"b{i}"], 0.0)
        hs.append(keep(x))
    raw_sigma = _dot(hs[7], w["wd"], True) + w["bd"]
    btl = _dot(hs[7], w["wb"], True) + w["bb"]
    c_rows = jnp.repeat(_dot(cond, w["wvb"], True), S, axis=0)
    hv = jnp.maximum(_dot(btl, w["wva"], True) + c_rows + w["bv"], 0.0)
    raw_rgb = _dot(hv, w["wr"], True) + w["br"]
    return jnp.concatenate(hs + [keep(btl), keep(hv)], -1), jnp.concatenate([raw_sigma, raw_rgb], -1)


def _pallas_kept(params, venc, xenc, S):
    """(saved (R*S, 2432), raw (R*S, 4)) of the Pallas body, tile by tile."""
    w = {k: jnp.asarray(v) for k, v in mlp_params_from_flax(params).items()}
    xenc = xenc.reshape(-1, xenc.shape[-1])
    parts = [_kept_tile(w, jnp.asarray(xenc[r * S:(r + TILE) * S]), jnp.asarray(venc[r:r + TILE]), S)
             for r in range(0, venc.shape[0], TILE)]
    return (torch.from_numpy(np.concatenate([np.asarray(p[i]) for p in parts])) for i in (0, 1))


def _layers(saved):
    return {n: saved[:, 256 * i: 256 * i + (128 if n == "view" else 256)] for i, n in enumerate(LAYERS)}


# K1s' saved layers against the kept activations: both round fp32 sums of
# bf16 operands, summed in other orders, so an activation within an fp32
# rounding of a bf16 tie goes to the other neighbour, and the rows it feeds
# may follow. Measured at R=8 (seeds S, S+1, S+7): at most 6.3e-3 of a
# layer's elements differ (the bottleneck, S=65), by at most 4.6e-3 of the
# layer's largest entry. The fp32 plain version's saved layers differ on at
# least 0.44 of each layer's elements.
SAVED_SHARE, SAVED_REL = 2e-2, 1e-2


@pytest.mark.parametrize("S", [9, 65])
def test_saved_layers_match_pallas_kept(S):
    params, inputs, _ = _level(8, S, seed=S)
    t, o, d, venc, xenc = inputs
    kept, _ = _pallas_kept(params, venc, xenc, S)
    args = (_torch_kp(params), *map(torch.from_numpy, inputs))
    got = _layers(ft.fused_level_fwd_spill(*args, True, ray_tile=TILE, dot_bf16=True)[4])
    fp32 = _layers(ft.fused_level_fwd_spill(*args, True, ray_tile=TILE)[4])
    for name, want in _layers(kept).items():
        share = (got[name] != want).double().mean().item()
        rel = ((got[name] - want).abs().max() / want.abs().max()).item()
        assert share <= SAVED_SHARE and rel <= SAVED_REL, (name, share, rel)
        assert torch.equal(fr.round_bf16(got[name]), got[name]), name  # the rounded activations
        assert (fp32[name] != want).double().mean().item() > SAVED_SHARE, name  # the control


def _rel_errors(got, want):
    """Per gradient: max abs err / max |want|."""
    out = {}
    for n in fr.WEIGHT_NAMES:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        assert g.shape == w.shape, n
        out[n] = float(np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-30))
    return out


def _jax_bwd(params, inputs, cot, white_bkgd):
    return _fused_level_bwd_impl(mlp_params_from_flax(params), *map(jnp.asarray, inputs), *map(jnp.asarray, cot),
                                 white_bkgd, TILE, True, True)


# K2 (the backward from saved) from the Pallas body's own kept activations
# and raw against the Pallas backward with dot_bf16=True: the same masks and
# operands, but the integrator and the deltas summed in other fp32 orders, so
# a delta within an fp32 rounding of a bf16 tie is rounded the other way.
# Measured at R=8, S=65 (seeds 65-66 and 72-73): at most 3.2e-5 of a
# gradient's largest entry. Controls: the plain backward that rounds each
# delta to bf16 before a bias sums it (the TPU kernel sums fp32 deltas) is
# 8.2e-5 to 3.0e-3 off on every bias; the fp32 plain backward from the same
# saved activations is off on most gradients.
K2_TOL = 5e-5
BIASES = [n for n in fr.WEIGHT_NAMES if n.startswith("b")]


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_k2_from_kept_matches_pallas_interpret(white_bkgd, monkeypatch):
    S = 65
    params, inputs, cot = _level(8, S, seed=S + white_bkgd)
    want = _jax_bwd(params, inputs, cot, white_bkgd)
    saved, raw = _pallas_kept(params, inputs[3], inputs[4], S)
    args = (_torch_kp(params), *map(torch.from_numpy, inputs), saved, raw, *map(torch.from_numpy, cot), white_bkgd)
    # bf16 mode takes saved as bf16 (the kept activations are bf16 values)
    args16 = (*args[:6], saved.to(torch.bfloat16), *args[7:])
    errs = _rel_errors(ft.fused_level_bwd_saved(*args16, ray_tile=TILE, dot_bf16=True), want)
    assert all(v <= K2_TOL for v in errs.values()), errs

    fp32 = _rel_errors(ft.fused_level_bwd_saved(*args, ray_tile=TILE), want)
    assert sum(v > K2_TOL for v in fp32.values()) > len(fp32) // 2, fp32
    monkeypatch.setattr(ft, "bias_grad", lambda delta: fr.round_bf16(delta).sum(0, keepdim=True))
    rounded = _rel_errors(ft.fused_level_bwd_saved(*args16, ray_tile=TILE, dot_bf16=True), want)
    assert all(rounded[n] > K2_TOL for n in BIASES), rounded


# The whole bf16 level backward (K1s then K2) against the Pallas backward,
# which recomputes its forward: the forward's flips (see SAVED_SHARE) move
# whole rows, which R=8 rays magnify. Measured (seeds S+white and S+white+7,
# S=9 and 65): at most 4.2e-3 of a gradient's largest entry. The fp32 plain
# version is 0.04-0.6 off on most gradients.
COMPOSED_TOL = 1e-2


@pytest.mark.parametrize("S", [9, 65])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bf16_bwd_matches_pallas_interpret(S, white_bkgd):
    params, inputs, cot = _level(8, S, seed=S + white_bkgd)
    want = _jax_bwd(params, inputs, cot, white_bkgd)
    args = (_torch_kp(params), *map(torch.from_numpy, inputs), *map(torch.from_numpy, cot), white_bkgd)
    errs = _rel_errors(ft.fused_level_bwd(*args, ray_tile=TILE, dot_bf16=True), want)
    assert all(v <= COMPOSED_TOL for v in errs.values()), errs
    fp32 = _rel_errors(ft.fused_level_bwd(*args, ray_tile=TILE), want)
    assert sum(v > COMPOSED_TOL for v in fp32.values()) > len(fp32) // 2, fp32


def test_cpu_bf16_bwd_counts_no_launch():
    params, inputs, cot = _level(8, 9, seed=0)
    before = (ft.fwd_launches, ft.launches, ft.bf16_fwd_launches, ft.bf16_launches)
    ft.fused_level_bwd(_torch_kp(params), *map(torch.from_numpy, inputs), *map(torch.from_numpy, cot), True,
                       ray_tile=TILE, dot_bf16=True)
    assert (ft.fwd_launches, ft.launches, ft.bf16_fwd_launches, ft.bf16_launches) == before


# The two-level loss and its gradients through FusedLevel in bf16 mode
# against aonerf's fused forward with dot_bf16=True (Pallas forward and
# backward in interpret mode), randomized=False, 8 rays, 4+8 samples.
# Measured: the loss 5.8e-6 apart (relative); the leaves' errors (max abs
# err / max |JAX|) have a median of 8.9e-7 and reach 1.9e-2 (fine pts_4),
# where a rounding flip moves one of the 8 rays. The fp32 port is 1.8e-4
# apart on the loss, with a median leaf error of 0.10.
LOSS_RTOL, LEAF_MEDIAN, LEAF_MAX = 2e-5, 1e-4, 5e-2


def _two_level_errors(model, params, rays, target, dtype):
    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu", compute_dtype=dtype)
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    out = ft.fused_nerf_forward(  # NeRF.forward's levels at the 4-ray tile of R=8
        nerf.coarse_mlp, nerf.fine_mlp, {k: torch.from_numpy(v) for k, v in rays.items()}, False, True, 2.0, 6.0,
        4, 8, level=functools.partial(ft.fused_level, ray_tile=TILE), dot_bf16=dtype == torch.bfloat16,
    )
    loss = sum(torch.mean((lvl[0] - torch.from_numpy(target)) ** 2) for lvl in out)
    loss.backward()
    got = nerf_flax_tree(nerf, grads=True)["params"]
    errs = []
    for m in model:
        for layer in model[m]:
            for a in model[m][layer]:
                A, B = np.asarray(model[m][layer][a]), got[m][layer][a]
                errs.append(float(np.max(np.abs(A - B)) / (np.max(np.abs(A)) + 1e-8)))
    return loss.item(), np.asarray(errs)


def test_two_level_bf16_loss_and_grads_match_jax():
    model, params, rays, target = _two_level_setup()
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}

    def loss_fused(p):
        out = jax_fused_nerf_forward(
            p, jrays, True, 2.0, 6.0, key=None, num_coarse_samples=4, num_fine_samples=8,
            randomized=False, ray_tile_coarse=4, ray_tile_fine=4, interpret=True, dot_bf16=True,
        )
        return sum(jnp.mean((lvl[0] - target) ** 2) for lvl in out)

    want_loss, want = float(loss_fused(params)), jax.grad(loss_fused)(params)["params"]
    loss, errs = _two_level_errors(want, params, rays, target, torch.bfloat16)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    assert np.median(errs) <= LEAF_MEDIAN and errs.max() <= LEAF_MAX, (np.median(errs), errs.max())
    loss32, errs32 = _two_level_errors(want, params, rays, target, torch.float32)  # the control
    assert abs(loss32 - want_loss) > LOSS_RTOL * abs(want_loss) and np.median(errs32) > LEAF_MEDIAN
