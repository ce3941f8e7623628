"""Port parity of the fused level's bf16 mode (the TPU kernels' dot_bf16):
the plain bf16 forward of aonerf_torch against aonerf's Pallas kernel with
dot_bf16=True in interpret mode on the CPU, the rounding itself, the
weights the kernels take in that mode, and the distance to flax's bf16
NeRF. The CUDA kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 13)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aonerf.models import NeRF as JaxNeRF
from aonerf.ops.kernels import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from aonerf_torch.utils.bridge import nerf_state_dict_from_flax
from tests.test_torch_kernels import _setup, _torch_mlp

torch.set_num_threads(1)

OUTPUTS = ("comp", "acc", "depth", "weights")
# The plain bf16 forward against the Pallas kernel with dot_bf16=True, both
# summing bf16 operands in fp32 in other orders: where a sum lands within an
# fp32 rounding of a bf16 tie the two round an activation to neighbouring
# bf16 values, and the level carries that on. Measured at R=8 (max abs err):
# seed S, S=9: comp 2.7e-5, acc 1.2e-7, depth 2.4e-7, weights 6.0e-8; S=65:
# 3.3e-5, 5.8e-5, 3.0e-4, 2.6e-5 (both backgrounds). At seed S+1, up to
# 1.5e-4, 7.4e-5, 2.0e-4, 7.4e-5. The two controls below miss each of these:
# the fp32 plain version (3.7e-4 / 3.3e-4 / 2.0e-3 / 2.7e-4 at the least) and
# a bf16 one that leaves the log terms of the transmittance unrounded
# (2.3e-4 / 3.3e-4 / 1.8e-3 / 1.8e-4 at the least), which the TPU kernel's
# triangular product rounds.
BF16_TOL = {"comp": 1e-4, "acc": 2e-4, "depth": 1e-3, "weights": 8e-5}


def _inputs(params, t, o, d, venc, xenc):
    with torch.no_grad():
        kp = fr.kernel_params(_torch_mlp(params))
    return kp, [torch.from_numpy(a) for a in (t, o, d, venc, xenc)]


def _errors(got, want):
    return {n: float(np.max(np.abs(np.asarray(g) - np.asarray(w)))) for n, g, w in zip(OUTPUTS, got, want)}


def test_round_bf16_is_to_nearest_ties_to_even():
    one = 1.0
    ulp = 2.0 ** -7  # bf16's at 1
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2), one + ulp / 2 + 2.0 ** -20])
    want = torch.tensor([one, one + 2 * ulp, -one, one + ulp])
    assert torch.equal(fr.round_bf16(x), want)  # ties to even; away from zero would give 1 + ulp twice
    assert np.array_equal(np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(jnp.float32)), want.numpy())
    assert fr.round_bf16(x.double()).dtype == torch.float64


def test_bf16_params_round_the_weights_only():
    params, *_ = _setup()
    kp, _ = _inputs(params, *_setup()[1:])
    got = fr.bf16_params(kp)
    for n in fr.WEIGHT_NAMES:
        if n.startswith("w"):
            assert torch.equal(got[n], fr.round_bf16(kp[n])), n
            assert not torch.equal(got[n], kp[n]), n
        else:
            assert got[n] is kp[n], n
    wt = fr.unpack_weights_t(fr.kernel_weights_t(got))
    for name, view in wt.items():  # what the forward kernels stream: bf16 values, the pad column 0
        assert torch.equal(fr.round_bf16(view), view), name
    assert not wt["w0"][:, 63].any() and not wt["w5i"][:, 63].any()


@pytest.mark.parametrize("S", [9, 65])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bf16_ref_matches_pallas_interpret(S, white_bkgd):
    params, t, o, d, venc, xenc = _setup(R=8, S=S, seed=S)
    want = jax_fused_render_level(
        mlp_params_from_flax(params), jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(venc), jnp.asarray(xenc), white_bkgd, ray_tile=4, interpret=True, dot_bf16=True,
    )
    kp, args = _inputs(params, t, o, d, venc, xenc)
    got = fr.fused_render_level(kp, *args, white_bkgd, ray_tile=4, dot_bf16=True)
    for name, g, w in zip(OUTPUTS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
    errs = _errors(got, want)
    assert all(errs[n] <= BF16_TOL[n] for n in OUTPUTS), errs

    fp32 = _errors(fr.fused_render_level(kp, *args, white_bkgd, ray_tile=4), want)
    _, raw_sigma, raw_rgb = fr.level_activations_ref(kp, args[3], args[4].reshape(8 * S, -1), S, dot_bf16=True)
    log_unrounded = _errors(fr.integrate_ref(raw_sigma, raw_rgb, args[0], args[2], white_bkgd), want)
    for control in (fp32, log_unrounded):
        assert all(control[n] > BF16_TOL[n] for n in OUTPUTS), control


def test_cpu_bf16_call_counts_no_launch():
    params, t, o, d, venc, xenc = _setup(R=8)
    kp, args = _inputs(params, t, o, d, venc, xenc)
    before = (fr.launches, fr.bf16_launches)
    fr.fused_render_level(kp, *args, True, ray_tile=4, dot_bf16=True)
    assert (fr.launches, fr.bf16_launches) == before


def test_mlp_refuses_other_compute_dtypes():
    assert NeRFMLP(device="cpu", compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        NeRFMLP(device="cpu", compute_dtype=torch.float16)


def _xenc_ties(xenc: torch.Tensor) -> torch.Tensor:
    """Each value moved exactly halfway between its bf16 value and the next
    one up in magnitude (chip_smoke.py's tie_check)."""
    return (fr.round_bf16(xenc).view(torch.int32) + 0x8000).view(torch.float32)


def _round_ties_away(x: torch.Tensor) -> torch.Tensor:
    """bf16 rounding to nearest with ties away from zero."""
    bits = x.view(torch.int32)
    return ((bits + 0x8000) & ~0xFFFF).view(torch.float32)


def test_tie_inputs_tell_the_rounding_modes_apart():
    """chip_smoke.py's tie check: on encoded inputs at exact bf16 ties, h0
    rounded to even and h0 from inputs rounded away from zero differ on far
    more than TIE_SHARE of its elements; h0 summed in fp64 (another order)
    differs on far fewer."""
    params, t, o, d, venc, xenc = _setup(R=8, S=65, seed=2)
    kp, _ = _inputs(params, t, o, d, venc, xenc)
    xe = _xenc_ties(torch.from_numpy(xenc).reshape(8 * 65, -1))
    w0, b0 = fr.round_bf16(kp["w0"]), kp["b0"]

    def h0(x, mm=torch.matmul):
        return fr.round_bf16(torch.relu(mm(x, w0) + b0))

    even = h0(fr.round_bf16(xe))
    away = h0(_round_ties_away(xe))
    fp64 = h0(fr.round_bf16(xe), mm=lambda a, b: (a.double() @ b.double()).float())
    share_away = (even != away).double().mean().item()
    share_order = (even != fp64).double().mean().item()
    assert share_away > 4 * chip_smoke.TIE_SHARE, share_away
    assert share_order < chip_smoke.TIE_SHARE / 4, share_order
    # the plain K1s saves exactly this h0 in bf16 mode
    args = [torch.from_numpy(a) for a in (t, o, d, venc)] + [xe]
    saved = ft.fused_level_fwd_spill(kp, *args, True, ray_tile=4, dot_bf16=True)[4]
    assert saved.dtype == torch.bfloat16 and torch.equal(saved[:, :256].float(), even)


def test_distance_to_flax_bf16_nerf():
    """The port's bf16 level is the kernels' function, which rounds only the
    products' operands; flax's NeRF(compute_dtype=bfloat16), the JAX
    Trainer's bf16, also rounds each product's output and the bias add after
    it. Measured here, not asserted equal (R=16, 64+128 samples, seed 0):
    printed with -s; within 5e-2 on rgb, and farther from the port than the
    Pallas kernel's bf16 mode is."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": (-4.0 * d).astype(np.float32), "rays_d": d, "viewdirs": d}
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    flax_bf16 = JaxNeRF(num_coarse_samples=64, num_fine_samples=128, compute_dtype=jnp.bfloat16)
    params = flax_bf16.init(jax.random.PRNGKey(0), jrays, False, True, 2.0, 6.0)
    params = jax.tree_util.tree_map(np.array, params)
    for m in ("coarse_mlp", "fine_mlp"):  # live densities
        params["params"][m]["density"]["bias"] = params["params"][m]["density"]["bias"] + 0.3
    want = [np.asarray(lvl[0], np.float32) for lvl in flax_bf16.apply(params, jrays, False, True, 2.0, 6.0)]
    want32 = [np.asarray(lvl[0]) for lvl in JaxNeRF(num_coarse_samples=64, num_fine_samples=128).apply(
        params, jrays, False, True, 2.0, 6.0)]
    from aonerf.ops.kernels.fused_train import fused_nerf_forward as jax_fused_nerf_forward
    kernel = [np.asarray(lvl[0]) for lvl in jax_fused_nerf_forward(
        params, jrays, True, 2.0, 6.0, num_coarse_samples=64, num_fine_samples=128, randomized=False,
        ray_tile_coarse=16, ray_tile_fine=16, interpret=True, dot_bf16=True)]
    nerf = NeRF(num_coarse_samples=64, num_fine_samples=128, device="cpu", compute_dtype=torch.bfloat16)
    nerf.load_state_dict(nerf_state_dict_from_flax(params))
    with torch.no_grad():
        got = [lvl[0].numpy() for lvl in ft.fused_nerf_forward(
            nerf.coarse_mlp, nerf.fine_mlp, {k: torch.from_numpy(v) for k, v in rays.items()}, False, True, 2.0,
            6.0, 64, 128, level=functools.partial(fr.fused_render_level, ray_tile=16), dot_bf16=True)]
    for i, name in enumerate(("coarse", "fine")):
        to_flax = float(np.max(np.abs(got[i] - want[i])))
        to_kernel = float(np.max(np.abs(got[i] - kernel[i])))
        flax_gap = float(np.max(np.abs(want[i] - want32[i])))
        print(f"{name} rgb, max abs: port bf16 vs flax bf16 {to_flax:.3e}, vs the Pallas bf16 mode "
              f"{to_kernel:.3e}; flax bf16 vs flax fp32 {flax_gap:.3e}")
        assert to_kernel < to_flax < 5e-2, (name, to_kernel, to_flax)
