"""The 3xTF32 arithmetic of the forward kernels (K1 and K1s), emulated on the
CPU, and the transposed weight copies the kernels read.

K1 and K1s (``csrc/nerf_level.cuh``) run every 256- and 128-wide product of
the level's MLP on mma.sync TF32 with 3xTF32 compensation, reading each
product weight from a transposed copy (``fused_render.kernel_weights_t``).
Here the plain forward runs with its products through the emulation of that
arithmetic from ``tests/test_torch_tf32.py``, and each output (comp, acc,
depth, weights and the ten saved activations) is held against the plain
version in fp64 by the card's rule (``chip_smoke.py`` phase 3): its max abs
error / max |fp64| within max(1e-6, 4 x the fp32 plain version's own). The
emulation rounds the split products' sums as fp32 does; the tensor cores
truncate as they accumulate, which the card's own checks cover
(``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf.ops import encoding as jenc
from aonerf.ops.kernels import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.utils.bridge import mlp_state_dict_from_flax
from tests.test_torch_tf32 import _level, matmul_1xtf32, matmul_3xtf32

TOL_FWD, TOL_FWD_FACTOR = 1e-6, 4.0  # as chip_smoke.py and tests/test_torch_gpu.py
OUTPUTS = ("comp", "acc", "depth", "weights")
SAVED = ("h0", "h1", "h2", "h3", "h4", "h5", "h6", "h7", "bottleneck", "view")


def _forward(kp, t, o, d, venc, xenc, white_bkgd, mm=torch.matmul):
    """comp, acc, depth, weights and the ten saved activations, by name."""
    R, S = t.shape
    acts, raw_sigma, raw_rgb = fr.level_activations_ref(kp, venc, xenc.reshape(R * S, -1), S, mm=mm)
    outs = fr.integrate_ref(raw_sigma, raw_rgb, t, d, white_bkgd)
    return dict(zip(OUTPUTS + SAVED, (*outs, *acts)))


def _rel_err(got, want64):
    return ((got.double() - want64).abs().max() / want64.abs().max().clamp_min(1e-300)).item()


def output_errors(S, white_bkgd, mm, R=16, seed=0):
    """Per output: (error of the mm run, its limit, error of fp32 plain)."""
    kp, args, _ = _level(R, S, seed + S)
    p64 = _forward({n: v.double() for n, v in kp.items()}, *(a.double() for a in args), white_bkgd)
    p32 = _forward(kp, *args, white_bkgd)
    got = _forward(kp, *args, white_bkgd, mm=mm)
    out = {}
    for n in OUTPUTS + SAVED:
        e32 = _rel_err(p32[n], p64[n])
        out[n] = (_rel_err(got[n], p64[n]), max(TOL_FWD, TOL_FWD_FACTOR * e32), e32)
    return out


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_3xtf32_forward_meets_the_fp32_limit(S, white_bkgd):
    errs = output_errors(S, white_bkgd, matmul_3xtf32)
    bad = {n: (e, tol) for n, (e, tol, _) in errs.items() if not e <= tol}
    assert not bad, f"outputs off fp64 beyond their limits (err, limit): {bad}"


@pytest.mark.parametrize("S", [65, 193])
def test_1xtf32_forward_misses_the_fp32_limit(S):
    """A silent 1xTF32 (one TF32 product, operands rounded to 2^-11) fails the
    rule on comp, depth, weights and every saved activation, by ~300x. acc
    is no witness here: it is 1 - the transmittance past the last sample,
    and these rays are opaque, so it is 1 to within fp32 rounding in any
    arithmetic."""
    errs = output_errors(S, True, matmul_1xtf32)
    passed = sorted(n for n, (e, tol, _) in errs.items() if e <= tol)
    assert passed in ([], ["acc"]), f"1xTF32 met the fp32 limit on {passed}"


def test_transposed_weights_are_the_kernel_params_transposed():
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(0), device="cpu")
    kp = fr.kernel_params(mlp)  # grad enabled: the copy must not carry it
    flat = fr.kernel_weights_t(kp)
    assert flat.shape == (fr.WT_FLOATS,) and flat.is_contiguous() and not flat.requires_grad
    views = fr.unpack_weights_t(flat)
    assert [(n, *v.shape) for n, v in views.items()] == list(fr.WEIGHTS_T)
    for name, w in views.items():
        k_in = kp[name].shape[0]
        assert torch.equal(w[:, :k_in], kp[name].detach().t()), name
        assert torch.equal(w[:, k_in:], torch.zeros_like(w[:, k_in:])), name  # w0, w5i: the pad column
    assert views["w0"].shape == views["w5i"].shape == (fr.WIDTH, fr.POS_PAD)


def test_padded_transposed_input_weights_give_the_same_product():
    """A @ copy^T == A @ w exactly for w0 and w5i, with a nonzero value in A's
    pad column. Small dyadic values make every sum exact in fp32, so the
    product is the same in any summation order."""
    g = torch.Generator().manual_seed(0)
    kp = {n: torch.randint(-8, 9, tuple(v.shape), generator=g).float() / 16
          for n, v in fr.kernel_params(NeRFMLP(generator=g, device="cpu")).items()}
    views = fr.unpack_weights_t(fr.kernel_weights_t(kp))
    a = torch.randint(-8, 9, (64, fr.POS_DIM), generator=g).float() / 16
    a_pad = torch.cat([a, torch.full((64, fr.POS_PAD - fr.POS_DIM), 3.0)], -1)
    for name in ("w0", "w5i"):
        assert torch.equal(a_pad @ views[name].t(), a @ kp[name]), name


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_3xtf32_forward_matches_pallas_interpret(white_bkgd):
    """At 8 rays x S=65 the emulated forward against aonerf's Pallas K1 in
    interpret mode, at tests/test_torch_kernels.py's tolerances."""
    R, S = 8, 65
    rng = np.random.default_rng(S)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    xenc = np.array(jenc.pos_enc(jnp.asarray(o[:, None] + t[..., None] * d[:, None]), 0, 10))
    venc = np.array(jenc.pos_enc(jnp.asarray(d), 0, 4))
    params = JaxNeRFMLP().init(jax.random.PRNGKey(S), jnp.asarray(xenc), jnp.asarray(venc))
    want = jax_fused_render_level(
        mlp_params_from_flax(params), jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(venc), jnp.asarray(xenc), white_bkgd, ray_tile=4, interpret=True,
    )
    mlp = NeRFMLP(device="cpu")
    mlp.load_state_dict(mlp_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = fr.fused_render_level_ref(
            fr.kernel_params(mlp), *(torch.from_numpy(x) for x in (t, o, d, venc, xenc)), white_bkgd,
            mm=matmul_3xtf32,
        )
    tols = {"comp": 2e-6, "acc": 2e-6, "weights": 2e-6, "depth": 2e-5}
    for name, g, w in zip(OUTPUTS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tols[name], rtol=0, err_msg=name)


def main() -> None:
    for name, mm in (("3xTF32", matmul_3xtf32), ("1xTF32", matmul_1xtf32)):
        for S in (65, 193):
            for white in (True, False):
                errs = output_errors(S, white, mm)
                over = sorted(n for n, (e, tol, _) in errs.items() if e > tol)
                worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
                e, tol, e32 = errs[worst]
                print(f"{name} 16 rays x S={S} white={white}: closest to its limit {worst} {e:.3e} of {tol:.3e} "
                      f"(fp32 plain {e32:.3e}); over the limit: {len(over)} of 14 {over}")


if __name__ == "__main__":
    main()
