"""The 3xTF32 arithmetic of K2's tensor-core passes, emulated on the CPU.

K2 (``csrc/fused_train.cu``) runs every dW and every delta . W^T of the level
backward on mma.sync TF32 with 3xTF32 compensation: each fp32 operand x is
split as big = tf32(x), small = tf32(x - big), and small.big + big.small +
big.big accumulate in fp32. Here ``fused_level_bwd_ref`` runs with its
products through an emulation of that arithmetic, and each gradient is held
against the plain version in fp64 by the card's own rule: within
max(1e-4, 4 x the fp32 plain version's error) of max |fp64|.

    PYTHONPATH=. python tests/test_torch_tf32.py   # prints the table, 3xTF32 and 1xTF32
"""

import numpy as np
import pytest
import torch

from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft

TOL_GRAD, TOL_GRAD_FACTOR = 1e-4, 4.0  # as chip_smoke.py and tests/test_torch_gpu.py


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero. On the int32 view: half a TF32
    ulp added to the magnitude, the 13 low bits cleared. Finite x only."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_round(x)
    return big, tf32_round(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it: the small terms first, then big.big."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_round(a) @ tf32_round(b)


def _level(R, S, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    t, o, d, pts = (torch.from_numpy(a) for a in (t, o, d, pts))
    args = (t, o, d, pos_enc(d, 0, 4), pos_enc(pts, 0, 10))
    cot = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S))))
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        kp = {n: v.clone() for n, v in fr.kernel_params(mlp).items()}
    kp["bd"] += 0.5  # live densities at init
    return kp, args, cot


def _rel_err(got, want64):
    return ((got.double() - want64).abs().max() / want64.abs().max().clamp_min(1e-300)).item()


def grad_errors(S, white_bkgd, mm, R=16, seed=0):
    """Per gradient: (error of the mm run, its limit, error of fp32 plain),
    errors as max abs err / max |fp64 plain|."""
    kp, args, cot = _level(R, S, seed + S)
    p64 = ft.fused_level_bwd_ref(
        {n: v.double() for n, v in kp.items()}, *(a.double() for a in args), *(c.double() for c in cot), white_bkgd
    )
    p32 = ft.fused_level_bwd_ref(kp, *args, *cot, white_bkgd)
    got = ft.fused_level_bwd_ref(kp, *args, *cot, white_bkgd, mm=mm)
    out = {}
    for n in fr.WEIGHT_NAMES:
        e32 = _rel_err(p32[n], p64[n])
        out[n] = (_rel_err(got[n], p64[n]), max(TOL_GRAD, TOL_GRAD_FACTOR * e32), e32)
    return out


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 ulp at 1
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, 1 + ulp + ulp / 2, -(1 + ulp / 2), 3e-39])
    want = torch.tensor([1.0, 1.0, 1 + ulp, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 0.0])
    got = tf32_round(x)
    want[-1] = got[-1]  # subnormal: only the low bits must be cleared
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_keeps_fp32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    big, small = split_tf32(x)
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    assert ((big - x).abs() / x.abs()).max().item() > 2.0 ** -13  # 1xTF32 alone is coarse


def test_3xtf32_matmul_is_fp32_accurate_and_1xtf32_is_not():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32))
    want = a.double() @ b.double()
    scale = want.abs().max().item()
    e32 = (a @ b - want).abs().max().item() / scale
    e3 = (matmul_3xtf32(a, b) - want).abs().max().item() / scale
    e1 = (matmul_1xtf32(a, b) - want).abs().max().item() / scale
    assert e3 <= 4 * e32 + 1e-7, (e3, e32)
    assert e1 > 30 * e3, (e1, e3)


@pytest.mark.parametrize("S", [65, 193])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_3xtf32_products_meet_the_per_gradient_limits(S, white_bkgd):
    errs = grad_errors(S, white_bkgd, matmul_3xtf32)
    bad = {n: (e, tol) for n, (e, tol, _) in errs.items() if not e <= tol}
    assert not bad, f"gradients off fp64 beyond their limits (err, limit): {bad}"


def main() -> None:
    for name, mm in (("3xTF32", matmul_3xtf32), ("1xTF32", matmul_1xtf32)):
        for S in (65, 193):
            for white in (True, False):
                errs = grad_errors(S, white, mm)
                over = sorted(n for n, (e, tol, _) in errs.items() if e > tol)
                worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
                e, tol, e32 = errs[worst]
                print(f"{name} 16 rays x S={S} white={white}: closest to its limit {worst} {e:.3e} of {tol:.3e} "
                      f"(fp32 plain {e32:.3e}); over the limit: {len(over)} of 26 {over}")


if __name__ == "__main__":
    main()
