"""The bf16 rule of chip_smoke.py (BF16_ORDERS, bf16_limits, bf16_ratios,
TOL_BF16_*, TIE_SHARE), which holds the kernels' bf16 mode on the card,
shown on the CPU at a small shape with the plain versions alone: it accepts
fp32 orders of the plain bf16 version that set none of its limits, and it
rejects the plain fp32 version and bf16 rounding with ties away from zero.

The shape is 16 rays x 17 samples, seeds 0-3, white background, the density
bias raised by 0.5 so that the rays carry weight. Measured there (largest
ratio to the limit over the outputs; a case passes at most 1): K in thirds,
K in sixteenths and the even and the odd indices of K apart at most 0.731
(K2, seed 1); the plain fp32 version over on 3-4 of K1's 4 outputs (up to
6.64x) and 23-26 of K2's 26 gradients (up to 317x). On inputs at bf16 ties
(seed 2), every fp32 order gives h0 the same bits, and ties away from zero
move 32% of it (the check's limit, TIE_SHARE, is 0.5%).
"""

import numpy as np
import pytest
import torch

import chip_smoke as rule
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft

torch.set_num_threads(1)

R, S = 16, 17


def _even_odd(a, w):
    return a[:, 0::2] @ w[0::2] + a[:, 1::2] @ w[1::2]


# fp32 orders of the plain bf16 version that set no limit of the rule
OTHER_ORDERS = {"K in thirds": rule._k_in_parts(3), "K in sixteenths": rule._k_in_parts(16),
                "even and odd K": _even_odd}


def _level(seed: int):
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    cot = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S))))
    t, o, d, pts = (torch.from_numpy(a) for a in (t, o, d, pts))
    lv = (kp, t, o, d, pos_enc(d, 0, 4), pos_enc(pts, 0, 10))
    lv64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in lv[1:]))
    return lv, lv64, cot


def _k1(lv, mm=torch.matmul, cot=None):
    return rule.bf16_k1_plain(lv, True, mm)


def _k2(lv, mm=torch.matmul, cot=None):
    return rule.bf16_k2_plain(lv, cot, True, mm)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("what", ["K1", "K2"])
def test_rule_accepts_other_orders_and_rejects_fp32(what, seed):
    lv, lv64, cot = _level(seed)
    plain, floor = (_k1, rule.TOL_BF16_FWD) if what == "K1" else (_k2, rule.TOL_BF16_GRAD)
    ref = plain(lv64, cot=tuple(c.double() for c in cot))
    limits = rule.bf16_limits({k: plain(lv, mm, cot) for k, mm in rule.BF16_ORDERS.items()}, ref, floor)
    assert set(limits) == set(ref) and all(v >= floor for v in limits.values())
    for name, mm in OTHER_ORDERS.items():
        ratios = rule.bf16_ratios(plain(lv, mm, cot), ref, limits)
        assert all(r <= 1.0 for r in ratios.values()), (name, ratios)
    if what == "K1":
        fp32 = dict(zip(rule.OUTPUTS, fr.fused_render_level_ref(*lv, True)))
    else:
        fp32 = ft.fused_level_bwd_ref(*lv, *cot, True)
    ratios = rule.bf16_ratios(fp32, ref, limits)
    assert sum(r > 1.0 for r in ratios.values()) >= len(ratios) // 2, ratios


def _round_ties_away(x: torch.Tensor) -> torch.Tensor:
    """bf16 rounding to nearest with ties away from zero, back to x's dtype."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x8000) & ~0xFFFF).view(torch.float32).to(x.dtype)


def test_rule_rejects_ties_away_from_zero(monkeypatch):
    """The tie check: on encoded inputs exactly halfway between two bf16
    values, K1s' saved h0 of the plain bf16 version in another fp32 order
    differs from the cuBLAS order's on at most TIE_SHARE of its elements;
    with every rounding of the plain version made ties-away, on far more."""
    (kp, t, o, d, venc, xenc), _, _ = _level(2)
    ties = (fr.round_bf16(xenc).view(torch.int32) + 0x8000).view(torch.float32)
    args = (kp, t, o, d, venc, ties)

    def h0(mm=torch.matmul):
        return ft.fused_level_fwd_spill_ref(*args, True, mm=mm, dot_bf16=True)[4][:, :256]

    even = h0()
    other = max((h0(mm) != even).double().mean().item() for mm in (*rule.BF16_ORDERS.values(),
                                                                    *OTHER_ORDERS.values()))
    monkeypatch.setattr(fr, "round_bf16", _round_ties_away)
    away = (h0() != even).double().mean().item()
    assert other <= rule.TIE_SHARE < away / 4, (other, away)
