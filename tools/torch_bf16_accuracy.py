#!/usr/bin/env python3
"""Holds K1, K1s and K2 in bf16 mode to chip_smoke.py's bf16 rule over many
seeds, on one CUDA card.

    PYTHONPATH=. python3 tools/torch_bf16_accuracy.py --seeds 0-7

For each seed (the NeRF's random weights and the cotangents; the rays are
chip_smoke.py's), the coarse (S=65) and the fine (S=193) level, white
background, it compares with the plain version in bf16 mode summed in fp64
(the reference): K1 at 4096 rays (comp, acc, depth, weights), K1s' ten saved
layers at 2048 rays, and K2's 26 gradients at 2048 rays (the composition
K1s + the backward from what it saved). Each output's limit is chip_smoke.py's
bf16 rule: max(1e-6 forward or 1e-4 gradients, 2x the spread of the plain
bf16 version over the six fp32 summation orders of BF16_ORDERS, cuBLAS,
reversed K, K in two, four and eight parts, each half of K reversed, around
the fp64 reference). Beside the bf16 kernel it holds to the same limits
three more fp32 orders that set no limit (WITNESS_ORDERS: K in three parts,
K in sixteen parts, as B2's split-K sums it, and the even and the odd
indices of K apart), witnesses of how often the rule turns away an order as
right as any, and the fp32 kernel, which must miss on at least one output a
level. For the record it also prints the ratios of the two earlier rules:
4x the cuBLAS order's own error (the first), and 2x the farthest of three
orders, cuBLAS, reversed K and K in halves (the second), for the
kernel and for the reversed-K and the K-in-quarters orders. The last line
counts the cases over each rule. The kernels and cuBLAS give the same bits
on every call, so a second run of a seed reads the same unless the card or
the libraries differ.
"""

import argparse

import numpy as np
import torch

import chip_smoke as c

FIRST_RULE_FACTOR = 4.0  # the first rule: 4x the cuBLAS order's own error
SECOND_RULE_ORDERS = ("cuBLAS", "reversed K", "K in halves")  # the second rule's three orders


def _even_odd(a, w):
    return a[:, 0::2] @ w[0::2] + a[:, 1::2] @ w[1::2]


# fp32 orders of the plain bf16 version that set no limit: witnesses of how
# often the rule turns away an order as right as any
WITNESS_ORDERS = {"K in thirds": c._k_in_parts(3), "K in sixteenths": c._k_in_parts(16), "even and odd K": _even_odd}


def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def _worst(ratios):
    n = max(ratios, key=ratios.get)
    return f"{ratios[n]:.3f} ({n})", ratios[n] > 1.0


def _case(what, kernel, fp32_kernel, orders, witnesses, ref64, floor, over):
    limits = c.bf16_limits(orders, ref64, floor)
    first = {n: max(floor, FIRST_RULE_FACTOR * c._rel(orders["cuBLAS"][n], ref64[n])) for n in ref64}
    second = c.bf16_limits({k: orders[k] for k in SECOND_RULE_ORDERS}, ref64, floor)
    rows = {"kernel": c.bf16_ratios(kernel, ref64, limits),
            **{k: c.bf16_ratios(v, ref64, limits) for k, v in witnesses.items()},
            "kernel, first rule": c.bf16_ratios(kernel, ref64, first),
            "reversed, first rule": c.bf16_ratios(orders["reversed K"], ref64, first),
            "kernel, second rule": c.bf16_ratios(kernel, ref64, second),
            "quarters, second rule": c.bf16_ratios(orders["K in quarters"], ref64, second)}
    text = []
    for name, ratios in rows.items():
        shown, bad = _worst(ratios)
        over[name] += bad
        text.append(f"{name} {shown}")
    if fp32_kernel is not None:
        missed = sorted(n for n, r in c.bf16_ratios(fp32_kernel, ref64, limits).items() if r > 1.0)
        over["fp32 kernel within"] += not missed
        text.append(f"fp32 kernel over on {len(missed)} of {len(limits)}")
    print(f"{what}: of its limit, " + "; ".join(text), flush=True)


def run(seeds) -> None:
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    focal = 0.5 * c.H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    boxes = laptop_scene(80.0)
    white = True
    over = {"kernel": 0, **{k: 0 for k in WITNESS_ORDERS}, "kernel, first rule": 0, "reversed, first rule": 0,
            "kernel, second rule": 0, "quarters, second rule": 0, "fp32 kernel within": 0}
    cases = 0
    for seed in seeds:
        nerf = NeRF(generator=torch.Generator().manual_seed(seed), device="cuda").eval()
        o, d, lvls = c._train_levels(nerf, boxes, focal, R=c.R, seed=c.SEED + 100, dot_bf16=True)
        for kp, t, venc, xenc in lvls:
            lv = (kp, t, o, d, venc, xenc)
            lv64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
            ref = c.bf16_k1_plain(lv64, white)
            variants = {k: c.bf16_k1_plain(lv, white, mm) for k, mm in c.BF16_ORDERS.items()}
            kernel = dict(zip(c.OUTPUTS, fr.fused_render_level(*lv, white, dot_bf16=True)))
            fp32 = dict(zip(c.OUTPUTS, fr.fused_render_level(*lv, white)))
            witnesses = {k: c.bf16_k1_plain(lv, white, mm) for k, mm in WITNESS_ORDERS.items()}
            _case(f"seed {seed} S={t.shape[1]} K1 R={c.R}", kernel, fp32, variants, witnesses, ref, c.TOL_BF16_FWD,
                  over)
            cases += 1
            del lv64, ref, variants, kernel, fp32, witnesses
        o, d, lvls = c._train_levels(nerf, boxes, focal, R=c.R_TRAIN, dot_bf16=True)
        R = o.shape[0]
        for kp, t, venc, xenc in lvls:
            S = t.shape[1]
            lv = (kp, t, o, d, venc, xenc)
            lv64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
            ref = c.saved_layers(ft.fused_level_fwd_spill_ref(*lv64, white, dot_bf16=True)[4])
            variants = {k: c.saved_layers(ft.fused_level_fwd_spill_ref(*lv, white, mm=mm, dot_bf16=True)[4])
                        for k, mm in c.BF16_ORDERS.items()}
            kernel = c.saved_layers(ft.fused_level_fwd_spill(*lv, white, dot_bf16=True)[4])
            witnesses = {k: c.saved_layers(ft.fused_level_fwd_spill_ref(*lv, white, mm=mm, dot_bf16=True)[4])
                         for k, mm in WITNESS_ORDERS.items()}
            _case(f"seed {seed} S={S} K1s saved R={R}", kernel, None, variants, witnesses, ref, c.TOL_BF16_FWD, over)
            del ref, variants, kernel, witnesses
            rng = np.random.default_rng(seed + 300 + S)
            cot = tuple(torch.from_numpy(a.astype(np.float32)).to(o.device) for a in (
                rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
                rng.standard_normal((R, S))))
            ref = c.bf16_k2_plain(lv64, tuple(x.double() for x in cot), white)
            variants = {k: c.bf16_k2_plain(lv, cot, white, mm) for k, mm in c.BF16_ORDERS.items()}
            kernel = ft.fused_level_bwd(*lv, *cot, white, dot_bf16=True)
            fp32 = ft.fused_level_bwd(*lv, *cot, white)
            witnesses = {k: c.bf16_k2_plain(lv, cot, white, mm) for k, mm in WITNESS_ORDERS.items()}
            _case(f"seed {seed} S={S} K2 R={R}", kernel, fp32, variants, witnesses, ref, c.TOL_BF16_GRAD, over)
            cases += 2
            del lv64, ref, variants, kernel, fp32, witnesses
            torch.cuda.empty_cache()
    print(f"cases over, of {cases}: " + ", ".join(f"{k} {v}" for k, v in over.items() if k != "fp32 kernel within")
          + f"; K1 and K2 cases where the fp32 kernel meets the rule: {over['fp32 kernel within']}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0-7", help="seeds of the weights and cotangents, e.g. 0-7")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_accuracy: needs a CUDA card")
    print(c.smi_line(), flush=True)
    run(_seeds(args.seeds))


if __name__ == "__main__":
    main()
