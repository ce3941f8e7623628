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

    PYTHONPATH=. python3 tools/torch_bf16_accuracy.py --seeds 0-3 --k2-rays 256

holds K2 in bf16 (the composition K1s + the backward from what it saved) to
the rule as ``tests/test_torch_gpu.py::test_bf16_bwd_kernel_meets_the_bf16_rule``
does, at that many random rays (``torch_train_compare.level_inputs``), S =
65 and 193, both backgrounds: seed b draws the weights and the rays from S
+ 1000 b and the cotangents from one more, so seed 0 is the test's case. It
prints each case's gradients over their limits and counts the cases over.

    PYTHONPATH=. python3 tools/torch_bf16_accuracy.py --seeds 0-7 --fwd-bf16-run 2

builds the kernels with another run length of the bf16 forward's products
(``AONERF_FWD_BF16_RUN`` in ``csrc/nerf_level.cuh``: k16 steps that one
fresh accumulator sums) into their own libraries and holds that forward to
the rule, as ``torch_train_compare.py --fwd-bf16-run`` times it;
``--b1-bf16-run N`` does the same for B1's products in bf16 mode
(``AONERF_B1_BF16_RUN``).
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


def run_k2(seeds, R: int) -> None:
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft
    from torch_train_compare import level_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    over, cases = 0, 0
    for seed in seeds:
        for S in (65, 193):
            base = S + 1000 * seed
            mlp = NeRFMLP(generator=torch.Generator().manual_seed(base), device=dev)
            with torch.no_grad():
                kp = fr.kernel_params(mlp)
            args = level_inputs(R, S, base, dev)
            rng = np.random.default_rng(base + 1)
            cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
                rng.standard_normal((R, S))))
            for white in (True, False):
                got = ft.fused_level_bwd(kp, *args, *cot, white, dot_bf16=True)
                orders = {}
                for k, mm in c.BF16_ORDERS.items():
                    saved, raw = ft.fused_level_fwd_spill_ref(kp, *args, white, mm=mm, dot_bf16=True)[4:]
                    orders[k] = ft.fused_level_bwd_saved_ref(kp, *args, saved, raw, *cot, white, mm=mm, dot_bf16=True)
                    del saved, raw
                ref = ft.fused_level_bwd_ref({n: v.double() for n, v in kp.items()}, *(a.double() for a in args),
                                             *(x.double() for x in cot), white, dot_bf16=True)
                ratios = c.bf16_ratios(got, ref, c.bf16_limits(orders, ref, c.TOL_BF16_GRAD))
                bad = {n: round(r, 3) for n, r in ratios.items() if r > 1.0}
                worst = max(ratios, key=ratios.get)
                over += bool(bad)
                cases += 1
                print(f"seed {seed} S={S} white={white} K2 R={R}: kernel at most {ratios[worst]:.3f} of its limit "
                      f"({worst}); over: {bad or 'none'}", flush=True)
                del got, orders, ref
    print(f"K2 cases over, of {cases}: {over}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0-7", help="seeds of the weights and cotangents, e.g. 0-7")
    parser.add_argument("--k2-rays", type=int, help="hold only K2, at this many random rays (the gpu test's case)")
    parser.add_argument("--fwd-bf16-run", type=int,
                        help="build the kernels with this run length of the bf16 forward's products "
                             "(AONERF_FWD_BF16_RUN, k16 steps a fresh accumulator: 1 or even)")
    parser.add_argument("--b1-bf16-run", type=int,
                        help="build the kernels with this run length of B1's products in bf16 mode "
                             "(AONERF_B1_BF16_RUN, k16 steps a fresh accumulator: 1 or even)")
    args = parser.parse_args()
    defines = (*((f"AONERF_FWD_BF16_RUN={args.fwd_bf16_run}",) if args.fwd_bf16_run else ()),
               *((f"AONERF_B1_BF16_RUN={args.b1_bf16_run}",) if args.b1_bf16_run else ()))
    if defines:
        from aonerf_torch.ops.kernels import build

        build.DEFINES = defines
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_accuracy: needs a CUDA card")
    print(c.smi_line(), flush=True)
    if args.k2_rays:
        run_k2(_seeds(args.seeds), args.k2_rays)
    else:
        run(_seeds(args.seeds))


if __name__ == "__main__":
    main()
