#!/usr/bin/env python3
"""K2's bf16 rule at every encoded width, in two forms, on one CUDA card.

    PYTHONPATH=. python3 tools/torch_bf16_rule_widths.py [--seeds 8] [--rays 256]

At --rays rays (256) x S = 65, white background, for the gpu tests' every-width
sweep (degrees (0, d, d mod 9), d = 0..12: sample widths 3 to 75, view widths
3 to 51) built at the sweep's seed, and for the default degrees (0, 10, 4) at
that seed and ``--seeds`` more, it prints the largest ratio of a gradient's
error to its bf16-rule limit (chip_smoke.py's bf16_limits: 2x the farthest of
six fp32 summation orders of the plain bf16 version from its fp64 sum) for:
the composition (K1s then K2 in bf16 mode, against the plain bf16
composition, as tests/test_torch_gpu.py's degrees tests hold it), and K2 on
its own inputs (the backward from K1s' saved, against the plain bf16
backward from the same saved in fp64, the orders on that saved).
"""

import argparse

import numpy as np
import torch

import chip_smoke as cs
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.ops.kernels import build
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft

S = 65


def level(degrees, seed, device, R):
    """A level at these degrees: the seed's MLP with live densities, random
    rays and samples (the gpu tests' _level_inputs) and cotangents."""
    lo, hi, view = degrees
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(seed), device=device, min_deg_point=lo, max_deg_point=hi,
                  deg_view=view)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
        kp["bd"] += 0.5
    rng = np.random.default_rng(S)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    pts = o[:, None] + t[..., None] * d[:, None]
    t, o, d, pts = (torch.from_numpy(a).to(device) for a in (t, o, d, pts))
    rng = np.random.default_rng(S + 1)
    cot = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S))))
    return (kp, t, o, d, pos_enc(d, 0, view), pos_enc(pts, lo, hi)), cot


def worst(got, orders, ref):
    r = cs.bf16_ratios(got, ref, cs.bf16_limits(orders, ref, cs.TOL_BF16_GRAD))
    n = max(r, key=r.get)
    return f"{r[n]:.3f} ({n})"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8, help="more seeds at the default degrees")
    parser.add_argument("--rays", type=int, default=256, help="rays a level")
    args = parser.parse_args()
    cs.phase_device()
    sweep = [(0, d, d % 9) for d in range(13)]
    build.build([(n, build.width_defines(3 + 6 * hi, 3 + 6 * view)) for _, hi, view in sweep
                 for n in build.all_sources()])
    cases = [(deg, S + deg[1]) for deg in sweep] + [((0, 10, 4), S + 10 + k) for k in range(args.seeds + 1)]
    for degrees, seed in cases:
        lv, cot = level(degrees, seed, torch.device("cuda"), args.rays)
        lv64 = ({n: v.double() for n, v in lv[0].items()}, *(a.double() for a in lv[1:]))
        cot64 = tuple(c.double() for c in cot)
        *_, saved, raw = ft.fused_level_fwd_spill(*lv, True, dot_bf16=True)
        got = ft.fused_level_bwd_saved(*lv, saved, raw, *cot, True, dot_bf16=True)
        comp = worst(got, {k: cs.bf16_k2_plain(lv, cot, True, mm) for k, mm in cs.BF16_ORDERS.items()},
                     ft.fused_level_bwd_ref(*lv64, *cot64, True, dot_bf16=True))
        own = worst(got, {k: ft.fused_level_bwd_saved_ref(*lv, saved, raw, *cot, True, mm=mm, dot_bf16=True)
                          for k, mm in cs.BF16_ORDERS.items()},
                    ft.fused_level_bwd_saved_ref(*lv64, saved.double(), raw.double(), *cot64, True, dot_bf16=True))
        print(f"widths {fr.widths(lv[0])} seed {seed} at {args.rays} rays: composition {comp}, K2 on its own inputs "
              f"{own}", flush=True)
        del saved, raw, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
