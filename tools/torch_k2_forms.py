#!/usr/bin/env python3
"""K2 fp32's per-gradient rule in three forms, at the default and other
encoded widths, on one CUDA card.

    PYTHONPATH=. python3 tools/torch_k2_forms.py

For the seed's NeRF at the default degrees (63 / 27), at max_deg_point 12,
deg_view 6 (75 / 39) and at 8 / 2 (51 / 15), two input seeds of
chip_smoke.py's scene (phase 6's and phase 27's), 2048 rays, S = 65 and
193, it prints the largest ratio of a gradient's error to its limit
(chip_smoke.py's rule: max(1e-4, 4 x the fp32 plain version's error
against fp64)) for: the composition (K1s then K2, against the plain
composition in fp64; phase 6's form), K2 from the plain fp32 forward's
saved (the same reference), and K2 from K1s' saved against the fp64
backward of that same saved (the fp32 plain backward of it as the
baseline; phase 27's form)."""
import numpy as np
import torch

import chip_smoke as cs
from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft


def ratio(got, p64, p32):
    """The largest error-to-limit ratio of the 26 gradients, and its name."""
    names = fr.WEIGHT_NAMES
    e_k, e_p = cs._grad_errors(got, p64, names), cs._grad_errors(p32, p64, names)
    r = {n: e_k[n] / max(cs.TOL_GRAD, cs.TOL_GRAD_FACTOR * e_p[n]) for n in names}
    w = max(r, key=r.get)
    return f"{r[w]:.3f} ({w})"


def main() -> None:
    cs.phase_device()
    boxes = laptop_scene(80.0)
    focal = 0.5 * cs.H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    for deg in ({}, {"max_deg_point": 12, "deg_view": 6}, {"max_deg_point": 8, "deg_view": 2}):
        nerf = NeRF(generator=torch.Generator().manual_seed(cs.SEED), device="cuda", **deg).eval()
        for seed in (cs.SEED + 200, cs.SEED + 1000):
            o, d, lvls = cs._train_levels(nerf, boxes, focal, R=cs.R_TRAIN, seed=seed)
            for kp, t, venc, xenc in lvls:
                S = t.shape[1]
                args = (kp, t, o, d, venc, xenc)
                args64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
                rng = np.random.default_rng(cs.SEED + 300 + S)
                cot = tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in (
                    rng.standard_normal((cs.R_TRAIN, 3)), rng.standard_normal(cs.R_TRAIN),
                    0.1 * rng.standard_normal(cs.R_TRAIN), rng.standard_normal((cs.R_TRAIN, S))))
                cot64 = tuple(c.double() for c in cot)
                p32 = ft.fused_level_bwd_ref(*args, *cot, True)
                p64 = ft.fused_level_bwd_ref(*args64, *cot64, True)
                *_, saved, raw = ft.fused_level_fwd_spill(*args, True)
                comp = ft.fused_level_bwd_saved(*args, saved, raw, *cot, True)
                *_, psaved, praw = ft.fused_level_fwd_spill_ref(*args, True)
                from_plain = ft.fused_level_bwd_saved(*args, psaved, praw, *cot, True)
                del psaved, praw
                s32 = ft.fused_level_bwd_saved_ref(*args, saved, raw, *cot, True)
                s64 = ft.fused_level_bwd_saved_ref(*args64, saved.double(), raw.double(), *cot64, True)
                print(f"widths {fr.widths(kp)} seed {seed} S={S}: composition {ratio(comp, p64, p32)}, from plain "
                      f"saved {ratio(from_plain, p64, p32)}, from K1s' saved vs fp64 of it {ratio(comp, s64, s32)}",
                      flush=True)
                del p32, p64, saved, raw, s32, s64
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
