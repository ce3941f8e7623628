#!/usr/bin/env python3
"""How far the training forward's rounding carries into K2's gradients, on one
CUDA card, for whichever ``aonerf_torch`` (and its ``chip_smoke.py``) comes
first on the path.

    PYTHONPATH=. python3 tools/torch_fwd_accuracy.py [--seed N] [--brief]
    PYTHONPATH=build/parent python3 tools/torch_fwd_accuracy.py

At chip_smoke.py's train-step inputs (2048 rays of one view, the coarse and
the fine level, random weights from its seed, phase 6's cotangents, white
background) it compares K1s' saved activations and raw sigma (the kernel)
and the fp32 plain version's with the plain version in fp64: per saved
layer, the rms and max error relative to the layer's rms and max, and the
ReLU units whose sign differs from fp64's. Then the 26 gradients by chip_smoke's
rule (max abs err / max |fp64|, the limit max(1e-4, 4 x fp32 plain's)) in four
ways: K2 from the kernel's saved (what phase 6 holds to the limit), the plain
backward in fp64 from the kernel's saved and from fp32 plain's saved (the
forward's share of each error), and the fp32 plain version throughout.
``--seed`` draws other weights and cotangents (the rays stay chip_smoke.py's);
``--brief`` prints only each level's gradient closest to its limit.

    PYTHONPATH=. python3 tools/torch_fwd_accuracy.py --witness --seeds 0-7

holds other forwards to the same rule, each with its own rounding: at each
seed and level, K2 runs from the saved activations of the kernel, of the
fp32 plain version (cuBLAS), of the fp32 plain version with every product's
K order reversed (cuBLAS), of the fp32 plain version on the host CPU, and of
a forward whose products are summed in fp64 and rounded once to fp32; each
line gives the gradient closest to its limit, the gradients over it, and the
saved layers' rms error against fp64 as a ratio to fp32 plain's (the least
and the largest over the ten layers). ``--forwards kernel`` runs only the
kernel's row (for a tree whose plain version takes no ``mm``).
"""

import argparse

import numpy as np
import torch

import chip_smoke as c

LAYERS = [f"h{i}" for i in range(8)] + ["btl", "view"]


def layer_cols(i):
    w = 256
    return slice(i * w, (i + 1) * w) if i < 9 else slice(9 * w, 9 * w + 128)


def rel(a, b64):
    return ((a.double() - b64).abs().max() / b64.abs().max().clamp_min(1e-300)).item()


def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


FORWARDS = ("kernel", "plain", "reversed", "cpu", "fp64-sum")


def _witness_saved(name, lv, white):
    """(saved, raw) of the level from the forward ``name`` (see the module
    docstring), fp32 on the card."""
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    if name == "kernel":
        return ft.fused_level_fwd_spill(*lv, white)[4:]
    kp, t, o, d, venc, xenc = lv
    mm = {
        "plain": torch.matmul,
        "reversed": lambda a, w: a.flip(-1) @ w.flip(0),
        "cpu": torch.matmul,
        "fp64-sum": lambda a, w: (a.double() @ w.double()).float(),
    }[name]
    if name == "cpu":
        kp, venc, xenc = {n: v.cpu() for n, v in kp.items()}, venc.cpu(), xenc.cpu()
    S = t.shape[1]
    acts, raw_sigma, raw_rgb = fr.level_activations_ref(kp, venc, xenc.reshape(-1, xenc.shape[-1]), S, mm=mm)
    saved, raw = torch.cat(acts, -1), torch.cat([raw_sigma, raw_rgb], -1)
    del acts
    return saved.to(t.device), raw.to(t.device)


def witness(seeds, forwards) -> None:
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    names = fr.WEIGHT_NAMES
    focal = 0.5 * c.H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    white = True
    over = {f: 0 for f in forwards}
    cases = 0
    for seed in seeds:
        nerf = NeRF(generator=torch.Generator().manual_seed(seed), device="cuda").eval()
        o, d, lvls = c._train_levels(nerf, laptop_scene(80.0), focal)
        R, dev = o.shape[0], o.device
        for kp, t, venc, xenc in lvls:
            S = t.shape[1]
            rng = np.random.default_rng(seed + 300 + S)
            cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
                rng.standard_normal((R, S))))
            lv = (kp, t, o, d, venc, xenc)
            lv64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
            g64 = ft.fused_level_bwd_ref(*lv64, *(x.double() for x in cot), white)
            g32 = ft.fused_level_bwd_ref(*lv, *cot, white)
            tol = {n: max(c.TOL_GRAD, c.TOL_GRAD_FACTOR * rel(g32[n], g64[n])) for n in names}
            del g32
            s_64 = ft.fused_level_fwd_spill_ref(*lv64, white)[4]
            s_32 = ft.fused_level_fwd_spill_ref(*lv, white)[4]
            rms = [(s_64[:, layer_cols(i)].pow(2).mean().sqrt().item(),
                    (s_32[:, layer_cols(i)].double() - s_64[:, layer_cols(i)]).pow(2).mean().sqrt().item())
                   for i in range(len(LAYERS))]
            del s_32
            cases += 1
            for f in forwards:
                saved, raw = _witness_saved(f, lv, white)
                g = ft.fused_level_bwd_saved(*lv, saved, raw, *cot, white)
                ratio = {n: rel(g[n], g64[n]) / tol[n] for n in names}
                lr = [(saved[:, layer_cols(i)].double() - s_64[:, layer_cols(i)]).pow(2).mean().sqrt().item()
                      / max(rms[i][1], 1e-300) for i in range(len(LAYERS))]
                del saved, raw, g
                worst = max(ratio, key=ratio.get)
                bad = sorted(n for n in names if ratio[n] > 1.0)
                over[f] += bool(bad)
                print(f"seed {seed} S={S} {f:8s}: closest {worst} at {ratio[worst]:.3f} of its limit; over: {bad}; "
                      f"saved rms err / fp32 plain's {min(lr):.2f}-{max(lr):.2f}", flush=True)
            del s_64, g64
            torch.cuda.empty_cache()
    print("cases over K2's rule, of " + str(cases) + ": " + ", ".join(f"{f} {over[f]}" for f in forwards))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=c.SEED, help="seed of the weights and cotangents")
    parser.add_argument("--brief", action="store_true", help="print only the closest gradient per level")
    parser.add_argument("--witness", action="store_true", help="hold other forwards to K2's rule")
    parser.add_argument("--seeds", default="0-3", help="weight seeds of --witness, as N or N-M")
    parser.add_argument("--forwards", default=",".join(FORWARDS), help="forwards of --witness, comma-separated")
    args = parser.parse_args()
    if args.witness:
        c.phase_device()
        witness(_seeds(args.seeds), args.forwards.split(","))
        return
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    c.phase_device()
    dev = torch.device("cuda")
    nerf = NeRF(generator=torch.Generator().manual_seed(args.seed), device="cuda").eval()
    focal = 0.5 * c.H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    o, d, lvls = c._train_levels(nerf, laptop_scene(80.0), focal)
    names = fr.WEIGHT_NAMES
    R = o.shape[0]
    white = True
    for kp, t, venc, xenc in lvls:
        S = t.shape[1]
        rng = np.random.default_rng(args.seed + 300 + S)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
            rng.standard_normal((R, S))))
        lv = (kp, t, o, d, venc, xenc)
        lv64 = ({n: v.double() for n, v in kp.items()}, *(a.double() for a in (t, o, d, venc, xenc)))
        cot64 = tuple(x.double() for x in cot)
        *_, s_k, r_k = ft.fused_level_fwd_spill(*lv, white)
        *_, s_32, r_32 = ft.fused_level_fwd_spill_ref(*lv, white)
        *_, s_64, r_64 = ft.fused_level_fwd_spill_ref(*lv64, white)
        if not args.brief:
            print(f"S={S}: saved vs fp64, kernel | fp32 plain: rms err / rms, max err / max, sign flips")
        for i, n in enumerate(LAYERS if not args.brief else ()):
            cols = layer_cols(i)
            ref = s_64[:, cols]
            rms = ref.pow(2).mean().sqrt().item()
            row = []
            for got in (s_k, s_32):
                g = got[:, cols]
                e = (g.double() - ref)
                flips = ((g > 0) != (ref > 0)).sum().item() if n != "btl" else 0
                row.append(f"{e.pow(2).mean().sqrt().item() / rms:.3e} {e.abs().max().item() / ref.abs().max().item():.3e} "
                           f"{flips:6d}")
            print(f"  {n:5s} {row[0]} | {row[1]}")
        for label, raw in (("kernel", r_k), ("fp32 plain", r_32)) if not args.brief else ():
            e = (raw[:, 0].double() - r_64[:, 0]).abs()
            print(f"  raw sigma, {label}: max abs err {e.max().item():.3e} at row {int(e.argmax())}, "
                  f"rms {e.pow(2).mean().sqrt().item():.3e}")
        g64 = ft.fused_level_bwd_ref(*lv64, *cot64, white)
        g32 = ft.fused_level_bwd_ref(*lv, *cot, white)
        gk = ft.fused_level_bwd_saved(*lv, s_k, r_k, *cot, white)
        runs = [gk]
        if not args.brief:
            runs.append(ft.fused_level_bwd_saved_ref(*lv64, s_k.double(), r_k.double(), *cot64, white))
            del s_k
            runs.append(ft.fused_level_bwd_saved_ref(*lv64, s_32.double(), r_32.double(), *cot64, white))
        del s_32, s_64
        if not args.brief:
            print(f"S={S} white={white}: gradient errors vs fp64 (limit): K2 from the kernel's saved | fp64 backward "
                  "from the kernel's saved | fp64 backward from fp32 plain's saved | fp32 plain")
        ratio = {}
        for n in names:
            e32 = rel(g32[n], g64[n])
            tol = max(c.TOL_GRAD, c.TOL_GRAD_FACTOR * e32)
            errs = [rel(x[n], g64[n]) for x in runs]
            ratio[n] = errs[0] / tol
            flag = " <- over" if errs[0] > tol else ""
            if not args.brief:
                print(f"  {n:4s} ({tol:.3e}) " + " | ".join(f"{e:.3e}" for e in errs) + f" | {e32:.3e}{flag}")
        worst = max(ratio, key=ratio.get)
        print(f"seed {args.seed} S={S}: K2 from the kernel's saved, closest to its limit: {worst} at "
              f"{ratio[worst]:.3f} of it; over: {sorted(n for n in names if ratio[n] > 1.0)}", flush=True)
        del g64, g32, gk, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
