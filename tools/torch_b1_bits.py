#!/usr/bin/env python3
"""Shows whether K2's pass B1 is the same code, with the same bits, in two
trees.

    PYTHONPATH=build/parent python3 tools/torch_b1_bits.py --out build/b1_parent.pt
    PYTHONPATH=. python3 tools/torch_b1_bits.py --out build/b1_change.pt
    python3 tools/torch_b1_bits.py --compare build/b1_parent.pt build/b1_change.pt

For whichever ``aonerf_torch`` comes first on the path, on one CUDA card: it
builds ``csrc/fused_train.cu``, prints the sha1 and line count of B1's
SASS (``level_bwd_delta_kernel``, from ``cuobjdump -sass``), and saves the 26
gradients of the backward from saved (``fused_level_bwd_saved``: the
integrator backward, B1, B2, the reduction) at 2048 rays x S = 65 and 193,
both backgrounds, random weights, inputs and cotangents from a seed. Its
``saved`` and ``raw`` come from the plain forward, so B1's input does not
depend on the tree's forward kernel. ``--compare`` prints whether two such
files hold the same bits and SASS, and exits 1 if they do not.
"""

import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from torch_train_compare import R_TRAIN, level_inputs

B1 = "level_bwd_delta_kernel"


def b1_sass(lib_path: str) -> list:
    """B1's SASS lines, from the ``Function :`` header to the next one, each
    with its runs of blanks made one (cuobjdump pads its columns to the
    longest line of the whole library)."""
    from aonerf_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    lines, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = B1 in line
        elif inside:
            lines.append(" ".join(line.split()))
    if not lines:
        raise SystemExit(f"torch_b1_bits: no SASS of {B1} in {lib_path}")
    return lines


def sass_sha1(lines: list) -> str:
    return hashlib.sha1("\n".join(" ".join(line.split()) for line in lines).encode()).hexdigest()


def record(out: str) -> None:
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import build
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    sass = b1_sass(str(build.build(["fused_train"])["fused_train"]))
    digest = sass_sha1(sass)
    print(f"B1 SASS: {len(sass)} lines, sha1 {digest}", flush=True)
    grads = {}
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        args = (kp, *level_inputs(R_TRAIN, S, S, device))
        rng = np.random.default_rng(S + 1)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((R_TRAIN, 3)), rng.standard_normal(R_TRAIN), 0.1 * rng.standard_normal(R_TRAIN),
            rng.standard_normal((R_TRAIN, S))))
        for white in (True, False):
            *_, saved, raw = ft.fused_level_fwd_spill_ref(*args, white)
            g = ft.fused_level_bwd_saved(*args, saved, raw, *cot, white)
            grads[f"S={S} white={white}"] = {n: v.cpu() for n, v in g.items()}
            del saved, raw
    torch.save({"sass": sass, "grads": grads}, out)
    print(f"saved {len(grads)} gradient sets to {out}")


def compare(a: str, b: str) -> None:
    x, y = torch.load(a), torch.load(b)
    hx, hy = sass_sha1(x["sass"]), sass_sha1(y["sass"])
    same_sass = hx == hy
    diff = [f"{case}/{n}" for case in x["grads"] for n in x["grads"][case]
            if not torch.equal(x["grads"][case][n], y["grads"][case][n])]
    n = sum(len(v) for v in x["grads"].values())
    print(f"B1 SASS {'identical' if same_sass else 'DIFFERS'} ({len(x['sass'])} / {len(y['sass'])} lines, sha1 "
          f"{hx} / {hy}); "
          f"gradients equal bit for bit on {n - len(diff)} of {n}" + (f", differ on {diff}" if diff else ""))
    if not same_sass:
        changed = [(i, p, q) for i, (p, q) in enumerate(zip(x["sass"], y["sass"])) if p.split() != q.split()]
        print(f"  {len(changed)} of {len(x['sass'])} SASS lines differ; the first ones:")
        for i, p, q in changed[:12]:
            print(f"    {i}: {p}\n    {i}: {q}")
    if not same_sass or diff:
        sys.exit(1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="file to save this tree's B1 SASS hash and gradients to")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two files written by --out")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    elif args.out:
        if not torch.cuda.is_available():
            raise SystemExit("torch_b1_bits: needs a CUDA card")
        record(args.out)
    else:
        parser.error("give --out or --compare")


if __name__ == "__main__":
    main()
