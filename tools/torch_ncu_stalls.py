#!/usr/bin/env python3
"""Warp-stall breakdown and tensor-pipe use of K1s or B2, by Nsight Compute.

    python3 tools/torch_ncu_stalls.py --label change
    python3 tools/torch_ncu_stalls.py --label parent --tree build/parent
    python3 tools/torch_ncu_stalls.py --label change --kernel level_bwd_dw_kernel

Runs ``ncu`` (from the CUDA toolkit that ``nvcc`` comes from) on a child
process of this script that runs the ``aonerf_torch`` under ``--tree`` at
2048 rays x S = 193 (random weights, inputs and cotangents from a seed):
``--kernel level_fwd_spill_kernel`` (the default) launches K1s
(``fused_level_fwd_spill``) twice; ``--kernel level_bwd_dw_kernel`` launches
K1s once and the fp32 backward from its saved activations
(``fused_level_bwd_saved``) twice, whose pass B2 is that kernel. It
profiles the kernel's second launch with the
WarpStateStats, ComputeWorkloadAnalysis and SpeedOfLight sections. Prints
one JSON line: every stall reason (warp cycles per issued instruction),
the tensor pipe's and the SM's use, and the kernel's duration under the
profiler. With ``--csv FILE`` it also writes ncu's raw page there. Exits 1
with ncu's own message when ncu cannot profile (e.g. ERR_NVGPUCTRPERM).
"""

import argparse
import csv
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("level_fwd_spill_kernel", "level_bwd_dw_kernel")
R, S = 2048, 193
KEEP = ("stalled", "pipe_tensor", "gpu__time_duration", "sm__throughput", "issue_active",
        "warps_active", "inst_executed_pipe")


def child(kernel: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_train_compare import level_inputs

    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    device = torch.device("cuda")
    mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
    with torch.no_grad():
        kp = fr.kernel_params(mlp)
    args = (kp, *level_inputs(R, S, S, device))
    if kernel == "level_fwd_spill_kernel":
        for _ in range(2):
            ft.fused_level_fwd_spill(*args, True)
    else:
        rng = np.random.default_rng(S + 1)
        cot = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
            rng.standard_normal((R, S))))
        *_, saved, raw = ft.fused_level_fwd_spill(*args, True)
        for _ in range(2):
            ft.fused_level_bwd_saved(*args, saved, raw, *cot, True)
    torch.cuda.synchronize()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="tree", help="name of the tree in the output line")
    parser.add_argument("--tree", default=ROOT, help="directory whose aonerf_torch to profile")
    parser.add_argument("--kernel", default=KERNELS[0], choices=KERNELS,
                        help="the kernel to profile: K1s (the default) or the fp32 B2")
    parser.add_argument("--csv", help="file to write ncu's raw page to")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.kernel)
        return
    sys.path.insert(0, os.path.abspath(args.tree))
    from aonerf_torch.ops.kernels import build

    ncu = os.path.join(os.path.dirname(build.nvcc_path()), "ncu")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(args.tree))
    cmd = [ncu, "--target-processes", "all", "--kernel-name", f"regex:{args.kernel}", "--launch-skip", "1",
           "--launch-count", "1", "--section", "WarpStateStats", "--section", "ComputeWorkloadAnalysis",
           "--section", "SpeedOfLight", "--csv", "--page", "raw",
           sys.executable, os.path.abspath(__file__), "--child", "--kernel", args.kernel]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1200)
    rows = [line for line in run.stdout.splitlines() if line.startswith('"')]
    if run.returncode != 0 or len(rows) < 3:
        print(run.stdout[-4000:], run.stderr[-4000:], sep="\n")
        raise SystemExit(f"torch_ncu_stalls: ncu exit {run.returncode}, {len(rows)} csv rows")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("\n".join(rows) + "\n")
    table = list(csv.reader(io.StringIO("\n".join(rows))))
    header, units, values = table[0], table[1], table[2]
    metrics = {}
    for name, unit, value in zip(header, units, values):
        if any(k in name for k in KEEP):
            try:
                metrics[name] = float(value.replace(",", ""))
            except ValueError:
                metrics[name] = value
            if unit:
                metrics[name + " [unit]"] = unit
    print(json.dumps({"label": args.label, "kernel": args.kernel, "rays": R, "S": S, "metrics": metrics}), flush=True)


if __name__ == "__main__":
    main()
