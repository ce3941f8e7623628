#!/usr/bin/env python3
"""Shows whether K1, K1s and K2 give the same bits in two trees.

    PYTHONPATH=build/parent python3 tools/torch_kernel_bits.py --out build/bits_parent.pt
    PYTHONPATH=. python3 tools/torch_kernel_bits.py --out build/bits_change.pt
    python3 tools/torch_kernel_bits.py --compare build/bits_parent.pt build/bits_change.pt

For whichever ``aonerf_torch`` comes first on the path, on one CUDA card, it
saves, from random weights, inputs and cotangents made from fixed seeds:
  - K1 (``fused_render_level``) at 4096 rays: comp, acc, depth, weights;
  - K1s (``fused_level_fwd_spill``) at 2048 rays: comp, acc, depth, weights,
    raw, and the sha1 of ``saved`` (3.85 GB at S = 193; in bf16 mode the sha1
    of its values as bf16, whatever dtype the tree's K1s writes them in);
  - K2's 26 gradients (``fused_level_bwd_saved``) at 2048 rays, once from
    K1s' own ``saved`` and ``raw`` and once from the plain forward's, so
    that the second depends on no forward kernel;
each at S = 65 and 193, both backgrounds, in fp32 and, where the tree has
it, in bf16 mode (``dot_bf16``; cases named "bf16 ..."). It also prints the
sha1 and line count of B1's fp32 SASS (``level_bwd_delta_kernel``, from
``cuobjdump -sass``) and of B2's (``level_bwd_dw_kernel``), with the TMA
loads (``UTMALDG``) in B2's, of K1's in both modes (``fused_render_level_kernel``)
and of K1s' in fp32, and the tensor-core, ldmatrix and TMA instructions of
B2's in bf16 mode (``level_bwd_dw_bf16_kernel``). ``--compare`` prints, for two such files, which
outputs of the cases both hold have the same bits and exits 1 if any
differs; it names the cases only one holds, and reports whether B1's and
B2's SASS are the same for information only. With ``--b2-bf16-differs`` (two trees
whose B2 in bf16 mode sums in other orders) the 21 gradients B2 computes
in the bf16 K2 cases (B2_GRADS) are expected to differ: ``--compare``
names them and their largest differences, fails on any other differing
output, and fails too if none of them differs.

    python3 tools/torch_kernel_bits.py --compare A B --b2-bf16-differs

With ``--bf16-fwd-differs`` (two trees whose bf16 forward walk sums in
other orders) the outputs of the bf16 K1 and K1s cases and, through K1s'
saved activations, the gradients of the "bf16 K2 from K1s' saved" cases are
the ones expected to differ; every fp32 output and the bf16 K2 from the
plain forward's saved must keep their bits.

The record also holds, at the fast preset's batch (R_PRESET = 224 rays, S
= 65 and 193, white background), K1s' bf16 ``saved`` and ``raw`` and K2's
bf16 gradients from them. ``--replay A`` (with ``--out``) runs this tree's
bf16 K2 on the saved and raw that file A holds, as the cases "bf16 K2 from
the replayed saved ..."; ``--compare`` holds each such case to the bits of
the same case "from K1s' saved" in the other file, so a tree whose forward
moved shows that its K2, given the other tree's saved, gives that tree's
bits.

    PYTHONPATH=build/parent python3 tools/torch_kernel_bits.py --out build/bits_parent.pt
    PYTHONPATH=. python3 tools/torch_kernel_bits.py --out build/bits_change.pt --replay build/bits_parent.pt
    python3 tools/torch_kernel_bits.py --compare build/bits_parent.pt build/bits_change.pt --bf16-fwd-differs

With ``--b1-bf16-differs`` (two trees whose B1 in bf16 mode sums otherwise,
or at another ray tile) every gradient of the bf16 K2 cases, replayed ones
too, is expected to differ (B1's deltas feed B2, and the tile orders B1's
head sums); every other output must keep its bits, B1's fp32 SASS must be
the same, and it fails if no expected output differs. The record also holds
the mma instructions of B1's bf16 SASS (``level_bwd_delta_kernel<true>``),
which ``--compare`` prints.

With ``--bf16-bias-differs`` (two trees whose bf16 mode sums the ten bias
gradients b0..b7, bb, bv in other orders: B1's sums of its fp32 deltas in
place of B2's) only those ten gradients of the bf16 K2 cases, replayed ones
too, are expected to differ: every fp32 output, every bf16 K1 and K1s output
(``saved`` as values) and every other bf16 gradient must keep its bits, and
B1's and B2's fp32 SASS and K1's in both modes must be the same; it fails
too if no bias differs.

    python3 tools/torch_kernel_bits.py --compare A B --bf16-bias-differs

The record also holds every kernel's SASS in both libraries (the libraries
of the default encoded widths, 63 / 27); ``--compare`` says for each whether
it is the same in both, and with ``--same-sass`` (two trees that must
compile to the same code) fails unless every one is.

    python3 tools/torch_kernel_bits.py --compare A B --same-sass
"""

import argparse
import hashlib
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import torch

from torch_train_compare import R_TRAIN, level_inputs

B1 = "level_bwd_delta_kernel"
B2 = "level_bwd_dw_kernel"  # in fp32; B2 in bf16 mode is level_bwd_dw_bf16_kernel
# The gradients pass B2 computes (the weight products and their biases); B1
# computes the heads' (wd, bd, wr, br, wvb).
B2_GRADS = ("w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4", "w5x", "w5i", "b5", "w6", "b6",
            "w7", "b7", "wb", "bb", "wva", "bv")
BIASES = tuple(n for n in B2_GRADS if n.startswith("b"))  # B2's in fp32; in bf16 mode B1 sums them
K1 = "fused_render_level_kernel"
K1S = "level_fwd_spill_kernel"
B2_BF16 = "level_bwd_dw_bf16_kernel"
R_SERVE = 4096
R_PRESET = 224  # config/vanilla_tpu_fast.json's batch
OUTPUTS = ("comp", "acc", "depth", "weights")
SAVED_CASE = "bf16 K2 from K1s' saved"
REPLAY_CASE = "bf16 K2 from the replayed saved"


def kernel_sass(lib_path: str, kernel: str = B1, bf16: bool = False) -> list:
    """A kernel's SASS lines in fp32 (its only instantiation, or the one
    whose mangled name holds ``ILb0E``) or, with ``bf16``, in bf16 mode
    (``ILb1E``; empty for a tree without it), from the ``Function :`` header
    to the next one, each with its runs of blanks made one (cuobjdump pads
    its columns to the longest line of the whole library). The header, which
    holds the mangled signature, is left out."""
    from aonerf_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    lines, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line and (("ILb1E" in line) == bf16)
        elif inside:
            lines.append(" ".join(line.split()))
    if not lines and not bf16:
        raise SystemExit(f"torch_kernel_bits: no SASS of {kernel} in {lib_path}")
    return lines


def all_sass(lib_path: str) -> dict:
    """Every kernel's SASS lines in a library, by its mangled name (as
    :func:`kernel_sass` gives one kernel's)."""
    from aonerf_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:  # the anonymous namespace's name holds a hash of the source's path: dropped
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", line.split("Function :", 1)[1].strip())
            out[name] = []
        elif name is not None:
            out[name].append(" ".join(line.split()))
    return out


def mma_ops(lines: list) -> dict:
    """The tensor-core instructions of SASS lines (HMMA.<shape>.<types>),
    each with its count."""
    ops = {}
    for line in lines:
        for op in re.findall(r"\bHMMA\.[0-9A-Z.]+", line):
            ops[op] = ops.get(op, 0) + 1
    return ops


def tma_loads(lines: list) -> int:
    """The TMA load instructions (UTMALDG) among SASS lines."""
    return sum("UTMALDG" in line for line in lines)


def sass_ops(lines: list) -> dict:
    """The tensor-core (HMMA), ldmatrix (LDSM) and TMA (UTMALDG) instructions
    of SASS lines, each with its count."""
    ops = mma_ops(lines)
    for op in ("LDSM", "UTMALDG"):
        ops[op] = sum(bool(re.search(rf"\b{op}\b", line)) for line in lines)
    return ops


def sass_sha1(lines: list) -> str:
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()


def tensor_sha1(x: torch.Tensor) -> str:
    if x.dtype == torch.bfloat16:  # numpy has no bf16: hash its 16 bits
        x = x.view(torch.int16)
    return hashlib.sha1(x.contiguous().cpu().numpy()).hexdigest()


def cotangents(R: int, S: int, device):
    rng = np.random.default_rng(S + 1)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R),
        rng.standard_normal((R, S))))


def record(out: str, replay: str = None) -> None:
    from aonerf_torch.models.mlp import NeRFMLP
    from aonerf_torch.ops.kernels import build
    from aonerf_torch.ops.kernels import fused_render as fr
    from aonerf_torch.ops.kernels import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build.build(["fused_train", "fused_render"])
    lib, k1_lib = str(libs["fused_train"]), str(libs["fused_render"])
    sass, sass_bf16, b2_sass = kernel_sass(lib), kernel_sass(lib, bf16=True), kernel_sass(lib, B2)
    more = {"k1_sass": kernel_sass(k1_lib, K1), "k1_bf16_sass": kernel_sass(k1_lib, K1, bf16=True),
            "k1s_sass": kernel_sass(lib, K1S)}
    b2_bf16_ops = sass_ops(kernel_sass(lib, B2_BF16))
    every = {f"{os.path.basename(path).split('-')[0]} {k}": v for path in (lib, k1_lib) for k, v in all_sass(path).items()}
    print(f"every kernel's SASS: {len(every)} functions", flush=True)
    print(f"B1 SASS: {len(sass)} lines, sha1 {sass_sha1(sass)}; in bf16 mode the mma instructions "
          f"{mma_ops(sass_bf16) or 'none'}", flush=True)
    print(f"B2 SASS (fp32): {len(b2_sass)} lines, sha1 {sass_sha1(b2_sass)}, {tma_loads(b2_sass)} TMA loads (UTMALDG); "
          f"in bf16 mode {b2_bf16_ops}", flush=True)
    for name, lines in more.items():
        print(f"{name}: {len(lines)} lines, sha1 {sass_sha1(lines)}", flush=True)
    modes = (False, True) if "dot_bf16" in inspect.signature(fr.fused_render_level).parameters else (False,)
    cases = {}  # case -> {output name: tensor on the CPU, or the sha1 of a large one}
    payloads = {}  # case -> (saved as bf16, raw) that its gradients came from
    for S in (65, 193):
        mlp = NeRFMLP(generator=torch.Generator().manual_seed(S), device=device)
        with torch.no_grad():
            kp = fr.kernel_params(mlp)
        serve = (kp, *level_inputs(R_SERVE, S, S, device))
        train = (kp, *level_inputs(R_TRAIN, S, S, device))
        cot = cotangents(R_TRAIN, S, device)
        for bf16 in modes:
            mode = {"dot_bf16": True} if bf16 else {}  # fp32 calls as a tree without the mode makes them
            for white in (True, False):
                tag = f"S={S} white={white}"
                pre = "bf16 " if bf16 else ""
                cases[f"{pre}K1 R={R_SERVE} {tag}"] = {
                    n: v.cpu() for n, v in zip(OUTPUTS, fr.fused_render_level(*serve, white, **mode))}
                *outs, saved, raw = ft.fused_level_fwd_spill(*train, white, **mode)
                k1s = {n: v.cpu() for n, v in zip(OUTPUTS, outs)}
                k1s["raw"] = raw.cpu()
                k1s["saved sha1"] = tensor_sha1(saved.to(torch.bfloat16) if bf16 else saved)  # bf16 values: exact
                cases[f"{pre}K1s R={R_TRAIN} {tag}"] = k1s
                g = ft.fused_level_bwd_saved(*train, saved, raw, *cot, white, **mode)
                cases[f"{pre}K2 from K1s' saved R={R_TRAIN} {tag}"] = {n: v.cpu() for n, v in g.items()}
                del outs, saved, raw
                *_, saved, raw = ft.fused_level_fwd_spill_ref(*train, white, **mode)
                g = ft.fused_level_bwd_saved(*train, saved, raw, *cot, white, **mode)
                cases[f"{pre}K2 from plain saved R={R_TRAIN} {tag}"] = {n: v.cpu() for n, v in g.items()}
                del saved, raw
                print(f"recorded {pre}{tag}", flush=True)
        if len(modes) == 2:  # at the fast preset's batch: K2 bf16 from K1s' saved, which the record keeps
            preset = (kp, *level_inputs(R_PRESET, S, S, device))
            cot = cotangents(R_PRESET, S, device)
            *_, saved, raw = ft.fused_level_fwd_spill(*preset, True, dot_bf16=True)
            g = ft.fused_level_bwd_saved(*preset, saved, raw, *cot, True, dot_bf16=True)
            case = f"{SAVED_CASE} R={R_PRESET} S={S} white=True"
            cases[case] = {n: v.cpu() for n, v in g.items()}
            payloads[case] = (saved.to(torch.bfloat16).cpu(), raw.cpu())  # bf16 values: exact
            del saved, raw
            if replay is not None:  # given as the dtype this tree's K1s writes
                dtype = ft.saved_dtype(True) if hasattr(ft, "saved_dtype") else torch.float32
                saved, raw = (x.to(device) for x in torch.load(replay)["payloads"][case])
                g = ft.fused_level_bwd_saved(*preset, saved.to(dtype), raw, *cot, True, dot_bf16=True)
                cases[f"{REPLAY_CASE} R={R_PRESET} S={S} white=True"] = {n: v.cpu() for n, v in g.items()}
                del saved, raw
            print(f"recorded bf16 K2 at R={R_PRESET} S={S}" + (f", and from {replay}'s saved" if replay else ""),
                  flush=True)
    torch.save({"sass": sass, "b1_bf16_mma": mma_ops(sass_bf16), "b2_sass": b2_sass, **more,
                "b2_bf16_ops": b2_bf16_ops, "all_sass": every, "cases": cases, "payloads": payloads}, out)
    print(f"saved {sum(len(v) for v in cases.values())} outputs of {len(cases)} cases to {out}")


def same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def expected_difference(case: str, output: str, b2_bf16_differs: bool, bf16_fwd_differs: bool = False,
                        b1_bf16_differs: bool = False, bf16_bias_differs: bool = False) -> bool:
    if bf16_fwd_differs and case.startswith(("bf16 K1 ", "bf16 K1s ", SAVED_CASE)):
        return True
    if b1_bf16_differs and case.startswith("bf16 K2 "):
        return True
    if bf16_bias_differs and case.startswith("bf16 K2 ") and output in BIASES:
        return True
    return b2_bf16_differs and case.startswith("bf16 K2 ") and output in B2_GRADS


def compare_replays(x: dict, y: dict, a: str, b: str, expected: bool = False, only=None) -> int:
    """Holds each replayed case of one file to the bits of its case from K1s'
    saved in the other; returns the number of outputs that differ (with
    ``expected``, of those it names as expected to differ), not counting the
    outputs in ``only`` where it is given (those expected to differ)."""
    n_diff = 0
    for name, f, g, other in ((b, y, x, a), (a, x, y, b)):
        for case in (c for c in f["cases"] if c.startswith(REPLAY_CASE)):
            want = g["cases"].get(SAVED_CASE + case[len(REPLAY_CASE):])
            if want is None:
                print(f"  {case} in {name}: {other} holds no case to hold it to")
                continue
            got = f["cases"][case]
            diff = [n for n in want if not same(got[n], want[n])]
            n_diff += len([n for n in diff if only is None or n not in only])
            print(f"  {case} in {name} against {other}'s from K1s' saved: {len(want) - len(diff)} of {len(want)} "
                  "gradients equal bit for bit" + (f"; {'expected to differ' if expected else 'differ'}: "
                                                  f"{' '.join(diff)}" if diff else ""))
    return n_diff


def compare_all_sass(x: dict, y: dict) -> list:
    """Prints, for every kernel of both libraries, whether its SASS is the
    same in both records; returns the kernels whose SASS differs or that one
    record lacks (all of them where a record holds none)."""
    if "all_sass" not in x or "all_sass" not in y:
        print("every kernel's SASS: not recorded in both files")
        return ["(not recorded)"]
    moved = []
    for name in sorted(set(x["all_sass"]) | set(y["all_sass"])):
        p, q = x["all_sass"].get(name), y["all_sass"].get(name)
        state = "only in one" if p is None or q is None else "identical" if p == q else "differs"
        if state != "identical":
            moved.append(name)
        print(f"  SASS {name}: {state}" + (f" ({len(p)} / {len(q)} lines)" if p is not None and q is not None else ""))
    print(f"every kernel's SASS: {len(set(x['all_sass']) | set(y['all_sass'])) - len(moved)} of "
          f"{len(set(x['all_sass']) | set(y['all_sass']))} identical")
    return moved


def compare(a: str, b: str, b2_bf16_differs: bool = False, bf16_fwd_differs: bool = False,
            b1_bf16_differs: bool = False, bf16_bias_differs: bool = False, same_sass: bool = False) -> None:
    x, y = torch.load(a), torch.load(b)
    every_moved = compare_all_sass(x, y)
    hx, hy = sass_sha1(x["sass"]), sass_sha1(y["sass"])
    print(f"B1 SASS {'identical' if hx == hy else 'differs'} ({len(x['sass'])} / {len(y['sass'])} lines, sha1 "
          f"{hx} / {hy}); " + ("required identical" if b1_bf16_differs or bf16_bias_differs else "for information only"))
    print("B1 bf16 mma instructions: " + " / ".join(str(f.get("b1_bf16_mma") or "not recorded") for f in (x, y)))
    if "b2_sass" in x and "b2_sass" in y:
        bx, by = sass_sha1(x["b2_sass"]), sass_sha1(y["b2_sass"])
        print(f"B2 SASS (fp32) {'identical' if bx == by else 'differs'} ({len(x['b2_sass'])} / {len(y['b2_sass'])} "
              f"lines, sha1 {bx} / {by}, TMA loads {tma_loads(x['b2_sass'])} / {tma_loads(y['b2_sass'])}); "
              + ("required identical" if bf16_bias_differs else "for information only"))
    sass_moved = [] if hx == hy else ["B1 (fp32)"]
    if "b2_sass" in x and "b2_sass" in y and sass_sha1(x["b2_sass"]) != sass_sha1(y["b2_sass"]):
        sass_moved.append("B2 (fp32)")
    for key in ("k1_sass", "k1_bf16_sass", "k1s_sass"):
        if key in x and key in y:
            kx, ky = sass_sha1(x[key]), sass_sha1(y[key])
            print(f"{key} {'identical' if kx == ky else 'differs'} ({len(x[key])} / {len(y[key])} lines); "
                  + ("required identical" if bf16_bias_differs and key != "k1s_sass" else "for information only"))
            if kx != ky and key != "k1s_sass":
                sass_moved.append(key)
    print("B2 bf16 instructions: " + " / ".join(str(f.get("b2_bf16_ops") or "not recorded") for f in (x, y)))
    common = [case for case in x["cases"] if case in y["cases"] and not case.startswith(REPLAY_CASE)]
    for name, f, g in ((a, x, y), (b, y, x)):
        only = sorted(case for case in f["cases"] if case not in g["cases"] and not case.startswith(REPLAY_CASE))
        if only:
            print(f"  only in {name}, not compared: {', '.join(only)}")
    if not common:
        raise SystemExit("torch_kernel_bits: the files hold no case in common")
    n_diff = n_all = n_expected = n_expected_diff = 0
    for case in common:
        p, q = x["cases"][case], y["cases"][case]
        diff = [n for n in p if not same(p[n], q[n])]
        expected = [n for n in p if expected_difference(case, n, b2_bf16_differs, bf16_fwd_differs, b1_bf16_differs,
                                                        bf16_bias_differs)]
        unexpected = [n for n in diff if n not in expected]
        n_diff, n_all = n_diff + len(unexpected), n_all + len(p) - len(expected)
        n_expected, n_expected_diff = n_expected + len(expected), n_expected_diff + len(diff) - len(unexpected)

        def detail(names):
            return "".join(f" {n}" + ("" if isinstance(p[n], str) else
                                      f" (max abs diff {(p[n].double() - q[n].double()).abs().max().item():.3e})")
                           for n in names)
        line = (f"  {case}: {len(p) - len(expected) - len(unexpected)} of {len(p) - len(expected)} outputs equal "
                "bit for bit")
        if unexpected:
            line += f"; differ:{detail(unexpected)}"
        if expected:
            moved = [n for n in expected if n in diff]
            line += f"; expected to differ: {len(moved)} of {len(expected)} differ" + (
                f":{detail(moved)}" if moved else "")
        print(line)
    n_replay_diff = compare_replays(x, y, a, b, expected=b1_bf16_differs or bf16_bias_differs,
                                    only=BIASES if bf16_bias_differs else None)
    any_expected = b2_bf16_differs or bf16_fwd_differs or b1_bf16_differs or bf16_bias_differs
    print(f"outputs equal bit for bit: {n_all - n_diff} of {n_all}"
          + (f"; outputs expected to differ that differ: {n_expected_diff} of {n_expected}" if any_expected else ""))
    if n_diff or (n_replay_diff and not b1_bf16_differs):
        sys.exit(1)
    if b1_bf16_differs and hx != hy:
        raise SystemExit("torch_kernel_bits: B1's fp32 SASS differs")
    if bf16_bias_differs and sass_moved:
        raise SystemExit(f"torch_kernel_bits: SASS differs where it must not: {', '.join(sass_moved)}")
    if any_expected and not n_expected_diff:
        raise SystemExit("torch_kernel_bits: outputs were expected to differ, but none does")
    if same_sass and every_moved:
        raise SystemExit(f"torch_kernel_bits: SASS differs where it must not: {', '.join(every_moved)}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="file to save this tree's outputs to")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two files written by --out")
    parser.add_argument("--b2-bf16-differs", action="store_true",
                        help="expect B2's gradients in the bf16 K2 cases to differ, and nothing else")
    parser.add_argument("--bf16-fwd-differs", action="store_true",
                        help="expect the bf16 K1 and K1s outputs (and K2 from K1s' saved) to differ, and nothing else")
    parser.add_argument("--b1-bf16-differs", action="store_true",
                        help="expect the bf16 K2 gradients to differ, B1's fp32 SASS the same, and nothing else")
    parser.add_argument("--bf16-bias-differs", action="store_true",
                        help="expect the ten bias gradients of the bf16 K2 cases to differ, fp32 B1/B2 and K1 SASS the "
                             "same, and nothing else")
    parser.add_argument("--same-sass", action="store_true",
                        help="require every kernel's SASS in both libraries to be identical")
    parser.add_argument("--replay", help="with --out: also run this tree's bf16 K2 on the saved that this file holds")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare, b2_bf16_differs=args.b2_bf16_differs, bf16_fwd_differs=args.bf16_fwd_differs,
                b1_bf16_differs=args.b1_bf16_differs, bf16_bias_differs=args.bf16_bias_differs,
                same_sass=args.same_sass)
    elif args.out:
        if not torch.cuda.is_available():
            raise SystemExit("torch_kernel_bits: needs a CUDA card")
        record(args.out, args.replay)
    else:
        parser.error("give --out or --compare")


if __name__ == "__main__":
    main()
