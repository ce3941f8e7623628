"""Where a ``profile_steps`` trace loses kernels late in a long process, on
the card: ``chip_smoke.py``'s phases 1-22 in this process, then three of
phase 23's vanilla ``profile_steps`` runs, each trace analysed (kernels,
launches without a kernel, the first kernels, K1s's times), then phase 23
itself. Run it from a tree's root to compare two trees:

    PYTHONPATH=. python3 tools/torch_profile_late_probe.py
"""
import json
import os
import sys
import tempfile
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def analyze(path):
    ev = json.load(open(path))["traceEvents"]
    cats = Counter(e.get("cat") for e in ev)
    kern = sorted([e for e in ev if e.get("cat") == "kernel"], key=lambda e: e["ts"])
    corr_k = {e.get("args", {}).get("correlation") for e in kern}
    launch = sorted([e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e["name"]],
                    key=lambda e: e["ts"])
    orphan = [e for e in launch if e.get("args", {}).get("correlation") not in corr_k]
    k1s = [e for e in kern if "level_fwd_spill_kernel" in e["name"]]
    print(f"  categories {dict(cats)}")
    print(f"  kernels {len(kern)}, K1s {len(k1s)}, launch events {len(launch)} "
          f"({Counter(e['name'] for e in launch)}), without a kernel {len(orphan)}")
    steps = [e for e in ev if str(e.get("name", "")).startswith("ProfilerStep")]
    print(f"  profiler steps {[(e['name'], e['ts'], e.get('dur')) for e in steps]}")
    print(f"  first kernels: {[(e['name'][:40], e['ts'], e.get('dur')) for e in kern[:8]]}")
    print(f"  K1s at {[(e['ts'], e.get('dur'), e.get('args', {}).get('correlation')) for e in k1s]}")
    for e in orphan[:10]:
        print(f"  launch without a kernel: {e['name']} ts {e['ts']} corr {e.get('args', {}).get('correlation')}")
    fl = sorted([e for e in ev if e.get("cat") == "cpu_op" and "FusedLevel" in e.get("name", "")],
                key=lambda e: e["ts"])
    print(f"  FusedLevel ops {len(fl)}: {[(e['name'][:30], e['ts']) for e in fl[:12]]}")


def main():
    cs.phase_device()
    cs.phase_build()
    from aonerf_torch.data.synthetic import FOVY_DEG, laptop_scene
    from aonerf_torch.models.nerf import NeRF

    nerf = NeRF(generator=torch.Generator().manual_seed(cs.SEED), device="cuda").eval()
    boxes = laptop_scene(80.0)
    focal = 0.5 * cs.H / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    cs.phase_kernels(nerf, boxes, focal)
    cs.phase_serving(nerf, boxes, focal)
    cs.phase_spill(nerf, boxes, focal)
    cs.phase_backward(nerf, boxes, focal)
    cs.phase_bf16_kernels(nerf, boxes, focal)
    with tempfile.TemporaryDirectory() as tmp:
        t = cs.phase_training(tmp)
        cs.phase_test(t["cfg_path"], t["val_psnr"])
        cs.phase_bf16_training(tmp, t["root"], t["cfg_path"])
        a = cs.phase_autodecoder(tmp)
        cs.phase_articulated_test(a["cfg_path"])
        ae = cs.phase_autoencoder(tmp)
        cs.phase_ae_test(ae["cfg_path"])
        cs.phase_articulated_bf16_rule(os.path.join(tmp, "multi"))
        for name in cs.PRESETS:
            cs.phase_bf16_preset(tmp, name)
        cs.phase_articulated_turns(tmp)
        cs.phase_optimizers(tmp, t["root"])
        cs.phase_encode_reuse(tmp)
        cs.phase_ragged(tmp)
        cs.phase_noise_kernels(nerf, boxes, focal)
        cs.phase_noise_training(t["root"], tmp)
        from aonerf_torch.train.loop import Trainer
        from aonerf_torch.utils.config import load_config
        from aonerf_torch.utils.profile import latest_trace

        for i in range(3):
            base = {"root_dir": t["root"], "output_path": os.path.join(tmp, "dbg"), "img_wh": [cs.W, cs.H],
                    "seed": cs.SEED, "lr_init": 1e-3, "lr_delay_steps": 0, "inner_steps": cs.PROFILE_STEPS,
                    "limit_val_batches": 1, "exp_name": f"dbg{i}", "is_optimize": True, "ckpt_keep": 1,
                    "steps_per_epoch": cs.PROFILE_STEPS, "val_every_steps": cs.PROFILE_STEPS,
                    "profile_steps": cs.PROFILE_STEPS}
            tr = Trainer(load_config("config/vanilla.json", base))
            tr.fit(max_steps=cs.NOISE_STEPS)
            tr.close()
            print(f"debug session {i}:")
            analyze(latest_trace(os.path.join(tr.run_dir, "profile")))
        try:
            cs.phase_settings(t["root"], tmp)
            print("phase 23 passed")
        except SystemExit:
            print("phase 23 failed")


if __name__ == "__main__":
    main()
