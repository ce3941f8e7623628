"""How often the Trainer's ``profile_steps`` trace loses a K1s launch, on
the card: 28 fresh vanilla Trainer sessions (config/vanilla.json on a
320x240 scene, 5 steps a dispatch, profile_steps 5), every other one with
the profiler's start followed by a synchronize and 50 ms; prints each
session's K1s and B2 counts in the trace (10 each when nothing is lost).

    PYTHONPATH=. python3 tools/torch_profile_probe.py
"""
import contextlib
import os
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aonerf_torch.data.synthetic import generate_single_scene  # noqa: E402
from aonerf_torch.train.loop import Trainer  # noqa: E402
from aonerf_torch.utils.config import load_config  # noqa: E402
from aonerf_torch.utils.profile import latest_trace, timed_ops  # noqa: E402

orig = Trainer._start_profiler


def settled(self):
    prof = orig(self)
    torch.cuda.synchronize(self.device)
    time.sleep(0.05)
    return prof


def main():
    cs.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        root = generate_single_scene(os.path.join(tmp, "scene"), img_wh=(cs.W, cs.H), n_train=8, n_val=1, n_test=1,
                                     seed=cs.SEED)
        counts = {False: [], True: []}
        for i in range(28):
            settle = i % 2 == 1
            cfg = load_config("config/vanilla.json", {
                "root_dir": root, "output_path": os.path.join(tmp, "out"), "exp_name": f"p{i}", "img_wh": [cs.W, cs.H],
                "inner_steps": 5, "profile_steps": 5, "val_every_steps": 5, "ckpt_every_steps": 5,
                "limit_val_batches": 1, "lr_delay_steps": 0})
            tr = Trainer(cfg)
            with (mock.patch.object(Trainer, "_start_profiler", settled) if settle else contextlib.nullcontext()):
                tr.fit(max_steps=5)
            tr.close()
            _, times = timed_ops(latest_trace(os.path.join(tr.run_dir, "profile")))
            k1s = sum(c for n, (_, c) in times.items() if "level_fwd_spill_kernel" in n)
            k2 = sum(c for n, (_, c) in times.items() if "level_bwd_dw_kernel" in n)
            counts[settle].append((k1s, k2))
            print(f"session {i} settle={settle}: K1s {k1s}, B2 {k2}", flush=True)
        for s, c in counts.items():
            print(f"settle={s}: {sum(k == 10 for k, _ in c)} of {len(c)} sessions with all 10 K1s launches; {c}")


if __name__ == "__main__":
    main()
