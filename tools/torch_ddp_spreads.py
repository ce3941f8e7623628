"""The fp32 spread of each gradient leaf and loss part of the data-parallel
train steps that ``tests/test_torch_parallel_steps.py`` holds to JAX: the
same cases (``build_cases``), JAX's 2-device step in fp32, the port's
2-rank step in fp32 and in fp64 (each rank's contribution run in this
process and summed, ``rank_sum``; the vanilla levels through the plain
versions in fp64, ``chip_smoke._plain_level``). Prints, per case, each
layer's max abs error / max |fp64| of JAX's and of the port's gradients,
the larger, rounded up at 2 significant digits (those above 5e-5), and
each loss part's relative error, the larger: the test's DDP_SPREAD and
LOSS_RTOL come from this output.

    PYTHONPATH=. python tools/torch_ddp_spreads.py      # on the CPU, ~3 min
"""

import math
import os
import tempfile
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from aonerf_torch.models import nerf as nerf_mod  # noqa: E402
from tests import test_torch_parallel_steps as t  # noqa: E402


def up2(x: float) -> float:
    """x rounded up at 2 significant digits."""
    e = math.floor(math.log10(x)) - 1
    return float(f"{math.ceil(x / 10**e) * 10**e:.3g}")


def err(x, ref) -> float:
    return float(np.abs(np.asarray(x, np.float64) - ref).max() / (np.abs(ref).max() + 1e-300))


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cases, want = t.build_cases(lambda name: tempfile.mkdtemp(prefix=f"{name}_", dir=tmp), jax.devices())
        for name, kind, args in cases:
            if name not in t.JAX_CASES:
                continue
            p32 = t.rank_sum(kind, args)
            with mock.patch.object(nerf_mod, "fused_level", chip_smoke._plain_level):
                p64 = t.rank_sum(kind, args, double=True)
            j32, jm = want[name]
            spread = {}
            for n, ref in p64["grads"].items():
                if ref is None:
                    continue
                e = max(err(j32[n], ref), err(p32["grads"][n], ref))
                spread[t.group(n)] = max(spread.get(t.group(n), 0.0), e)
            table = {g: up2(v) for g, v in sorted(spread.items()) if v > 5e-5}
            print(f"{name}: largest below 5e-5 {max([v for v in spread.values() if v <= 5e-5], default=0):.2e}")
            print(f'    "{name}": {table},')
            parts = {k: max(abs(jm[k] - p64["metrics"][k]), abs(p32["metrics"][k] - p64["metrics"][k]))
                     / abs(p64["metrics"][k]) for k in t.LOSS_PARTS if k in jm}
            print(f"    loss parts (relative): {({k: f'{v:.2e}' for k, v in parts.items()})}")


if __name__ == "__main__":
    main()
