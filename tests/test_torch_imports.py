"""The port stands alone: no module of aonerf_torch, and not chip_smoke.py,
imports JAX or the JAX package; chip_smoke.py refuses to run without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "aonerf")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import aonerf_torch
names = ["aonerf_torch"] + [m.name for m in pkgutil.walk_packages(aonerf_torch.__path__, "aonerf_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
loaded = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def _run(args, cwd, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout
    )


def test_port_modules_import_no_jax_and_no_aonerf():
    proc = _run(["-c", _IMPORT_ALL], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {
        "aonerf_torch.ops.kernels.fused_render", "aonerf_torch.ops.kernels.build",
        "aonerf_torch.models.nerf", "aonerf_torch.eval.render", "aonerf_torch.eval.metrics",
        "aonerf_torch.data.sapien", "aonerf_torch.utils.bridge",
        "aonerf_torch.ops.kernels.fused_train", "aonerf_torch.ops.random", "aonerf_torch.train.lr",
        "aonerf_torch.train.step", "aonerf_torch.train.loop", "aonerf_torch.cli.train",
        "aonerf_torch.utils.config", "aonerf_torch.utils.logging", "aonerf_torch.utils.ckpt",
        "aonerf_torch.eval.viz", "aonerf_torch.eval.io", "aonerf_torch.ops.rays", "aonerf_torch.ops.raybox",
        "aonerf_torch.ops.render", "aonerf_torch.models.articulated", "aonerf_torch.models.codes",
        "aonerf_torch.data.sapien_multi", "aonerf_torch.train.losses", "aonerf_torch.train.optimize",
        "aonerf_torch.models.resnet", "aonerf_torch.models.joint_state", "aonerf_torch.models.ae",
        "aonerf_torch.train.step_ae", "aonerf_torch.utils.transforms", "aonerf_torch.viz.pointcloud",
        "aonerf_torch.viz.voxelgrid", "aonerf_torch.viz.mesh", "aonerf_torch.cli.export_voxels",
        "aonerf_torch.parallel", "aonerf_torch.parallel.distributed", "aonerf_torch.parallel.mesh",
        "aonerf_torch.entry", "aonerf_torch.native", "aonerf_torch.data.segmented", "aonerf_torch.data.datagen",
        "aonerf_torch.data.datagen.generate", "aonerf_torch.data.datagen.sapien_backend",
        "aonerf_torch.viz.conventions", "aonerf_torch.viz.check_poses", "aonerf_torch.viz.cameras",
    }
    assert expected <= set(out["modules"])
    assert not set(FORBIDDEN) & set(out["loaded"]), set(FORBIDDEN) & set(out["loaded"])
    # the card's machine has neither: the plot and the simulator import them when called
    assert not {"matplotlib", "sapien"} & set(out["loaded"])


def test_no_source_names_jax_or_aonerf_in_an_import():
    files = sorted((ROOT / "aonerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN, f"{path}: imports {m}"


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(["chip_smoke.py"], cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
