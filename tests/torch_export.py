"""Shared by the export CLI tests: a tiny port run's checkpoint carried into
a JAX checkpoint of the same step, both export tools run on it, and their
summaries and PLY files compared."""

import importlib.util
import json
import os

import jax
import numpy as np

from aonerf.train.loop import Trainer as JaxTrainer
from aonerf.utils import config as jconfig
from aonerf_torch.cli import export_voxels as cli
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils import config
from aonerf_torch.utils.bridge import module_flax_tree
from aonerf_torch.viz import voxelgrid as vg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 10  # the tests' grid resolution: 1000 voxels
STEPS = 2  # the port run's steps before its checkpoint
# The two grids differ by fp32 rounding (up to ~5e-5 of the largest value on
# the articulated fields, whose warped points pass through sin(2^9 x)); a
# vertex moves along its edge (0.3 long at RES 10) by that over the edge's
# value difference: 5.6e-5 at most measured on the auto-decoder.
VERT_TOL = 2e-4


def _jax_tool():
    spec = importlib.util.spec_from_file_location("export_voxels_tool", os.path.join(ROOT, "tools", "export_voxels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gap_level(grid: np.ndarray, q_lo: float = 0.5, q_hi: float = 0.9) -> float:
    """A level in the widest gap between consecutive sorted grid values
    between the q_lo and q_hi quantiles: no value sits near it, so grids
    that agree to well within the gap select the same voxels."""
    v = np.sort(grid.ravel())
    i0, i1 = int(q_lo * (len(v) - 1)), int(q_hi * (len(v) - 1))
    i = i0 + int(np.argmax(np.diff(v[i0:i1 + 1])))
    return float(0.5 * (v[i] + v[i + 1]))


def _port_params_as_jax(trainer, jparams):
    """The port Trainer's parameters as a tree of the JAX Trainer's shape."""
    if "codes" in jparams:
        tree = {"model": module_flax_tree(trainer.model), "codes": module_flax_tree(trainer.code_library)}
    else:
        tree = module_flax_tree(trainer.model)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return tree


def train_and_bridge(settings, tmp_path):
    """The port trains STEPS steps on the CPU and checkpoints; the JAX
    Trainer of the same settings saves the port's parameters as its own
    checkpoint at the same step. Returns the two config paths and the
    port's grid at RES (for a threshold)."""
    port = {**settings, "exp_name": "port"}
    trainer = Trainer(config.load_config(None, port))
    try:
        trainer.fit(max_steps=STEPS)
        assert trainer.ckpt.steps() == [STEPS]
        grid = vg.density_grid(cli.density_fn_for(trainer), resolution=RES, device="cpu")
        jax_settings = {**settings, "exp_name": "jax"}
        jtrainer = JaxTrainer(jconfig.load_config(None, jax_settings))
        try:
            tree = _port_params_as_jax(trainer, jax.device_get(jtrainer.state.params))
            jtrainer.ckpt.save(STEPS, jax.device_get(jtrainer.state.replace(step=STEPS, params=tree)))
        finally:
            jtrainer.close()
    finally:
        trainer.close()
    paths = []
    for name, cfg in (("port", port), ("jax", jax_settings)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        paths.append(str(path))
    return paths, grid


def _read_ply(path):
    lines = open(path).read().splitlines()
    n_v = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    n_f = next((int(x.split()[-1]) for x in lines if x.startswith("element face")), 0)
    body = lines[lines.index("end_header") + 1:]
    verts = np.array([[float(t) for t in x.split()] for x in body[:n_v]]).reshape(-1, 3)
    faces = np.array([[int(t) for t in x.split()[1:]] for x in body[n_v:n_v + n_f]], np.int64).reshape(-1, 3)
    return verts, faces


def run_both(paths, tmp_path, capsys, threshold, extra=(), vert_tol=VERT_TOL):
    """Both export tools with --mesh at RES and ``threshold``: the port's
    summary equals the JAX tool's but for the paths, its occupancy PLY is
    byte for byte the JAX tool's, and its mesh has the JAX mesh's faces and
    its vertices within ``vert_tol``. Returns the port's summary."""
    outs = {}
    for name, path, main in (("port", paths[0], cli.main), ("jax", paths[1], _jax_tool().main)):
        argv = ["--config", path, "--out", str(tmp_path / f"{name}_occ.ply"), "--mesh",
                str(tmp_path / f"{name}_mesh.ply"), "--resolution", str(RES), "--threshold", str(threshold), *extra]
        main(argv + (["--platform", "cpu"] if name == "port" else []))
        outs[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, want = outs["port"], outs["jax"]
    assert {k: v for k, v in got.items() if k not in ("out", "mesh")} == \
        {k: v for k, v in want.items() if k not in ("out", "mesh")}
    assert got["step"] == STEPS and got["resolution"] == RES
    assert open(got["out"], "rb").read() == open(want["out"], "rb").read()
    (v, f), (jv, jf) = _read_ply(got["mesh"]), _read_ply(want["mesh"])
    assert np.array_equal(f, jf) and len(v) == got["mesh_verts"] and len(f) == got["mesh_faces"]
    np.testing.assert_allclose(v, jv, rtol=0, atol=vert_tol)
    return got
