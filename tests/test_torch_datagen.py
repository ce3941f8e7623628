"""The port's dataset generation on the CPU against ``aonerf``'s: the datagen
CLI in single (with depth), multi and replay mode, depth rendering and its
PNG, the SAPIEN backend's numpy helpers, its writer and three generators
driven by one fake renderer, and a short fit through the train CLI on a
datagen'd scene."""

import hashlib
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from aonerf.data import synthetic as jsyn
from aonerf.data.datagen import generate as jgen
from aonerf.data.datagen import sapien_backend as jsb
from aonerf_torch.cli import train as cli
from aonerf_torch.data import synthetic
from aonerf_torch.data.datagen import generate as gen
from aonerf_torch.data.datagen import sapien_backend as sb

ROOT = Path(__file__).resolve().parents[1]
WH = (40, 30)


def _tree(root: str) -> dict:
    """Every file under root by its relative path: a PNG as (mode, decoded
    array), a JSON file as its object."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".png"):
                img = Image.open(path)
                out[rel] = (img.mode, np.asarray(img))
            else:
                with open(path) as f:
                    out[rel] = json.load(f)
    return out


def assert_same_tree(a: str, b: str) -> int:
    """The same files under a and b, equal decoded PNGs (mode and every
    value) and equal JSON objects; returns the file count. File bytes are not
    compared: the zlib level may differ between machines."""
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel, va in ta.items():
        vb = tb[rel]
        if rel.endswith(".png"):
            assert va[0] == vb[0], rel
            np.testing.assert_array_equal(va[1], vb[1], err_msg=rel)
        else:
            assert va == vb, rel
    return len(ta)


def _cli(main, cfg: dict, path: str, capsys) -> dict:
    with open(path, "w") as f:
        json.dump(cfg, f)
    main(["--config", path])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["single", "multi", "replay"])
def test_datagen_cli_writes_jax_files(tmp_path, capsys, mode):
    cfg = {"mode": mode, "img_wh": list(WH), "seed": 3}
    if mode == "single":
        cfg.update(n_train=3, n_val=1, n_test=2, articulation_deg=60.0, write_depth=True)
    elif mode == "multi":
        cfg.update(n_instances=2, degrees=[0, 45], n_images=2, val_degrees="default", n_val_images=1)
    else:
        src = synthetic.generate_single_scene(str(tmp_path / "src"), img_wh=(64, 48), n_train=0, n_val=0, n_test=3,
                                              seed=5)
        cfg.update(transforms=os.path.join(src, "test", "transforms.json"), split="replay", articulation_deg=30.0,
                   instance_seed=1, write_depth=True)
    port = _cli(gen.main, {**cfg, "out_dir": str(tmp_path / "port")}, str(tmp_path / "port.json"), capsys)
    ref = _cli(jgen.main, {**cfg, "out_dir": str(tmp_path / "jax")}, str(tmp_path / "jax.json"), capsys)
    assert port == {"out_dir": str(tmp_path / "port"), "backend": "synthetic"}
    assert ref == {"out_dir": str(tmp_path / "jax"), "backend": "synthetic"}
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    # single: 6 rgb + 6 depth + 3 transforms; multi: 2 instances x (2 x 2 + 9 x 1) views x (rgb, seg) + 22
    # transforms; replay: 3 rgb + 3 depth + 1 transforms
    assert n == {"single": 15, "multi": 74, "replay": 7}[mode]


def test_render_depth_and_its_png_equal_jax(tmp_path):
    boxes = synthetic.laptop_scene(50.0, instance_seed=2)
    jboxes = jsyn.laptop_scene(50.0, instance_seed=2)
    c2w = synthetic.random_pose_on_sphere(np.random.default_rng(9))
    focal = 0.5 * WH[1] / np.tan(0.5 * np.deg2rad(synthetic.FOVY_DEG))
    depth = synthetic.render_depth(boxes, c2w, WH[1], WH[0], focal)
    np.testing.assert_array_equal(depth, jsyn.render_depth(jboxes, c2w, WH[1], WH[0], focal))
    assert (depth > 0).any() and (depth == 0).any()  # the laptop and the background
    synthetic.write_depth_png(str(tmp_path / "port.png"), depth)
    jsyn.write_depth_png(str(tmp_path / "jax.png"), depth)
    a, b = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(a), np.clip(depth * 1000.0, 0, 65535).astype(np.uint16))


def test_sapien_backend_helpers_equal_jax():
    assert (sb.FOVY_DEG, sb.NEAR, sb.FAR, sb.SPHERE_RADIUS, sb.RADIUS_JITTER) == (
        jsb.FOVY_DEG, jsb.NEAR, jsb.FAR, jsb.SPHERE_RADIUS, jsb.RADIUS_JITTER)
    rng, jrng = np.random.default_rng(21), np.random.default_rng(21)
    for kwargs in ({}, {"radius": 2.5, "theta_range": (0.5, 1.0), "phi_range": (0.2, 0.4)}):
        for _ in range(5):
            p = sb.sample_sphere_point(rng, **kwargs)
            np.testing.assert_array_equal(p, jsb.sample_sphere_point(jrng, **kwargs))
            np.testing.assert_array_equal(sb.camera_extrinsic_mat44(p), jsb.camera_extrinsic_mat44(p))
    data = np.random.default_rng(22)
    rgba = data.uniform(-0.1, 1.1, size=(30, 40, 4))
    seg = data.integers(0, 3, size=(30, 40, 4)).astype(np.uint32)
    np.testing.assert_array_equal(sb.seg_masked_rgba(rgba, seg), jsb.seg_masked_rgba(rgba, seg))
    pos = data.uniform(-80.0, 2.0, size=(30, 40, 4)).astype(np.float32)
    np.testing.assert_array_equal(sb.depth_mm_u16(pos), jsb.depth_mm_u16(pos))
    np.testing.assert_array_equal(sb.qpos_for_degrees(3, 37.5), jsb.qpos_for_degrees(3, 37.5))
    for h in (30, 48, 240):
        assert sb.focal_from_fovy(h) == jsb.focal_from_fovy(h)
        assert sb.focal_from_fovy(h, 50.0) == jsb.focal_from_fovy(h, 50.0)


class FakeRenderer:
    """Stands in for ``SapienSceneRenderer`` on both sides: each frame's
    textures are drawn from a seed hashed from the camera point and the
    joint positions, so both packages' writers get the same frames."""

    def __init__(self, urdf_file, img_wh=(512, 512)):
        self.w, self.h = img_wh
        self.n_dof = 2
        self.camera = SimpleNamespace(fy=0.5 * self.h / np.tan(0.5 * np.deg2rad(35.0)))

    def render_at(self, point, qpos=None):
        key = np.asarray(point, np.float64).tobytes() + (b"" if qpos is None else np.asarray(qpos).tobytes())
        rng = np.random.default_rng(int.from_bytes(hashlib.sha1(key).digest()[:8], "little"))
        h, w = self.h, self.w
        mat44 = np.eye(4)
        mat44[:3, 3] = point
        mat44[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        return {
            "rgba": rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8),
            "depth_mm": rng.integers(0, 65536, size=(h, w), dtype=np.uint16),
            "seg_actor": rng.integers(0, 4, size=(h, w), dtype=np.uint8),
            "c2w": mat44 @ np.diag([1.0, -1.0, -1.0, 1.0]),
            "mat44": mat44,
        }


@pytest.fixture
def fake_renderer(monkeypatch):
    monkeypatch.setattr(sb, "SapienSceneRenderer", FakeRenderer)
    monkeypatch.setattr(jsb, "SapienSceneRenderer", FakeRenderer)


def test_have_sapien_is_false_on_both():
    assert gen.have_sapien() is False and jgen.have_sapien() is False


@pytest.mark.parametrize("what", ["write_split", "single", "multi", "replay"])
def test_sapien_generators_write_jax_files(tmp_path, fake_renderer, what):
    out = {}
    for name, mod, gmod in (("port", sb, gen), ("jax", jsb, jgen)):
        base = str(tmp_path / name)
        if what == "write_split":
            rng = np.random.default_rng(4)
            points = [mod.sample_sphere_point(rng) for _ in range(3)]
            mod._write_split(FakeRenderer("x.urdf", WH), os.path.join(base, "train"), points,
                             mod.qpos_for_degrees(2, 20.0), write_seg=True,
                             pose_out=os.path.join(base, "poses", "train.json"))
            continue
        cfg = {"urdf_file": "x.urdf", "out_dir": base, "img_wh": list(WH), "seed": 6}
        if what == "single":
            cfg.update(counts={"train": 3, "test": 1, "val": 1}, articulation_deg=15.0,
                       save_render_pose_dir=os.path.join(base, "poses"))
        elif what == "multi":
            cfg.update(mode="multi", urdf_files=["a.urdf", "b.urdf"], degrees=[0, 30], n_images=2)
        else:
            poses = str(tmp_path / f"{name}_poses")
            mod.generate_sapien_scene({**cfg, "out_dir": str(tmp_path / f"{name}_src"),
                                       "counts": {"train": 2, "test": 1}, "save_render_pose_dir": poses})
            cfg.update(mode="replay", render_pose_path=poses, splits=["train", "test"], articulation_deg=10.0)
        assert gmod.generate_with_sapien(cfg) == base
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    # write_split: 3 x (rgb, depth, seg) + transforms + poses; single: 5 x (rgb, depth) + 3 transforms + 3
    # poses; multi: 2 instances x 2 splits x 2 degrees x (2 x 3 + 1); replay: 3 x (rgb, depth) + 2 transforms
    assert n == {"write_split": 11, "single": 16, "multi": 56, "replay": 8}[what]


def test_short_cpu_fit_on_a_datagen_scene(tmp_path, capsys):
    out = _cli(gen.main, {"mode": "single", "out_dir": str(tmp_path / "scene"), "img_wh": list(WH), "n_train": 2,
                          "n_val": 1, "n_test": 1, "write_depth": True}, str(tmp_path / "gen.json"), capsys)
    metrics = cli.main([
        "--config", str(ROOT / "config" / "vanilla.json"), "--platform", "cpu", "--root_dir", out["out_dir"],
        "--output_path", str(tmp_path / "out"), "--img_wh", json.dumps(list(WH)), "--num_coarse_samples", "4",
        "--num_fine_samples", "8", "--batch_size", "32", "--chunk", "600", "--inner_steps", "1",
        "--val_every_steps", "2", "--ckpt_every_steps", "2", "--limit_val_batches", "1", "--max_steps", "2",
    ])
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_psnr"])
    run = tmp_path / "out" / "sapien_vanilla"
    assert "ckpt_00000002.pt" in os.listdir(run / "ckpts")
