"""The port's native scene loader (``aonerf_torch.native``) on the CPU
against ``aonerf.native``, the PNG's own arrays and the port's PIL path:
decoded PNGs, a whole scene's ray buffers bit for bit, the datasets'
buffers, a failed build raising and two processes building at once."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import aonerf.native as jnative
import aonerf_torch.native as native
from aonerf.data.sapien import SapienDataset as JaxSapienDataset
from aonerf.data.sapien_multi import SapienMultiDataset as JaxSapienMultiDataset
from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np
from aonerf_torch.data.sapien import SapienDataset
from aonerf_torch.data.sapien_multi import SapienMultiDataset
from aonerf_torch.data.synthetic import generate_multi_scene, generate_single_scene

ROOT = Path(__file__).resolve().parents[1]
WH = (64, 48)
# The native path against the PIL path, as the JAX package holds its own
# (tests/test_data.py): the ray directions are normalized in float32 in C++
# (1/sqrt, three products) and in numpy (a division by the norm), up to an
# ulp of a unit vector's component apart; the rgb blend r*a + bg*(1-a)
# against numpy's (r*a + 1) - a, an ulp of values in [0, 1] apart.
TOL_RAYS_D = 3e-7
TOL_RGB = 2e-7


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("AONERF_NO_NATIVE", raising=False)


@pytest.fixture(scope="module")
def single_root(tmp_path_factory):
    return generate_single_scene(str(tmp_path_factory.mktemp("single")), img_wh=WH, n_train=3, n_val=1, n_test=1)


@pytest.fixture(scope="module")
def multi_root(tmp_path_factory):
    return generate_multi_scene(str(tmp_path_factory.mktemp("multi")), img_wh=WH, n_instances=2, degrees=(0, 30),
                                n_images=2)


def _no_native_on_both(monkeypatch):
    monkeypatch.setenv("AONERF_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_lib_tried", False)  # the JAX loader reads the flag once
    monkeypatch.setattr(jnative, "_lib", None)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA"])
def test_decode_png_u8_equals_jax_and_the_png(tmp_path, mode):
    rng = np.random.default_rng(11)
    channels = {"RGBA": 4, "RGB": 3, "L": 1, "LA": 2}[mode]
    arr = rng.integers(0, 256, size=(30, 40, channels), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode=mode).save(path)
    want = np.asarray(Image.open(path).convert("RGBA"))  # PIL's RGBA of the file
    got = native.decode_png_u8_native(path, 40, 30)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.decode_png_u8_native(path, 40, 30))
    # another size: None on both sides (the caller resizes through PIL)
    assert native.decode_png_u8_native(path, 20, 15) is None
    assert jnative.decode_png_u8_native(path, 20, 15) is None


@pytest.mark.parametrize("white", [True, False])
def test_decode_png_native_equals_jax(tmp_path, white):
    rng = np.random.default_rng(12)
    arr = rng.integers(0, 256, size=(30, 40, 4), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(arr, mode="RGBA").save(path)
    out = {}
    for name, mod in (("port", native), ("jax", jnative)):
        rgb, alpha = np.empty((1200, 3), np.float32), np.empty(1200, np.float32)
        assert mod.decode_png_native(path, 40, 30, white, rgb, alpha)
        out[name] = (rgb, alpha)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["port"][1], arr[..., 3].reshape(-1) * np.float32(1 / 255))


def test_load_scene_native_equals_jax_bit_for_bit(single_root):
    base = os.path.join(single_root, "train")
    with open(os.path.join(base, "transforms.json")) as f:
        meta = json.load(f)
    names = sorted(meta["frames"])
    c2ws = np.stack([np.asarray(meta["frames"][k], np.float32)[:3, :4] for k in names])
    directions = get_ray_directions_np(WH[1], WH[0], focal_from_meta(meta, WH))
    n = len(names) * WH[0] * WH[1]
    out = {}
    for name, mod in (("port", native), ("jax", jnative)):
        bufs = [np.full((n, 3), np.nan, np.float32) for _ in range(3)] + [np.full(n, np.nan, np.float32)]
        assert mod.load_scene_native([os.path.join(base, "rgb", k + ".png") for k in names], c2ws, directions,
                                     WH[1], WH[0], True, *bufs, n_threads=2)
        out[name] = bufs
    for a, b in zip(out["port"], out["jax"]):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_native_path_against_the_pil_path(single_root, monkeypatch):
    loads = native.scene_loads
    nat = SapienDataset(single_root, "train", img_wh=WH)
    assert native.scene_loads == loads + 1
    monkeypatch.setenv("AONERF_NO_NATIVE", "1")
    assert native.get_loader() is None
    pil = SapienDataset(single_root, "train", img_wh=WH)
    assert native.scene_loads == loads + 1
    np.testing.assert_array_equal(nat.all_rays_o, pil.all_rays_o)
    np.testing.assert_allclose(nat.all_rays_d, pil.all_rays_d, rtol=0, atol=TOL_RAYS_D)
    np.testing.assert_allclose(nat.all_rgbs, pil.all_rgbs, rtol=0, atol=TOL_RGB)
    assert nat.all_viewdirs is nat.all_rays_d


@pytest.mark.parametrize("path", ["native", "pil"])
def test_sapien_dataset_buffers_equal_jax(single_root, monkeypatch, path):
    if path == "pil":
        _no_native_on_both(monkeypatch)
    port = SapienDataset(single_root, "train", img_wh=WH)
    jax_ds = JaxSapienDataset(single_root, "train", img_wh=WH)
    for k in ("all_rays_o", "all_rays_d", "all_rgbs"):
        np.testing.assert_array_equal(getattr(port, k), getattr(jax_ds, k), err_msg=k)


@pytest.mark.parametrize("path", ["native", "pil"])
def test_sapien_multi_dataset_buffers_equal_jax(multi_root, monkeypatch, path):
    if path == "pil":
        _no_native_on_both(monkeypatch)
    decodes = native.png_decodes
    port = SapienMultiDataset(multi_root, "train", img_wh=WH)
    # 2 instances x 2 degrees x 2 views, an rgb and a seg file each
    assert native.png_decodes - decodes == (16 if path == "native" else 0)
    jax_ds = JaxSapienMultiDataset(multi_root, "train", img_wh=WH)
    assert port.focal == jax_ds.focal
    for key, view in port._views.items():
        for a, b in zip(view, jax_ds._views[key]):
            np.testing.assert_array_equal(a.rgb, b.rgb)
            np.testing.assert_array_equal(a.mask, b.mask)
            np.testing.assert_array_equal(a.c2w, b.c2w)


BROKEN_CPP = 'extern "C" int aonerf_decode_png(const char* p) { return undeclared_name; }\n'


@pytest.mark.parametrize("case", ["source", "compiler"])
def test_a_failed_build_raises(tmp_path, monkeypatch, case):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    if case == "source":
        src = tmp_path / "loader.cpp"
        src.write_text(BROKEN_CPP)
        monkeypatch.setattr(native, "SRC", src)
        match = "undeclared_name"  # the compiler's own message
    else:
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g\\+\\+"
    with pytest.raises(RuntimeError, match=match):
        native.get_loader()
    with pytest.raises(RuntimeError, match=match):  # the dataset does not fall back to PIL
        native.load_scene_native([], np.zeros((0, 12), np.float32), np.zeros((1, 3), np.float32), 1, 1, True,
                                 *(np.empty((0, 3), np.float32) for _ in range(3)))
    assert not any((tmp_path / "build").glob("*.so")) and not any((tmp_path / "build").glob("*.tmp*"))


_BUILD_AND_DECODE = textwrap.dedent("""
    import sys
    from pathlib import Path
    import aonerf_torch.native as native
    native.BUILD_DIR = Path(sys.argv[1])
    out = native.decode_png_u8_native(sys.argv[2], 40, 30)
    print(native._lib._name, int(out.sum()))
""")


def test_two_processes_build_at_once(tmp_path):
    img = str(tmp_path / "img.png")
    arr = np.random.default_rng(13).integers(0, 256, size=(30, 40, 4), dtype=np.uint8)
    Image.fromarray(arr, mode="RGBA").save(img)
    build = tmp_path / "build"
    env = dict(os.environ)
    env.pop("AONERF_NO_NATIVE", None)
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE, str(build), img], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        lib, total = out.split()
        assert Path(lib).parent == build and int(total) == int(arr.astype(np.int64).sum())
    assert [p.name for p in build.iterdir()] == [native._lib_path().name]
