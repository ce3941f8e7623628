"""Port parity: the articulated scene writer, the sapien_multi loader and the
auto-decoder's on-device batch sampler of aonerf_torch against aonerf, on a
16x12 scene with a held-out val split."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aonerf.data import sapien_multi as jsm
from aonerf.data import synthetic as jsyn
from aonerf.train import step as jstep
from aonerf_torch.data import sapien_multi as sm
from aonerf_torch.data import synthetic
from aonerf_torch.train import step as tstep
from tests.test_torch_articulated import QueueDraws

WH = (16, 12)
DEGREES = (0, 10, 20)
VAL_DEGREES = (5, 15)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi")
    return synthetic.generate_multi_scene(str(root), img_wh=WH, n_instances=2, degrees=DEGREES, n_images=2,
                                          val_degrees=VAL_DEGREES, n_val_images=1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generate_multi_scene_matches_jax(scene, tmp_path):
    want = jsyn.generate_multi_scene(str(tmp_path), img_wh=WH, n_instances=2, degrees=DEGREES, n_images=2,
                                     val_degrees=VAL_DEGREES, n_val_images=1)
    files = _files(scene)
    assert files == _files(want)
    assert len(files) == 2 * (3 * (2 * 2 + 1) + 2 * (2 * 1 + 1))
    for f in files:
        a, b = os.path.join(scene, f), os.path.join(want, f)
        if f.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), f
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)), err_msg=f)


def test_constants_match_jax():
    assert sm.IDX_TO_DEG_TRAIN == jsm.IDX_TO_DEG_TRAIN and sm.IDX_TO_DEG_VAL == jsm.IDX_TO_DEG_VAL
    assert sm.DEFAULT_VAL_DEGREES == jsm.DEFAULT_VAL_DEGREES
    assert (sm.NEAR, sm.FAR) == (jsm.NEAR, jsm.FAR)


def _assert_dict_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_matches_jax(scene, split):
    kw = {"eval_inference": "render"} if split == "test" else {}
    ds = sm.SapienMultiDataset(scene, split=split, img_wh=WH, **kw)
    jds = jsm.SapienMultiDataset(scene, split=split, img_wh=WH, **kw)
    assert sm.SapienMultiDataset.has_val_split(scene) and jsm.SapienMultiDataset.has_val_split(scene)
    assert ds.uses_val_split == jds.uses_val_split == (split == "val")
    assert ds.n_instances == jds.n_instances == 2
    assert ds.focal == jds.focal and (ds.near, ds.far) == (jds.near, jds.far)
    np.testing.assert_array_equal(ds.degrees_rad(), jds.degrees_rad())
    for ii in range(2):
        assert ds.n_articulations(ii) == jds.n_articulations(ii) == (2 if split == "val" else 3)
        for di in range(ds.n_articulations(ii)):
            assert ds.n_images(ii, di) == jds.n_images(ii, di)
            for vi in range(ds.n_images(ii, di)):
                _assert_dict_equal(ds.get_image(ii, di, vi), jds.get_image(ii, di, vi))
    _assert_dict_equal(ds.device_buffers(), jds.device_buffers())
    if split == "test":
        for pose in (0, 5, 18):
            _assert_dict_equal(ds.get_test_image(1, pose), jds.get_test_image(1, pose))


def test_has_val_split_needs_every_instance(scene, tmp_path):
    root = synthetic.generate_multi_scene(str(tmp_path), img_wh=WH, n_instances=1, degrees=(0,), n_images=1)
    assert not sm.SapienMultiDataset.has_val_split(root)
    ds = sm.SapienMultiDataset(root, split="val", img_wh=WH)
    assert not ds.uses_val_split and ds.n_articulations(0) == 1  # falls back to the train dirs
    os.makedirs(tmp_path / "10001" / "val")  # an instance with an empty val/
    assert not sm.SapienMultiDataset.has_val_split(str(tmp_path)) and sm.SapienMultiDataset.has_val_split(scene)


def jax_batch_draws(sample_key, n_i, n_d, n_v, hw, batch_size):
    """The ids and pixels JAX's sample_multi_batch draws from ``sample_key``."""
    k_i, k_d, k_v, k_pix = jax.random.split(sample_key, 4)
    return [np.array(jax.random.randint(k, (), 0, n)) for k, n in ((k_i, n_i), (k_d, n_d), (k_v, n_v))] + [
        np.array(jax.random.randint(k_pix, (batch_size,), 0, hw))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_multi_batch_matches_jax(scene, seed):
    bufs = sm.SapienMultiDataset(scene, split="train", img_wh=WH).device_buffers()
    key = jax.random.PRNGKey(seed)
    want = jstep.sample_multi_batch({k: jnp.asarray(v) for k, v in bufs.items()}, key, 32)
    draws = QueueDraws(jax_batch_draws(key, 2, 3, 2, WH[0] * WH[1], 32))
    got = tstep.sample_multi_batch({k: torch.from_numpy(v) for k, v in bufs.items()}, draws, 32)
    assert not draws.arrays and set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("rays_o", "rays_d", "viewdirs"):  # a 3x3 product and a norm in fp32
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["rays_d"] is got["viewdirs"]
    np.testing.assert_allclose(torch.linalg.norm(got["rays_d"], dim=-1).numpy(), 1.0, atol=1e-6)
