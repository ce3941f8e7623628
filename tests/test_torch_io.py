"""Port parity on the CPU: the test render's output writers (eval/io.py),
the legacy metrics (eval/metrics.py) and the chunk renderer
(eval/render.py) of aonerf_torch against aonerf, inputs from numpy seeds."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.eval import io as jio
from aonerf.eval import metrics as jmetrics
from aonerf.eval.render import make_chunk_renderer as jax_make_chunk_renderer
from aonerf.eval.render import render_rays_chunked as jax_render_rays_chunked
from aonerf.models import NeRF as JaxNeRF
from aonerf_torch.eval import io, metrics
from aonerf_torch.eval.render import make_chunk_renderer, make_image_renderer, render_rays_chunked
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.utils.bridge import nerf_state_dict_from_flax

torch.set_num_threads(1)


def _views(seed, n=3, h=12, w=16):
    """Rendered-looking views: rgb a little outside [0, 1], depth with a NaN
    and an inf, opacity with a NaN."""
    rng = np.random.default_rng(seed)
    rgbs = [rng.uniform(-0.05, 1.05, (h, w, 3)).astype(np.float32) for _ in range(n)]
    depths = [rng.uniform(2, 6, (h, w)).astype(np.float32) for _ in range(n)]
    accs = [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(n)]
    depths[0][0, 0], depths[0][1, 3], accs[1][2, 2] = np.nan, np.inf, np.nan
    depths[2][:] = 4.0  # a flat map: the normalization's hi == lo branch
    return rgbs, depths, accs


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("writer", ["store_image", "store_depth_img", "store_depth_color", "store_opacity", "store_gif"])
def test_writers_write_jax_bytes(tmp_path, writer):
    rgbs, depths, accs = _views(0)
    arrays = {"store_image": rgbs, "store_gif": rgbs, "store_opacity": accs}.get(writer, depths)
    getattr(io, writer)(str(tmp_path / "port"), arrays)
    getattr(jio, writer)(str(tmp_path / "jax"), arrays)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(got) == list(want) and got
    for name in want:  # jpg, png, gif and npy byte for byte
        assert got[name] == want[name], name


def test_depth_raw_matches_jax(tmp_path):
    _, depths, _ = _views(1)
    io.store_depth_raw(str(tmp_path / "port"), depths)
    jio.store_depth_raw(str(tmp_path / "jax"), depths)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(got) == list(want) == ["depth_raw.npz", "depth_raw000.png", "depth_raw001.png", "depth_raw002.png"]
    for name in want:
        if name.endswith(".png"):
            assert got[name] == want[name], name
    a, b = np.load(tmp_path / "port" / "depth_raw.npz"), np.load(tmp_path / "jax" / "depth_raw.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:  # the zip's timestamps may differ; the arrays may not
        np.testing.assert_array_equal(a[k], b[k])


def test_store_video_refuses_without_an_mp4_backend_as_jax_does(tmp_path):
    rgbs, _, _ = _views(2)
    try:
        jax_path = jio.store_video(str(tmp_path / "jax"), rgbs)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="mp4 backend"):
            io.store_video(str(tmp_path / "port"), rgbs)
    else:  # a machine with an mp4 backend writes the same file name
        assert os.path.basename(io.store_video(str(tmp_path / "port"), rgbs)) == os.path.basename(jax_path)


def test_write_stats_matches_jax(tmp_path):
    stats = {"psnr": {"test": np.float32(21.5)}, "ssim": {"test": 0.75, "all": 0.5},
             "lpips": {"test": float("nan")}, "psnr_obj": {"test": 18.25}}
    io.write_stats(str(tmp_path / "a" / "results.json"), **stats)
    jio.write_stats(str(tmp_path / "b" / "results.json"), **stats)
    got, want = (tmp_path / "a" / "results.json").read_bytes(), (tmp_path / "b" / "results.json").read_bytes()
    assert got == want
    assert json.loads(got)["ssim"] == {"test": 0.75, "all": 0.5}


def _pairs(seed, n=3, shape=(14, 18, 3)):
    rng = np.random.default_rng(seed)
    preds = [rng.uniform(-0.1, 1.1, shape).astype(np.float32) for _ in range(n)]
    gts = [np.clip(p + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32) for p in preds]
    return preds, gts, rng.uniform(size=shape) > 0.4


@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_metrics_match_jax(seed):
    preds, gts, mask = _pairs(seed)
    tp, tg, tm = torch.from_numpy(preds[0]), torch.from_numpy(gts[0]), torch.from_numpy(mask)
    jp, jg, jm = jnp.asarray(preds[0]), jnp.asarray(gts[0]), jnp.asarray(mask)
    # elementwise fp32 in the same order; the means and the SSIM filters may
    # sum in another order: 1e-6 relative (PSNR) and 1e-6 absolute (SSIM)
    for kw in ({}, {"valid_mask": (tm, jm)}):
        t_kw = {k: v[0] for k, v in kw.items()}
        j_kw = {k: v[1] for k, v in kw.items()}
        np.testing.assert_allclose(float(metrics.mse_legacy(tp, tg, **t_kw)),
                                   float(jmetrics.mse_legacy(jp, jg, **j_kw)), rtol=1e-6)
        np.testing.assert_allclose(float(metrics.psnr_legacy(tp, tg, **t_kw)),
                                   float(jmetrics.psnr_legacy(jp, jg, **j_kw)), rtol=1e-6)
        np.testing.assert_array_equal(metrics.mse_legacy(tp, tg, reduction="none", **t_kw).numpy(),
                                      np.asarray(jmetrics.mse_legacy(jp, jg, reduction="none", **j_kw)))
    np.testing.assert_allclose(metrics.psnr_legacy(tp, tg, reduction="none").numpy(),
                               np.asarray(jmetrics.psnr_legacy(jp, jg, reduction="none")), rtol=1e-6)
    tps, tgs = [torch.from_numpy(p) for p in preds], [torch.from_numpy(g) for g in gts]
    jps, jgs = [jnp.asarray(p) for p in preds], [jnp.asarray(g) for g in gts]
    np.testing.assert_allclose(metrics.psnr_each(tps, tgs).numpy(), np.asarray(jmetrics.psnr_each(jps, jgs)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics.ssim_legacy(tp, tg)), float(jmetrics.ssim_legacy(jp, jg)), atol=1e-6)
    np.testing.assert_allclose(metrics.ssim_each(tps, tgs).numpy(), np.asarray(jmetrics.ssim_each(jps, jgs)), atol=1e-6)
    depth, depth_gt = preds[1][..., 0] * 4 + 2, gts[1][..., 0] * 4 + 2
    got = metrics.depth_mae_rmse(torch.from_numpy(depth), torch.from_numpy(depth_gt))
    want = jmetrics.depth_mae_rmse(jnp.asarray(depth), jnp.asarray(depth_gt))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)


def test_chunk_renderer_ragged_count_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((37, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"rays_o": (-4.0 * d + 0.1 * rng.standard_normal((37, 3))).astype(np.float32), "rays_d": d, "viewdirs": d}
    jnerf = JaxNeRF(num_coarse_samples=4, num_fine_samples=8)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    params = jnerf.init(jax.random.PRNGKey(5), {k: v[:16] for k, v in jrays.items()}, False, True, 2.0, 6.0)
    want = jax_render_rays_chunked(jax_make_chunk_renderer(jnerf, True, 2.0, 6.0), params, jrays, chunk=16)

    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(jax.device_get(params)))
    trays = {k: torch.from_numpy(v) for k, v in rays.items()}
    got = render_rays_chunked(make_chunk_renderer(nerf, True, 2.0, 6.0), trays, chunk=16)

    assert all(isinstance(g, np.ndarray) for g in got)
    assert [g.shape for g in got] == [(37, 3), (37,), (37,)]
    # the JAX chunk renderer is jitted: tolerances of tests/test_torch_eval.py
    # against the jitted image renderer
    np.testing.assert_allclose(got[0], want[0], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=5e-4, rtol=0)
    # the image renderer tiles the same way, on the device
    for g, w in zip(got, make_image_renderer(nerf, True, 2.0, 6.0, chunk=16)(trays)):
        np.testing.assert_array_equal(g, w.numpy())
