"""Port parity: ray generation (ops/rays.py), the ray-box slab test
(ops/raybox.py) and the cumprod volume integrator (ops/render.py) of
aonerf_torch against aonerf on the CPU, fp32, inputs from numpy seeds.

Tolerance: 1e-6 absolute wherever the two sides can round differently
(matmuls, norms, the cumprod's order; measured at most 2.4e-7 here), exact
where both do the same elementwise fp32 operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops import raybox as jraybox
from aonerf.ops import rays as jrays
from aonerf.ops import render as jrender
from aonerf_torch.ops import raybox, rays, render

TOL = 1e-6


def _close(got, want, atol=TOL):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _pose(i=2, n=5):
    return rays.create_spheric_poses(4.0, n)[i]


def test_spheric_poses_match_jax():
    for args in ((), (3.0, 7, -45.0)):
        got, want = rays.create_spheric_poses(*args), jrays.create_spheric_poses(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,focal", [(6, 8, 7.5), (5, 9, 3.0)])
def test_directions_and_rays_match_jax(h, w, focal):
    dirs = rays.get_ray_directions(h, w, focal, "cpu")
    jdirs = jrays.get_ray_directions(h, w, focal)
    _close(dirs, jdirs, atol=0)
    c2w = _pose()[:3, :4]
    _close(rays.get_rays(dirs, *_t(c2w)), jrays.get_rays(jdirs, *_j(c2w)))
    coords = np.stack([np.random.default_rng(h).integers(0, h, 10), np.random.default_rng(w).integers(0, w, 10)], -1)
    _close(rays.get_rays_background(dirs, *_t(c2w, coords)), jrays.get_rays_background(jdirs, *_j(c2w, coords)))
    _close(rays.get_rays_mvs(h, w, focal, *_t(_pose(1))), jrays.get_rays_mvs(h, w, focal, *_j(_pose(1))))


def test_directions_are_built_on_the_given_device():
    with pytest.raises(TypeError):
        rays.get_ray_directions(4, 4, 2.0)  # no default device
    assert rays.get_ray_directions(4, 4, 2.0, torch.device("cpu")).device.type == "cpu"


def test_ndc_and_camera_transforms_match_jax():
    rng = np.random.default_rng(0)
    o = rng.standard_normal((50, 3)).astype(np.float32)
    o[:, 2] -= 3.0
    d = rng.standard_normal((50, 3)).astype(np.float32)
    _close(rays.get_ndc_rays(6, 8, 7.5, 1.0, *_t(o, d)), jrays.get_ndc_rays(6, 8, 7.5, 1.0, *_j(o, d)))
    _close(rays.world_to_ndc(*_t(o), 8, 6, 7.5, 1.0), jrays.world_to_ndc(*_j(o), 8, 6, 7.5, 1.0))
    c2w = _pose(3)[:3, :4]
    _close(rays.transform_rays_camera(*_t(o, d, c2w)), jrays.transform_rays_camera(*_j(o, d, c2w)))


def _box_rays(seed, n=64):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0], d[0] = (5.0, 5.0, -5.0), (0.0, 0.0, 1.0)  # misses the box, with zero components
    o[1], d[1] = (0.1, -0.2, 0.3), (0.0, 1.0, 0.0)  # starts inside it
    o[2], d[2] = (-4.0, 0.05, 0.1), (1.0, 0.0, 0.0)  # crosses it along x
    return o, d


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_box_matches_jax(seed):
    o, d = _box_rays(seed)
    for side in (2.0, 3.0):
        got = raybox.ray_box_intersection(*_t(o, d), side)
        _close(got, jraybox.ray_box_intersection(*_j(o, d), side), atol=0)
        assert got[0][0].item() == -1.0 and got[1][0].item() == -2.0  # the miss is marked
        _close(raybox.get_ray_limits(*_t(o, d), side), jraybox.get_ray_limits(*_j(o, d), side), atol=0)
    bounds = np.array([[-1.0, -0.5, -0.7], [0.8, 1.0, 0.6]], np.float32)
    hit, tmin, tmax = raybox.bbox_intersection_batch(*_t(bounds, o, d))
    jhit, jtmin, jtmax = jraybox.bbox_intersection_batch(*_j(bounds, o, d))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    _close([tmin, tmax], [jtmin, jtmax], atol=0)
    assert not hit[0] and not hit[1] and hit[2]  # miss, inside (a miss), through


def test_ray_limits_when_every_ray_misses():
    o = np.tile(np.float32([[5.0, 5.0, -5.0]]), (4, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    _close(raybox.get_ray_limits(*_t(o, d)), jraybox.get_ray_limits(*_j(o, d)), atol=0)


def _samples(seed, R=20, S=9):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    density = rng.uniform(0, 5, (R, S, 1)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (R, S)), -1).astype(np.float32)
    dirs = rng.standard_normal((R, 3)).astype(np.float32)  # not unit: ||dirs|| scales the distances
    nocs = rng.uniform(size=(R, S, 3)).astype(np.float32)
    return rgb, density, t, dirs, nocs


@pytest.mark.parametrize("white_bkgd", [True, False])
@pytest.mark.parametrize("with_nocs", [False, True])
def test_volumetric_rendering_matches_jax(white_bkgd, with_nocs):
    rgb, density, t, dirs, nocs = _samples(int(white_bkgd) + 2 * int(with_nocs))
    extra = (nocs,) if with_nocs else ()
    got = render.volumetric_rendering(*_t(rgb, density, t, dirs), white_bkgd, *_t(*extra))
    want = jrender.volumetric_rendering(*_j(rgb, density, t, dirs), white_bkgd, *_j(*extra))
    _close(got, want)


def test_volumetric_rendering_nan_depth_matches_jax():
    rgb, density, t, dirs, _ = _samples(5)
    density[3, 2, 0] = np.nan
    got = render.volumetric_rendering(*_t(rgb, density, t, dirs), True)
    want = jrender.volumetric_rendering(*_j(rgb, density, t, dirs), True)
    _close(got, want)  # NaNs in the same places (rgb, acc, weights)
    depth = got[3].numpy()
    assert np.isnan(np.asarray(want[3])).sum() == 0 and depth[3] == np.finfo(np.float32).max
