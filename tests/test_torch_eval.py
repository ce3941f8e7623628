"""Port parity: image renderer, metrics, camera, analytic scene and the eval
loader of aonerf_torch against aonerf (CPU, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.data import camera as jcam
from aonerf.data import sapien as jsapien
from aonerf.data import synthetic as jsyn
from aonerf.eval import metrics as jmetrics
from aonerf.eval.render import make_image_renderer as jax_make_image_renderer
from aonerf.models import NeRF as JaxNeRF
from aonerf_torch.data import camera, sapien, synthetic
from aonerf_torch.eval import metrics
from aonerf_torch.eval.render import make_image_renderer
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.utils.bridge import nerf_state_dict_from_flax

torch.set_num_threads(1)


def test_image_renderer_ragged_tail_matches_jax():
    h, w, focal = 5, 7, 6.0
    c2w = jcam.look_at_c2w(np.array([3.0, -2.0, 2.0]), np.zeros(3), np.array([0.0, 0.0, 1.0]))
    rays_o, viewdirs, rays_d, _ = jcam.get_rays_np(jcam.get_ray_directions_np(h, w, focal), c2w[:3, :4])
    rays = {"rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs}  # 35 rays, chunk 16

    jnerf = JaxNeRF(num_coarse_samples=4, num_fine_samples=8)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    params = jnerf.init(jax.random.PRNGKey(3), {k: v[:16] for k, v in jrays.items()}, False, True, 2.0, 6.0)
    want = jax_make_image_renderer(jnerf, True, 2.0, 6.0, chunk=16)(params, jrays)

    nerf = NeRF(num_coarse_samples=4, num_fine_samples=8, device="cpu")
    nerf.load_state_dict(nerf_state_dict_from_flax(jax.device_get(params)))
    got = make_image_renderer(nerf, True, 2.0, 6.0, chunk=16)({k: torch.from_numpy(v) for k, v in rays.items()})

    assert [tuple(g.shape) for g in got] == [(35, 3), (35,), (35,)]
    # The JAX renderer runs NeRF.apply under jit, and XLA's fused CPU program
    # differs from the eager reference the port's NeRF is held to at 2e-6
    # (test_torch_models.py): on 16 of these rays jit vs eager JAX alone
    # differs by 3.3e-6 on rgb and 1.4e-4 on depth at the fine level, and the
    # port vs the jitted renderer by 1.5e-5 on rgb. Tolerances leave ~3x that.
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=5e-4, rtol=0)
    # Padding and cropping are exact: against the eager reference on the 35
    # unpadded rays, the NeRF's own tolerances hold.
    eager = jnerf.apply(params, jrays, False, True, 2.0, 6.0)[-1]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(eager[0]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(eager[1]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(eager[2]), atol=5e-5, rtol=0)


def _images(seed, shape=(20, 24, 3)):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(target + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=shape[:2]) > 0.5
    return pred, target, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    pred, target, mask = _images(seed)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    np.testing.assert_allclose(
        float(metrics.psnr_image(tp, tt)), float(jmetrics.psnr_image(jp, jt)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(metrics.masked_psnr(tp, tt, torch.from_numpy(mask))),
        float(jmetrics.masked_psnr(jp, jt, jnp.asarray(mask))),
        rtol=1e-6,
    )
    # fp32 filters in another summation order
    np.testing.assert_allclose(
        float(metrics.ssim_image(tp, tt)), float(jmetrics.ssim_image(jp, jt)), atol=1e-6
    )
    np.testing.assert_allclose(float(metrics.ssim_image(tt, tt)), 1.0, atol=1e-6)


def test_summarize_metric_matches_jax():
    vals = [20.0, 22.5, 19.0, 30.0]
    assert metrics.summarize_metric(vals) == jmetrics.summarize_metric(vals)
    kw = dict(i_train=[0], i_val=[1, 2], i_test=[3])
    assert metrics.summarize_metric(vals, **kw) == jmetrics.summarize_metric(vals, **kw)


def test_camera_matches_jax_numpy():
    dirs = camera.get_ray_directions_np(6, 8, 7.5)
    np.testing.assert_array_equal(dirs, jcam.get_ray_directions_np(6, 8, 7.5))
    c2w = camera.look_at_c2w(np.array([1.0, 2.0, 3.0]), np.zeros(3), np.array([0.0, 0.0, 1.0]))
    np.testing.assert_array_equal(
        c2w, jcam.look_at_c2w(np.array([1.0, 2.0, 3.0]), np.zeros(3), np.array([0.0, 0.0, 1.0]))
    )
    for a, b in zip(camera.get_rays_np(dirs, c2w[:3, :4]), jcam.get_rays_np(dirs, c2w[:3, :4])):
        np.testing.assert_array_equal(a, b)
    for meta in ({"camera_angle_x": 0.69}, {"focal": 290.0}):
        assert camera.focal_from_meta(meta, (160, 120)) == jcam.focal_from_meta(meta, (160, 120))


def test_render_scene_matches_jax_numpy():
    for deg, inst in ((80.0, 0), (30.0, 2)):
        boxes, jboxes = synthetic.laptop_scene(deg, inst), jsyn.laptop_scene(deg, inst)
        c2w = synthetic.random_pose_on_sphere(np.random.default_rng(inst))
        np.testing.assert_array_equal(c2w, jsyn.random_pose_on_sphere(np.random.default_rng(inst)))
        focal = 0.5 * 24 / np.tan(0.5 * np.deg2rad(synthetic.FOVY_DEG))
        for a, b in zip(synthetic.render_scene(boxes, c2w, 24, 32, focal),
                        jsyn.render_scene(jboxes, c2w, 24, 32, focal)):
            np.testing.assert_array_equal(a, b)
    assert synthetic.FOVY_DEG == jsyn.FOVY_DEG


def test_sapien_get_image_matches_jax(tmp_path):
    root = jsyn.generate_single_scene(str(tmp_path), img_wh=(16, 12), n_train=1, n_val=1, n_test=3)
    for split in ("test", "val"):
        ds = sapien.SapienDataset(root, split=split, img_wh=(16, 12))
        jds = jsapien.SapienDataset(root, split=split, img_wh=(16, 12))
        assert ds.img_files == jds.img_files
        assert ds.focal == jds.focal
        assert (ds.near, ds.far) == (jds.near, jds.far)
        for i in range(ds.num_images):
            a, b = ds.get_image(i), jds.get_image(i)
            for field in ("rays_o", "rays_d", "viewdirs", "radii", "target", "instance_mask"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    with pytest.raises(ValueError, match="split"):
        sapien.SapienDataset(root, split="holdout", img_wh=(16, 12))
