"""Geometry export of the port on the CPU against ``aonerf``: density grids
of the vanilla, auto-decoder and auto-encoder fields on bridged parameters
in fp32 and bf16, occupied points, marching tetrahedra, the PLY writers,
depth back-projection and the rotation helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf.models import NeRF as JaxNeRF
from aonerf.models.ae import AutoEncoderArticulatedNeRF as JaxAE
from aonerf.utils import transforms as jtf
from aonerf.viz import mesh as jmesh
from aonerf.viz import pointcloud as jpc
from aonerf.viz import voxelgrid as jvg
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.utils import transforms as tf
from aonerf_torch.utils.bridge import module_state_dict_from_flax
from aonerf_torch.viz import mesh, pointcloud
from aonerf_torch.viz import voxelgrid as vg
from tests.torch_release import release_after_module  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

RES = 12  # grid resolution of the model tests: 1728 points
BBOX = ((-1.2, -1.1, -1.0), (1.0, 1.3, 1.2))  # not a cube: pins the per-axis centres
# fp32: the port's grid against JAX's, relative to the grid's largest value.
# Both evaluate the same fp32 products in other summation orders; the
# articulated fields pass the warped points through sin(2^9 x), which
# magnifies that to ~5e-5 of the largest entry (tests/test_torch_autodecoder_step.py).
TOL_F32 = 2e-4
# bf16: every layer rounds its output to bf16 (8 bits), and the two sides'
# products round from other fp32 sums, so a rounding may flip by one bf16 ulp
# (2^-8 relative) at any layer; the articulated bf16 rule
# (tests/test_torch_bf16_articulated_rule.py) allows
# rows off flax beyond 3e-3. Held: within 2^-4 of the grid's largest value
# and, on 95% of the voxels, within 2^-7 relative of JAX's value (measured:
# at most 2.3e-2 of the largest value, 99.9% of the voxels). The same
# weights evaluated in fp32 miss it (86% of the vanilla voxels, 15% of the
# articulated ones).
TOL_BF16_MAX, TOL_BF16_REL, BF16_SHARE = 2.0**-4, 2.0**-7, 0.95
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rays(n=4, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": jnp.asarray(-4.0 * d), "rays_d": jnp.asarray(d), "viewdirs": jnp.asarray(d)}


def _latents(seed, embed_deg=False):
    rng = np.random.default_rng(seed)
    lat = {"density": rng.standard_normal((1, 128)), "color": rng.standard_normal((1, 128)),
           "articulation_deg" if embed_deg else "articulation": rng.standard_normal((1, 32))}
    return {k: v.astype(np.float32) for k, v in lat.items()}


def _jax_grid(fn):
    return np.asarray(jvg.density_grid(fn, *BBOX, resolution=RES), np.float32)


def _port_grid(fn):
    return vg.density_grid(fn, *BBOX, resolution=RES, device="cpu")


def _vanilla(dtype):
    jdt, tdt = DTYPES[dtype]
    jmodel = JaxNeRF(num_coarse_samples=4, num_fine_samples=4, compute_dtype=jdt)
    variables = jmodel.init(jax.random.PRNGKey(3), _rays(), False, True, 2.0, 6.0)
    model = NeRF(num_coarse_samples=4, num_fine_samples=4, compute_dtype=tdt, device="cpu")
    model.load_state_dict(module_state_dict_from_flax(jax.device_get(variables)))
    return jvg.nerf_density_fn(jmodel, variables), vg.nerf_density_fn(model)


def _autodecoder(dtype):
    jdt, tdt = DTYPES[dtype]
    lat = _latents(5)
    jmodel = JaxArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True, compute_dtype=jdt)
    variables = jmodel.init(jax.random.PRNGKey(4), _rays(), False, True, 2.0, 6.0,
                            {k: jnp.asarray(v) for k, v in lat.items()})
    model = ArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True, compute_dtype=tdt,
                            device="cpu")
    model.load_state_dict(module_state_dict_from_flax(jax.device_get(variables)))
    return (jvg.articulated_density_fn(jmodel, variables, {k: jnp.asarray(v) for k, v in lat.items()}),
            vg.articulated_density_fn(model, {k: torch.from_numpy(v) for k, v in lat.items()}))


def _autoencoder(dtype):
    # the AE's field (softplus, density cap 500, degree-embedded articulation
    # code) at given codes; the encoder's codes reach it only as latents
    jdt, tdt = DTYPES[dtype]
    lat = _latents(6, embed_deg=True)
    jfield = JaxArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, sigma_cap=500.0, tail_to_background=True,
                                rgb_padding=0.0, embed_deg=True, compute_dtype=jdt)
    field = jfield.init(jax.random.PRNGKey(5), _rays(), False, True, 2.0, 6.0,
                        {k: jnp.asarray(v) for k, v in lat.items()})
    jmodel = JaxAE(num_coarse_samples=4, num_fine_samples=4, compute_dtype=jdt)
    variables = {"params": {"field": jax.device_get(field)["params"]}}
    model = AutoEncoderArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, compute_dtype=tdt, device="cpu")
    model.field.load_state_dict(module_state_dict_from_flax(variables["params"]["field"]))
    return (jvg.ae_density_fn(jmodel, variables, {k: jnp.asarray(v) for k, v in lat.items()}),
            vg.ae_density_fn(model, {k: torch.from_numpy(v) for k, v in lat.items()}))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("make", [_vanilla, _autodecoder, _autoencoder], ids=["vanilla", "autodecoder", "ae"])
def test_density_grid_matches_jax(make, dtype):
    jfn, fn = make(dtype)
    want, got = _jax_grid(jfn), _port_grid(fn)
    assert got.shape == want.shape == (RES,) * 3 and got.dtype == np.float32
    assert np.isfinite(got).all() and (got >= 0).all()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.ptp(want) > 0.01 * scale  # a field, not a constant
    err = np.abs(got - want)
    if dtype == "f32":
        assert err.max() <= TOL_F32 * scale, (err.max(), scale)
    else:
        assert _bf16_rule(got, want), (err.max() / scale, _share(got, want))
        assert not _bf16_rule(_port_grid(make("f32")[1]), want)  # the fp32 evaluation misses it


def _share(got, want):
    return (np.abs(got - want) <= TOL_BF16_REL * np.abs(want) + 1e-6 * np.abs(want).max()).mean()


def _bf16_rule(got, want):
    return np.abs(got - want).max() <= TOL_BF16_MAX * np.abs(want).max() and _share(got, want) >= BF16_SHARE


def test_vanilla_bf16_grid_is_computed_in_bf16():
    # the vanilla bf16 grid holds bf16 values, as flax's bf16 NeRFMLP gives
    # them, and differs from the same weights evaluated in fp32
    _, fn = _vanilla("bf16")
    got = _port_grid(fn)
    assert np.array_equal(torch.from_numpy(got).bfloat16().float().numpy(), got)
    _, fn32 = _vanilla("f32")
    assert not np.array_equal(_port_grid(fn32), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vanilla_density_is_the_relu_of_the_raw_density(dtype):
    # the raw density (which chip_smoke.py meshes where a field's density is
    # 0 everywhere) through ReLU is the density, bit for bit
    model = NeRF(num_coarse_samples=4, num_fine_samples=4, compute_dtype=DTYPES[dtype][1],
                 generator=torch.Generator().manual_seed(7), device="cpu")
    mlp = model.fine_mlp

    def raw_fn(p):
        return mlp(pos_enc(p, 0, 10), vg._fixed_view_cond(p, 4))[1][..., 0]

    raw = _port_grid(raw_fn)
    assert np.array_equal(np.maximum(raw, 0.0), _port_grid(vg.nerf_density_fn(model)))
    assert (raw < 0).any() and (raw > 0).any()


def _coords_fn_jax(p):
    return p[..., 0] + 2.0 * p[..., 1] + 4.0 * p[..., 2] * p[..., 2]


def test_density_grid_centres_and_indexing_match_jax():
    # a function of the coordinates alone: the same float32 centres and
    # [ix, iy, iz] layout, bit for bit
    want = np.asarray(jvg.density_grid(_coords_fn_jax, *BBOX, resolution=9))
    got = vg.density_grid(_coords_fn_jax, *BBOX, resolution=9, device="cpu")
    assert got.shape == (9, 9, 9) and np.array_equal(got, want)
    for a, (c, jc) in enumerate(zip(vg.voxel_centers(*BBOX, 9), [
            jnp.asarray(BBOX[0][a], jnp.float32) + (jnp.asarray(BBOX[1][a], jnp.float32)
                                                    - jnp.asarray(BBOX[0][a], jnp.float32))
            * (jnp.arange(9) + 0.5) / 9 for a in range(3)])):
        assert np.array_equal(c.numpy(), np.asarray(jc)), a


def _sphere_grid(R=20, r0=0.8):
    c = -1.5 + 3.0 * (np.arange(R) + 0.5) / R
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (20.0 * (r0 - np.sqrt(x * x + y * y + z * z))).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 5.0, 10.0])
def test_occupied_points_match_jax(threshold):
    grid = _sphere_grid()
    got = vg.occupied_points(grid, threshold=threshold)
    want = jvg.occupied_points(grid, threshold=threshold)
    assert got.dtype == want.dtype == np.float64 and len(got) > 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level", [0.0, 3.3])
def test_marching_tetrahedra_matches_jax(level):
    grid = _sphere_grid()
    verts, faces = mesh.marching_tetrahedra(grid, level, *BBOX)
    jverts, jfaces = jmesh.marching_tetrahedra(grid, level, *BBOX)
    assert len(faces) > 100 and np.array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-9)
    empty = mesh.marching_tetrahedra(grid, 1e9)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_extract_mesh_matches_jax():
    # an analytic sphere density through the grid and the mesh on both sides
    verts, faces = mesh.extract_mesh(lambda p: 20.0 * (0.7 - torch.linalg.norm(p, dim=-1)), 2.0, resolution=16,
                                     device="cpu")
    jverts, jfaces = jmesh.extract_mesh(lambda p: 20.0 * (0.7 - jnp.linalg.norm(p, axis=-1)), 2.0, resolution=16)
    assert len(faces) > 0 and np.array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-6)


def test_ply_writers_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (20, 6)).astype(np.float32)
    edges = rng.integers(0, 20, (7, 2))
    for name, args in (("xyz", (pts[:, :3],)), ("rgb", (pts,)), ("edges", (pts[:, :3], edges))):
        a, b = str(tmp_path / f"port_{name}.ply"), str(tmp_path / f"jax_{name}.ply")
        assert pointcloud.write_ply(a, *args) == a and jpc.write_ply(b, *args) == b
        assert open(a, "rb").read() == open(b, "rb").read(), name
    verts, faces = mesh.marching_tetrahedra(_sphere_grid(12), 0.0)
    a, b = str(tmp_path / "port_mesh.ply"), str(tmp_path / "jax_mesh.ply")
    mesh.write_mesh_ply(a, verts, faces)
    jmesh.write_mesh_ply(b, verts, faces)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_export_occupancy_ply_matches_jax(tmp_path):
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    got = vg.export_occupancy_ply(a, lambda p: 30.0 * (p[..., 0] > 0.2), resolution=10, device="cpu")
    want = jvg.export_occupancy_ply(b, lambda p: 30.0 * (p[..., 0] > 0.2), resolution=10)
    assert got[1] == want[1] > 0 and open(a, "rb").read() == open(b, "rb").read()


def test_depth_to_points_matches_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(2, 6, (6, 8)).astype(np.float32)
    depth[0, 0] = np.inf
    rgb, mask = rng.uniform(0, 1, (6, 8, 3)), rng.uniform(size=(6, 8)) > 0.3
    c2w = np.eye(4)
    c2w[:3, :3] = tf.euler_xyz_to_matrix(0.3, -0.2, 0.5)
    c2w[:3, 3] = [0.5, -1.0, 4.0]
    for kwargs in ({}, {"rgb": rgb, "mask": mask}, {"stride": 2}):
        got = pointcloud.depth_to_points(depth, c2w, 7.5, **kwargs)
        want = jpc.depth_to_points(depth, c2w, 7.5, **kwargs)
        assert got.shape == want.shape and np.array_equal(got, want), kwargs


def test_transforms_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 4))
    pairs = [(tf.quat_to_matrix(q), jtf.quat_to_matrix(q))]
    m = jtf.quat_to_matrix(q)
    pairs.append((tf.matrix_to_quat(m), jtf.matrix_to_quat(m)))
    for axis, angle in ((rng.standard_normal(3), 0.7), (np.array([0.0, 0.0, 1.0]), np.pi), ([1, 2, 3], 1e-9)):
        r = jtf.axis_angle_to_matrix(axis, angle)
        pairs.append((tf.axis_angle_to_matrix(axis, angle), r))
        (ax, an), (jax_ax, jax_an) = tf.matrix_to_axis_angle(r), jtf.matrix_to_axis_angle(r)
        pairs += [(ax, jax_ax), (np.float64(an), np.float64(jax_an))]
    pairs.append((tf.euler_xyz_to_matrix(0.1, -0.4, 2.0), jtf.euler_xyz_to_matrix(0.1, -0.4, 2.0)))
    c2w = jtf.compose_c2w(m[0], [1.0, 2.0, 3.0])
    pairs += [(tf.compose_c2w(m[0], [1.0, 2.0, 3.0]), c2w), (tf.invert_se3(c2w), jtf.invert_se3(c2w))]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=str(i))
