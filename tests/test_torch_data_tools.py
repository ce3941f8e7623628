"""The port's camera and pose tools and segmented ray selection on the CPU
against ``aonerf``'s: ``data.segmented``, every ``viz.conventions`` loader on
fixtures written in each dataset's on-disk format (cameras at known
positions looking at the origin), the frustum and box helpers, the
``check_poses`` report and CLI, and ``plot_cameras``."""

import json
import os

import numpy as np
import pytest

from aonerf.data import segmented as jseg
from aonerf.viz import check_poses as jcheck
from aonerf.viz import conventions as jcv
from aonerf_torch.data import segmented as seg
from aonerf_torch.data.camera import look_at_c2w
from aonerf_torch.data.synthetic import generate_single_scene
from aonerf_torch.utils.transforms import matrix_to_quat
from aonerf_torch.viz import cameras
from aonerf_torch.viz import check_poses as check
from aonerf_torch.viz import conventions as cv

EYES = np.array([[3.0, 0.5, 1.0], [-2.0, 2.0, 1.5], [0.5, -3.0, 2.0]])
UP = np.array([0.0, 0.0, 1.0])


def _look_at_cv_w2c(eye, center=(0.0, 0.0, 0.0)):
    """OpenCV-convention w2c (R, t) for a camera at ``eye`` looking at
    ``center``: +z forward toward the target, +y down."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, fwd)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows: camera axes in world
    t = -R @ eye
    return R, t


def _write_sapien(root):
    os.makedirs(os.path.join(root, "train"))
    frames = {f"r_{i}": look_at_c2w(e, np.zeros(3), UP).tolist() for i, e in enumerate(EYES)}
    with open(os.path.join(root, "train", "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def _write_blender(root):
    frames = [{"transform_matrix": look_at_c2w(e, np.zeros(3), UP).tolist()} for e in EYES]
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)


def _write_srn(root):
    os.makedirs(os.path.join(root, "pose"))
    for i, eye in enumerate(EYES):
        # SRN poses are c2w in OpenCV camera axes: columns of R are the camera axes in world
        R, _ = _look_at_cv_w2c(eye)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = eye
        np.savetxt(os.path.join(root, "pose", f"{i:06d}.txt"), c2w.reshape(1, 16))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write("131.25 64.0 64.0\n0. 0. 0.\n1.\n128 128\n")


def _write_dtu(root, name="cameras.npz", with_scale=False):
    K = np.array([[400.0, 0.0, 200.0], [0.0, 400.0, 150.0], [0.0, 0.0, 1.0]])
    arrays = {}
    for i, eye in enumerate(EYES):
        R, t = _look_at_cv_w2c(eye)
        arrays[f"world_mat_{i}"] = K @ np.concatenate([R, t[:, None]], axis=1)
        if with_scale:
            s = np.eye(4)
            s[:3, :3] *= 2.0
            s[:3, 3] = [0.1, 0.2, 0.3]
            arrays[f"scale_mat_{i}"] = s
    np.savez(os.path.join(root, name), **arrays)


def _write_replica(root):
    data = []
    for eye in EYES:
        c2w = look_at_c2w(eye, np.zeros(3), UP)
        c2w4 = np.eye(4)
        c2w4[:3, :4] = c2w[:3, :4]
        data.append({"Rt": np.linalg.inv(c2w4).tolist(), "K": np.eye(3).tolist()})
    path = os.path.join(root, "cameras.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def _write_colmap(root, with_points=True):
    model = os.path.join(root, "sparse", "0")
    os.makedirs(model)
    with open(os.path.join(model, "cameras.txt"), "w") as f:
        f.write("# cameras\n1 SIMPLE_PINHOLE 640 480 500.0 320 240\n")
    with open(os.path.join(model, "images.txt"), "w") as f:
        f.write("# images\n")
        for i, eye in enumerate(EYES):
            R, t = _look_at_cv_w2c(eye)
            vals = " ".join(f"{v:.12f}" for v in list(matrix_to_quat(R)) + list(t))
            f.write(f"{i + 1} {vals} 1 im{i}.png\n")
            # the POINTS2D line, empty for one image
            f.write("1.0 2.0 -1\n" if i != 1 else "\n")
    if with_points:
        with open(os.path.join(model, "points3D.txt"), "w") as f:
            f.write("# points\n7 0.5 0.25 -0.125 200 10 10 0.4 1 2\n")


CO3D_FRAMES = [
    {"viewpoint": {"R": np.eye(3).tolist(), "T": [0.0, 0.0, 2.7], "focal_length": [2.0, 2.0]},
     "image": {"size": [300, 400]}},
    {"viewpoint": {"R": _look_at_cv_w2c([1.0, 2.0, -2.0])[0].tolist(), "T": [0.1, -0.2, 3.0]}},
]


def _cases():
    """(name, writer of the fixture into a directory, call of a conventions module on it)."""
    return [
        ("sapien", _write_sapien, lambda m, d: m.load_sapien(d, "train", img_wh=(64, 48))),
        ("sapien via load_cameras", _write_sapien, lambda m, d: m.load_cameras("sapien", d, split="train")),
        ("blender", _write_blender, lambda m, d: m.load_blender(d, "train", img_wh=(800, 800))),
        ("srn", _write_srn, lambda m, d: m.load_srn(d)),
        ("dtu", _write_dtu, lambda m, d: m.load_dtu(d)),
        ("dtu scaled", lambda d: _write_dtu(d, with_scale=True), lambda m, d: m.load_dtu(d)),
        ("neus", lambda d: _write_dtu(d, "cameras_sphere.npz"), lambda m, d: m.load_neus(d)),
        ("replica", _write_replica, lambda m, d: m.load_replica(os.path.join(d, "cameras.json"), img_wh=(512, 512))),
        ("colmap", _write_colmap, lambda m, d: m.load_colmap(d, img_wh=(320, 240))),
        ("colmap native size", lambda d: _write_colmap(d, with_points=False), lambda m, d: m.load_colmap(d)),
        ("colmap via load_cameras", _write_colmap, lambda m, d: m.load_cameras("colmap", d)),
        ("co3d", lambda d: None, lambda m, d: m.load_co3d_frames(CO3D_FRAMES)),
        ("spheric", lambda d: None, lambda m, d: m.load_cameras("spheric", "", radius=3.5, n_poses=5, phi_deg=-20.0)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=[c[0] for c in _cases()])
def test_conventions_loader_equals_jax(tmp_path, case):
    _, write, load = case
    write(str(tmp_path))
    got, want = load(cv, str(tmp_path)), load(jcv, str(tmp_path))
    assert isinstance(got, cv.CameraSet) and len(got) == len(want)
    assert (got.focal, tuple(got.img_wh), got.convention) == (want.focal, tuple(want.img_wh), want.convention)
    np.testing.assert_array_equal(got.c2ws, want.c2ws)
    np.testing.assert_array_equal(got.centers(), want.centers())
    if want.points is None:
        assert got.points is None
    else:
        np.testing.assert_array_equal(got.points, want.points)
    R = got.c2ws[:, :3, :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape), atol=2e-6)
    # the frusta, their merged line set and its PLY
    pts, lines = cv.cameraset_lineset(got, frustum_length=0.4)
    jpts, jlines = jcv.cameraset_lineset(want, frustum_length=0.4)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(lines, jlines)
    cv.write_lineset_ply(str(tmp_path / "port.ply"), pts, lines)
    jcv.write_lineset_ply(str(tmp_path / "jax.ply"), jpts, jlines)
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


def test_unknown_convention_raises_on_both():
    for mod in (cv, jcv):
        with pytest.raises(ValueError, match="unknown camera convention"):
            mod.load_cameras("lidar", "/nope")


def test_box_projection_and_alignment_helpers_equal_jax():
    K = np.array([[420.0, 0.0, 200.0], [0.0, 415.0, 150.0], [0.0, 0.0, 1.0]])
    R, t = _look_at_cv_w2c([2.0, -1.0, 1.2])
    P = 4.2 * K @ np.concatenate([R, t[:, None]], axis=1)
    for a, b in zip(cv.decompose_projection(P), jcv.decompose_projection(P)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cv.get_3d_bbox([2.0, 4.0, 6.0], shift=[1.0, 0.0, 0.0]),
                                  jcv.get_3d_bbox([2.0, 4.0, 6.0], shift=[1.0, 0.0, 0.0]))
    pts = np.random.default_rng(31).normal(size=(7, 3))
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R, t
    np.testing.assert_array_equal(cv.project_points(K, w2c, pts), jcv.project_points(K, w2c, pts))
    np.testing.assert_array_equal(cv.from_pytorch3d(R, t), jcv.from_pytorch3d(R, t))
    cams, jcams = cv.spheric_cameras(n_poses=4), jcv.spheric_cameras(n_poses=4)
    cams.points = jcams.points = pts
    box = np.eye(4)
    box[:3, :3], box[:3, 3] = R, [1.0, -2.0, 0.5]
    a, b = cv.axis_align(cams, box), jcv.axis_align(jcams, box)
    np.testing.assert_array_equal(a.c2ws, b.c2ws)
    np.testing.assert_array_equal(a.points, b.points)


def test_segmented_rays_equal_jax():
    rng = np.random.default_rng(41)
    h, w = 30, 40
    masks = rng.uniform(size=(h, w, 3)) > 0.6  # overlapping classes: later ones overwrite
    masks[:2, :2, 1] = True
    rays_o = rng.normal(size=(h * w, 3)).astype(np.float32)
    rays_d = rng.normal(size=(h * w, 3)).astype(np.float32)
    ids = [7, 2, 5]
    np.testing.assert_array_equal(seg.build_seg_mask(masks, ids), jseg.build_seg_mask(masks, ids))
    got = seg.get_rays_segmented(masks, ids, rays_o, rays_d, w, h, 64, rng=np.random.default_rng(42))
    want = jseg.get_rays_segmented(masks, ids, rays_o, rays_d, w, h, 64, rng=np.random.default_rng(42))
    assert got[2] == want[2] == [2, 5, 7]
    for a_list, b_list in zip(got[:2], want[:2]):
        assert len(a_list) == len(b_list) == 3
        for a, b in zip(a_list, b_list):
            assert a.shape == (64, 3)
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[3], want[3])
    empty = masks.copy()
    empty[..., 2] = False  # class 5 has no pixel left
    for mod in (seg, jseg):
        with pytest.raises(ValueError, match="class 5 has no pixels"):
            mod.get_rays_segmented(empty, ids, rays_o, rays_d, w, h, 4, rng=np.random.default_rng(0))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_single_scene(str(tmp_path_factory.mktemp("scene")), img_wh=(40, 30), n_train=6, n_val=0,
                                 n_test=0, seed=2)


def test_check_poses_report_equals_jax(scene):
    with open(os.path.join(scene, "train", "transforms.json")) as f:
        c2ws = np.asarray(list(json.load(f)["frames"].values()))
    bad = c2ws.copy()
    bad[1, :3, 0] *= 1.01  # not orthonormal
    bad[2, :3, :3] = -bad[2, :3, :3]  # left-handed, looking away
    for stack, kwargs in ((c2ws, {"expect_radius": 4.0, "radius_tol": 0.5}), (bad, {}), (c2ws[0, :3], {})):
        got, want = check.check_poses(stack, **kwargs), jcheck.check_poses(stack, **kwargs)
        assert got == want
    assert check.check_poses(c2ws, expect_radius=4.0, radius_tol=0.5)["ok"]
    assert check.check_poses(c2ws, expect_radius=4.0, radius_tol=0.5)["radius"]["n_outside_expected"] == 0
    assert not check.check_poses(bad)["ok"]


@pytest.mark.parametrize("argv", [["--expect-radius", "4.0"], ["--convention", "sapien"], ["--convention", "srn"]])
def test_check_poses_cli_equals_jax(scene, tmp_path, capsys, argv):
    root = scene
    if "srn" in argv:
        root = str(tmp_path)
        _write_srn(root)
    check.main(["--root", root, *argv])
    got = json.loads(capsys.readouterr().out)
    jcheck.main(["--root", root, *argv])
    assert got == json.loads(capsys.readouterr().out)
    assert got["ok"] and got["has_focal"]


def test_plot_cameras_and_the_viz_clis_write_files(scene, tmp_path, capsys):
    with open(os.path.join(scene, "train", "transforms.json")) as f:
        c2ws = np.asarray(list(json.load(f)["frames"].values()))
    out = cameras.plot_cameras(c2ws, str(tmp_path / "cams.png"), focal=30.0, img_wh=(40, 30), rays_per_cam=3)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    cameras.main(["--root", scene, "--out", str(tmp_path / "cli.png")])
    assert json.loads(capsys.readouterr().out) == {"out": str(tmp_path / "cli.png"), "cameras": 6}
    cv.main(["--convention", "sapien", "--root", scene, "--split", "train", "--out", str(tmp_path / "cv.png"),
             "--ply", str(tmp_path / "cv.ply")])
    summary = json.loads(capsys.readouterr().out)
    assert summary == {"out": str(tmp_path / "cv.png"), "cameras": 6, "convention": "sapien",
                       "ply": str(tmp_path / "cv.ply")}
    assert (tmp_path / "cv.png").stat().st_size > 0 and (tmp_path / "cv.ply").read_text().startswith("ply")
