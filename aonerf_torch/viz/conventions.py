"""Multi-convention camera-pose loaders and the shared frustum geometry,
headless (counterpart of ``aonerf.viz.conventions``).

The reference's per-dataset viewer scripts in ``visualize_nerf/``
(visualize_cameras_srn.py, _dtu.py, _neus.py, _replica.py, _nsff.py,
_co3d.py, _objectron.py, _nocs.py, _nerf_synethetic.py, _sapien.py) each pair
a dataset-specific pose loader and its coordinate-convention fix with a copy
of the same open3d frustum/LineSet code. This module factors that suite
into

  * a loader registry (``load_cameras``) that normalizes every convention
    into OpenGL-style camera-to-world matrices (x right, y up, z backward,
    the convention of ``aonerf_torch.data.camera``), so one downstream path
    (viz/cameras.py::plot_cameras, viz/check_poses.py) serves them all, and
  * one shared frustum geometry (``camera_frustum`` /
    ``frustums_to_lineset``, reference visualize_cameras_srn.py:62-109) with
    an ASCII-PLY edge-set writer in place of the open3d LineSet viewer (the
    PLY opens in any mesh viewer).

Box/NOCS helpers (``get_3d_bbox``, homogeneous-point projection) mirror the
utilities duplicated across visualize_cameras_nocs.py / _objectron.py
(:258-299 in each). Everything is host-side numpy.
"""

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from aonerf_torch.data.camera import focal_from_meta
from aonerf_torch.ops.rays import create_spheric_poses
from aonerf_torch.utils.transforms import invert_se3, quat_to_matrix

# Camera-axis flip between OpenCV (x right, y down, z forward) and OpenGL
# (x right, y up, z backward) conventions; applied on the RIGHT of a c2w it
# re-labels the camera axes without moving the camera.  The reference calls
# this ``srn_coords_trans`` (visualize_cameras_srn.py:205) and
# ``_coord_trans_cam`` (visualize_cameras_dtu.py:264-268).
FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])


@dataclass
class CameraSet:
    """Cameras of one split, normalized to OpenGL c2w."""

    c2ws: np.ndarray  # (N, 4, 4) float64, OpenGL convention
    focal: Optional[float] = None
    img_wh: Tuple[int, int] = (320, 240)
    convention: str = "unknown"
    points: Optional[np.ndarray] = None  # (P, 3) sparse/context points, if any

    def __len__(self) -> int:
        return int(self.c2ws.shape[0])

    def centers(self) -> np.ndarray:
        return self.c2ws[:, :3, 3]


def _as_c2w44(mats: Sequence[np.ndarray]) -> np.ndarray:
    out = np.zeros((len(mats), 4, 4), dtype=np.float64)
    for i, m in enumerate(mats):
        m = np.asarray(m, dtype=np.float64)
        out[i, :3, :4] = m[:3, :4]
        out[i, 3, 3] = 1.0
    return out


# ---------------------------------------------------------------------------
# Per-convention loaders
# ---------------------------------------------------------------------------


def load_sapien(root: str, split: str = "train", img_wh=(320, 240)) -> CameraSet:
    """SAPIEN transforms.json with a ``frames`` dict of name → 4x4 c2w
    (visualize_cameras_sapien.py, datasets/sapien.py:56-76). Already OpenGL."""
    with open(os.path.join(root, split, "transforms.json")) as f:
        meta = json.load(f)
    c2ws = _as_c2w44([np.asarray(v) for v in meta["frames"].values()])
    return CameraSet(c2ws, focal_from_meta(meta, img_wh), img_wh, "sapien")


def load_blender(root: str, split: str = "train", img_wh=(800, 800)) -> CameraSet:
    """NeRF-synthetic transforms_{split}.json: a ``frames`` LIST of dicts
    with ``transform_matrix`` + global ``camera_angle_x``
    (visualize_cameras_nerf_synethetic.py:258-266). Already OpenGL."""
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    c2ws = _as_c2w44([np.asarray(fr["transform_matrix"]) for fr in meta["frames"]])
    w, _ = img_wh
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return CameraSet(c2ws, focal, img_wh, "blender")


def load_srn(root: str) -> CameraSet:
    """SRN/ShapeNet instance dir: ``pose/*.txt`` row-major 4x4 c2w in OpenCV
    camera axes + ``intrinsics.txt`` (focal on line 1, "H W" on the last
    line).  Convention fix: c2w @ diag(1,-1,-1,1)
    (visualize_cameras_srn.py:203-226, load_intrinsic :193-199)."""
    posefiles = sorted(glob.glob(os.path.join(root, "pose", "*.txt")))
    mats = [np.loadtxt(p).reshape(4, 4) @ FLIP_YZ for p in posefiles]
    with open(os.path.join(root, "intrinsics.txt")) as f:
        lines = f.read().splitlines()
    focal = float(lines[0].split()[0])
    h, w = (int(v) for v in lines[-1].split())
    return CameraSet(_as_c2w44(mats), focal, (w, h), "srn")


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K (3x3, K[2,2]=1), R (w2c rotation), camera center c from a 3x4
    projection P = K @ [R | -R c] — numpy RQ replacement for the reference's
    cv2.decomposeProjectionMatrix (visualize_cameras_dtu.py:303-308)."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    center = -np.linalg.solve(M, P[:, 3])
    # RQ decomposition of M via QR of the row/column-reversed transpose.
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    # Positive-diagonal K (projective scale signs fold into R).
    sign = np.diag(np.sign(np.diag(K)))
    K, R = K @ sign, sign @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    return K / K[2, 2], R, center


def load_dtu(root: str, npz_name: str = "cameras.npz", img_wh=(400, 300)) -> CameraSet:
    """DTU/IDR cameras.npz: per-view ``world_mat_i`` (3x4 projection
    K[R|t]) + optional ``scale_mat_i`` normalization.  c2w = [R^T | c],
    scale-normalized, then world+camera axis flips diag(1,-1,-1,1) on both
    sides (visualize_cameras_dtu.py:258-325).  NeuS ``cameras_sphere.npz``
    shares the layout — see :func:`load_neus`."""
    data = np.load(os.path.join(root, npz_name))
    n = len([k for k in data.files if k.startswith("world_mat_") and "inv" not in k])
    mats, focal = [], None
    for i in range(n):
        K, R, center = decompose_projection(data[f"world_mat_{i}"][:3])
        focal = float(K[0, 0])
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, 3] = center
        scale = data[f"scale_mat_{i}"] if f"scale_mat_{i}" in data.files else None
        if scale is not None:
            pose[:3, 3] -= scale[:3, 3]
            pose[:3, 3] /= np.diagonal(scale[:3, :3])
        mats.append(FLIP_YZ @ pose @ FLIP_YZ)
    return CameraSet(_as_c2w44(mats), focal, img_wh, "dtu")


def load_neus(root: str, img_wh=(400, 300)) -> CameraSet:
    """NeuS cameras_sphere.npz — DTU layout (visualize_cameras_neus.py)."""
    cams = load_dtu(root, npz_name="cameras_sphere.npz", img_wh=img_wh)
    cams.convention = "neus"
    return cams


def load_replica(camera_file: str, img_wh=(512, 512)) -> CameraSet:
    """Replica/GSN cameras.json: list of {``Rt``: 4x4 w2c, ``K``}; c2w is
    the inverse (visualize_cameras_replica.py:205-215).  The GSN export is
    already OpenGL; focal from K[0,0] scaled by the fov-90 rule the
    reference applies (:218-221)."""
    with open(camera_file) as f:
        data = json.load(f)
    mats = [invert_se3(np.asarray(item["Rt"], dtype=np.float64)) for item in data]
    k00 = float(np.asarray(data[0]["K"])[0][0]) if data else 1.0
    half_w = img_wh[0] / 2.0
    focal = k00 * half_w / np.tan(np.deg2rad(90.0) / 2.0)
    return CameraSet(_as_c2w44(mats), focal, img_wh, "replica")


def _parse_colmap_cameras_txt(path: str) -> Dict[int, Tuple[float, int, int]]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, w, h = int(parts[0]), int(parts[2]), int(parts[3])
            cams[cam_id] = (float(parts[4]), w, h)
    return cams


def load_colmap(scene_dir: str, img_wh: Optional[Tuple[int, int]] = None) -> CameraSet:
    """COLMAP text model in ``{scene_dir}/sparse/0`` — the NSFF layout
    (visualize_cameras_nsff.py:688-760): cameras.txt (focal = params[0],
    rescaled to img_wh), images.txt (per-image QW QX QY QZ TX TY TZ = w2c;
    c2w is the inverse, then OpenCV→OpenGL camera-axis flip), and optional
    points3D.txt sparse points for context.  CameraSet carries one intrinsic
    set, taken from the FIRST image's CAMERA_ID — multi-camera rigs display
    with that camera's focal."""
    model = os.path.join(scene_dir, "sparse", "0")
    cams = _parse_colmap_cameras_txt(os.path.join(model, "cameras.txt"))

    mats, cam_ids = [], []
    with open(os.path.join(model, "images.txt")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    # every image record is 2 lines and the 2nd (its 2D points) may be EMPTY,
    # so pairing must alternate rather than index filtered lines
    expecting_pose = True
    for ln in lines:
        if not expecting_pose:  # the POINTS2D line, possibly blank: skip it
            expecting_pose = True
            continue
        if not ln.strip():  # stray blank between records
            continue
        parts = ln.split()
        q = np.array([float(v) for v in parts[1:5]])  # w, x, y, z
        t = np.array([float(v) for v in parts[5:8]])
        cam_ids.append(int(parts[8]))
        w2c = np.eye(4)
        w2c[:3, :3] = quat_to_matrix(q)
        w2c[:3, 3] = t
        mats.append(invert_se3(w2c) @ FLIP_YZ)
        expecting_pose = False

    f0, w0, h0 = cams[cam_ids[0]] if cam_ids else next(iter(cams.values()))
    if img_wh is None:
        img_wh = (w0, h0)
    focal = f0 * img_wh[0] / w0

    points = None
    pts_path = os.path.join(model, "points3D.txt")
    if os.path.exists(pts_path):
        rows = []
        with open(pts_path) as f:
            for ln in f:
                ln = ln.strip()
                if ln and not ln.startswith("#"):
                    p = ln.split()
                    rows.append([float(p[1]), float(p[2]), float(p[3])])
        points = np.asarray(rows, dtype=np.float64) if rows else None
    return CameraSet(_as_c2w44(mats), focal, img_wh, "colmap", points=points)


def from_pytorch3d(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """One c2w (OpenGL) from a PyTorch3D camera (R, T) — the CO3D
    annotation convention (visualize_cameras_co3d.py:353-400 via
    datasets/co3d).  PyTorch3D maps row-vectors x_cam = x_world @ R + T
    with camera axes (+x left, +y up, +z forward); so the column-form c2w
    rotation is R with center -R @ T, and the axis relabel to OpenGL is
    diag(-1, 1, -1)."""
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    c2w = np.eye(4)
    c2w[:3, :3] = R @ np.diag([-1.0, 1.0, -1.0])
    c2w[:3, 3] = -R @ T
    return c2w


def load_co3d_frames(frame_annotations: Sequence[dict]) -> CameraSet:
    """CO3D frame annotations: list of {"viewpoint": {"R", "T",
    "focal_length"}, "image": {"size": [h, w]}} (the co3d dataset JSON
    schema consumed by visualize_cameras_co3d.py)."""
    mats, focal, img_wh = [], None, (200, 200)
    for fr in frame_annotations:
        vp = fr["viewpoint"]
        mats.append(from_pytorch3d(np.asarray(vp["R"]), np.asarray(vp["T"])))
        if "focal_length" in vp:
            h, w = fr.get("image", {}).get("size", (200, 200))
            img_wh = (int(w), int(h))
            # NDC focal → pixels (pytorch3d convention: f_ndc * min(h,w)/2)
            focal = float(np.asarray(vp["focal_length"]).ravel()[0]) * min(h, w) / 2.0
    return CameraSet(_as_c2w44(mats), focal, img_wh, "co3d")


def spheric_cameras(
    radius: float = 4.0, n_poses: int = 40, phi_deg: float = -30.0, focal: float = 280.0
) -> CameraSet:
    """Synthetic spheric orbit (objectron/nocs test path,
    visualize_cameras_objectron.py:34-56; identical math to
    ops/rays.create_spheric_poses)."""
    c2ws = create_spheric_poses(radius, n_poses, phi_deg).astype(np.float64)
    return CameraSet(c2ws, focal, (320, 240), "spheric")


def axis_align(cams: CameraSet, box_transformation: np.ndarray) -> CameraSet:
    """Re-express cameras AND context points in the canonical box frame:
    c2w ← inv(box_transformation) @ c2w (visualize_cameras_objectron.py:
    154,534 — objectron/NOCS annotations give the object-box-to-world
    transform)."""
    inv_box = np.linalg.inv(np.asarray(box_transformation, dtype=np.float64))
    return CameraSet(
        np.einsum("ij,njk->nik", inv_box, cams.c2ws),
        cams.focal,
        cams.img_wh,
        cams.convention,
        points=None if cams.points is None else transform_points(inv_box, cams.points),
    )


LOADERS = {
    "sapien": load_sapien,
    "blender": load_blender,
    "srn": load_srn,
    "dtu": load_dtu,
    "neus": load_neus,
    "replica": load_replica,
    "colmap": load_colmap,
}


def load_cameras(convention: str, root: str, **kwargs) -> CameraSet:
    """Dispatch to the loader for ``convention`` (see ``LOADERS``)."""
    if convention == "spheric":
        return spheric_cameras(**kwargs)
    if convention not in LOADERS:
        raise ValueError(f"unknown camera convention {convention!r}; "
                         f"have {sorted(LOADERS) + ['spheric']}")
    return LOADERS[convention](root, **kwargs)


# ---------------------------------------------------------------------------
# Box / NOCS utilities (visualize_cameras_nocs.py:258-299, shared with
# visualize_cameras_objectron.py)
# ---------------------------------------------------------------------------


def get_3d_bbox(size, shift=0) -> np.ndarray:
    """(8, 3) axis-aligned box corners of extents ``size`` centered at
    ``shift`` (reference get_3d_bbox, returned transposed there)."""
    size = np.broadcast_to(np.asarray(size, dtype=np.float64), (3,))
    signs = np.array(
        [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
        dtype=np.float64,
    )
    return signs * (size / 2.0) + shift


def transform_points(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points (reference
    convert_points_to_homopoints/convert_homopoints_to_points pair)."""
    P = np.concatenate([points, np.ones_like(points[:, :1])], axis=1)
    out = P @ np.asarray(T, dtype=np.float64).T
    return out[:, :3] / out[:, 3:4]


def project_points(K: np.ndarray, w2c_cv: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Pinhole-project (N, 3) world points to (N, 2) pixels through an
    OpenCV-convention w2c (reference project_3d_point semantics in
    visualize_cameras_nocs.py)."""
    cam = transform_points(w2c_cv, points)
    uv = cam @ np.asarray(K, dtype=np.float64).T
    return uv[:, :2] / uv[:, 2:3]


# ---------------------------------------------------------------------------
# Shared frustum geometry (visualize_cameras_srn.py:62-109 — duplicated in
# every reference viewer; built once here)
# ---------------------------------------------------------------------------


def camera_frustum(
    img_wh: Tuple[int, int],
    focal: float,
    c2w: np.ndarray,
    frustum_length: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """(5, 3) world-space frustum points (apex + 4 image corners at
    ``frustum_length``) and (8, 2) edge indices.  The reference builds the
    corners at +z for its OpenCV-convention C2W (get_camera_frustum:62-89);
    our normalized c2ws look along -z, so the corners sit at -z."""
    w, h = img_wh
    half_w = frustum_length * (w / 2.0) / focal
    half_h = frustum_length * (h / 2.0) / focal
    pts_cam = np.array(
        [
            [0.0, 0.0, 0.0],
            [-half_w, -half_h, -frustum_length],
            [half_w, -half_h, -frustum_length],
            [half_w, half_h, -frustum_length],
            [-half_w, half_h, -frustum_length],
        ]
    )
    lines = np.array([[0, i] for i in range(1, 5)] + [[1, 2], [2, 3], [3, 4], [4, 1]])
    c2w = np.asarray(c2w, dtype=np.float64)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return pts, lines


def frustums_to_lineset(
    frustums: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-camera frusta into one (N*5, 3) point / (N*8, 2) edge set
    (reference frustums2lineset:92-109, minus the open3d wrapper)."""
    points = np.concatenate([p for p, _ in frustums], axis=0)
    lines = np.concatenate(
        [l + 5 * i for i, (_, l) in enumerate(frustums)], axis=0
    )
    return points, lines


def cameraset_lineset(
    cams: CameraSet, frustum_length: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    focal = cams.focal if cams.focal is not None else 1.2 * cams.img_wh[0]
    return frustums_to_lineset(
        [camera_frustum(cams.img_wh, focal, c2w, frustum_length) for c2w in cams.c2ws]
    )


def write_lineset_ply(path: str, points: np.ndarray, lines: np.ndarray) -> str:
    """ASCII PLY with vertex + edge elements — the headless stand-in for the
    reference's o3d.geometry.LineSet viewer; opens in meshlab/blender.
    Delegates to the shared writer (viz/pointcloud.py::write_ply)."""
    from aonerf_torch.viz.pointcloud import write_ply

    return write_ply(path, np.asarray(points, dtype=np.float64), edges=lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--convention", required=True,
                   choices=sorted(LOADERS) + ["spheric"])
    p.add_argument("--root", default="", help="dataset root (unused for spheric)")
    p.add_argument("--split", default=None, help="split, for sapien/blender")
    p.add_argument("--out", default="cameras.png")
    p.add_argument("--ply", default=None, help="also export a frustum-lineset PLY")
    p.add_argument("--frustum-length", type=float, default=0.5)
    args = p.parse_args(argv)

    kwargs = {}
    if args.split and args.convention in ("sapien", "blender"):
        kwargs["split"] = args.split
    cams = load_cameras(args.convention, args.root, **kwargs)

    from aonerf_torch.viz.cameras import plot_cameras

    out = plot_cameras(cams.c2ws, args.out, focal=cams.focal, img_wh=cams.img_wh)
    summary = {"out": out, "cameras": len(cams), "convention": cams.convention}
    if args.ply:
        pts, lines = cameraset_lineset(cams, args.frustum_length)
        summary["ply"] = write_lineset_ply(args.ply, pts, lines)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
