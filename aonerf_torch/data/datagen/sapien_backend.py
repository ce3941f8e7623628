"""SAPIEN-backed dataset generation (counterpart of
``aonerf.data.datagen.sapien_backend``).

The reference's generator (datagen/data_gen.py:34-87, data_utils.py:60-241):
an offscreen SAPIEN renderer, a kinematic URDF, lights, a 35 deg fovy camera
and 100/50/50 sphere poses, written as rgb (alpha = seg mask), mm-uint16
depth, seg and transforms.json (per-frame 4x4 c2w model matrix + focal).
Everything that is plain math is a module-level numpy function, testable
without the simulator; only ``SapienSceneRenderer`` touches the ``sapien``
package, imported when one is built.

Coordinate conventions (the reference's):
  - SAPIEN cameras look down +x with z up ("forward/left/up" columns);
    the extrinsic mat44 built here places the camera at ``point`` looking
    at the origin (data_utils.py:105-116).
  - transforms.json stores the OpenGL-style c2w "model matrix" the dataset
    loaders read (camera.get_model_matrix(), data_utils.py:199-241).
"""

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FOVY_DEG = 35.0  # data_gen.py:63
NEAR, FAR = 0.1, 100.0  # data_gen.py:57
SPHERE_RADIUS = 4.0  # data_gen.py:79-83 (radius_=4)
RADIUS_JITTER = 0.5  # data_utils.py:72 (r ~ U[radius-0.5, radius+0.5])


# --------------------------------------------------------------- pure math


def sample_sphere_point(
    rng: np.random.Generator,
    radius: float = SPHERE_RADIUS,
    theta_range: Tuple[float, float] = (0.0, 2.0 * np.pi),
    phi_range: Tuple[float, float] = (0.0, np.pi),
) -> np.ndarray:
    """Random point on the jittered sphere shell (data_utils.py:65-80):
    azimuth theta, polar phi, r ~ U[radius-0.5, radius+0.5]."""
    theta = rng.uniform(*theta_range)
    phi = rng.uniform(*phi_range)
    r = rng.uniform(radius - RADIUS_JITTER, radius + RADIUS_JITTER)
    return np.array(
        [
            r * np.sin(phi) * np.cos(theta),
            r * np.sin(phi) * np.sin(theta),
            r * np.cos(phi),
        ]
    )


def camera_extrinsic_mat44(point: np.ndarray) -> np.ndarray:
    """SAPIEN camera pose looking from ``point`` at the origin
    (data_utils.py:105-116): columns are (forward, left, up) with forward =
    -point normalized, left = z x forward, up = forward x left."""
    eye = np.asarray(point, np.float64)
    forward = -eye / np.linalg.norm(eye)
    left = np.cross([0.0, 0.0, 1.0], forward)
    left = left / np.linalg.norm(left)
    up = np.cross(forward, left)
    mat44 = np.eye(4)
    mat44[:3, :3] = np.stack([forward, left, up], axis=1)
    mat44[:3, 3] = eye
    return mat44


def seg_masked_rgba(rgba_float: np.ndarray, seg_labels: np.ndarray) -> np.ndarray:
    """uint8 RGBA whose alpha is zeroed outside the object: alpha *=
    (sum of seg channels > 0) — the reference's seg-mask alpha
    (data_utils.py:128-139)."""
    rgba = (np.asarray(rgba_float) * 255.0).clip(0, 255).astype(np.uint8)
    mask = (np.asarray(seg_labels).sum(axis=-1) > 0).astype(np.uint8)
    rgba[..., 3] = rgba[..., 3] * mask
    return rgba


def depth_mm_u16(position_texture: np.ndarray) -> np.ndarray:
    """Depth in millimeter uint16 from the Position texture: depth =
    -position.z (camera frame), * 1000 (data_utils.py:88-95)."""
    depth = -np.asarray(position_texture)[..., 2]
    return (depth * 1000.0).clip(0, np.iinfo(np.uint16).max).astype(np.uint16)


def qpos_for_degrees(n_dof: int, deg: float) -> np.ndarray:
    """Joint position vector setting every dof to ``deg`` degrees (the
    revolute articulation sweep the multi dataset needs; radians)."""
    return np.full((n_dof,), np.deg2rad(deg), np.float64)


def focal_from_fovy(h: int, fovy_deg: float = FOVY_DEG) -> float:
    """fy for a pinhole camera of height h (== camera.fy, the 'focal' key
    the loaders read, data_utils.py:199-205)."""
    return 0.5 * h / np.tan(0.5 * np.deg2rad(fovy_deg))


# -------------------------------------------------------- simulator renderer


class SapienSceneRenderer:
    """Owns the SAPIEN engine/scene/camera for one URDF object.

    Mirrors data_gen.py:34-67: offscreen renderer, kinematic URDF with fixed
    root, ambient+directional+3 point lights, 35° fovy camera.
    """

    def __init__(self, urdf_file: str, img_wh: Tuple[int, int] = (512, 512)):
        import sapien.core as sapien  # import-guarded: simulator optional

        self._sapien = sapien
        self.engine = sapien.Engine()
        self.renderer = sapien.SapienRenderer(offscreen_only=True)
        self.engine.set_renderer(self.renderer)
        self.scene = self.engine.create_scene()
        self.scene.set_timestep(1 / 100.0)

        loader = self.scene.create_urdf_loader()
        loader.fix_root_link = True
        self.asset = loader.load_kinematic(str(urdf_file))
        if not self.asset:
            raise ValueError(f"URDF not loaded: {urdf_file}")

        self.scene.set_ambient_light([0.5, 0.5, 0.5])
        self.scene.add_directional_light([0, 1, -1], [0.5, 0.5, 0.5], shadow=True)
        self.scene.add_point_light([1, 2, 2], [1, 1, 1], shadow=True)
        self.scene.add_point_light([1, -2, 2], [1, 1, 1], shadow=True)
        self.scene.add_point_light([-1, 0, 1], [1, 1, 1], shadow=True)

        w, h = img_wh
        self.camera = self.scene.add_camera(
            name="camera", width=w, height=h,
            fovy=float(np.deg2rad(FOVY_DEG)), near=NEAR, far=FAR,
        )

    @property
    def n_dof(self) -> int:
        return int(self.asset.dof)

    def render_at(
        self, point: np.ndarray, qpos: Optional[np.ndarray] = None
    ) -> Dict[str, np.ndarray]:
        """Render one frame from ``point`` looking at the origin
        (data_utils.py:117-187): returns seg-masked rgba (uint8), depth
        (mm uint16), actor-level seg labels (uint8), and the c2w model
        matrix for transforms.json."""
        mat44 = camera_extrinsic_mat44(point)
        self.camera.set_pose(self._sapien.Pose.from_transformation_matrix(mat44))
        if qpos is not None:
            self.asset.set_qpos(np.asarray(qpos))
        self.scene.step()
        self.scene.update_render()
        self.camera.take_picture()

        rgba_f = self.camera.get_float_texture("Color")  # (H, W, 4)
        seg = self.camera.get_uint32_texture("Segmentation")  # (H, W, 4)
        pos = self.camera.get_float_texture("Position")
        return {
            "rgba": seg_masked_rgba(rgba_f, seg),
            "depth_mm": depth_mm_u16(pos),
            "seg_actor": seg[..., 1].astype(np.uint8),
            "c2w": np.asarray(self.camera.get_model_matrix()),
            "mat44": mat44,
        }


def _write_split(
    rend: "SapienSceneRenderer",
    split_dir: str,
    points: Sequence[np.ndarray],
    qpos: Optional[np.ndarray],
    write_seg: bool = False,
    pose_out: Optional[str] = None,
) -> None:
    """Render ``points`` into {split_dir}/{rgb,depth[,seg]}/r_#.png +
    transforms.json — the reference's per-split layout
    (data_utils.py:189-241)."""
    from PIL import Image

    rgb_dir = os.path.join(split_dir, "rgb")
    depth_dir = os.path.join(split_dir, "depth")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)
    if write_seg:
        os.makedirs(os.path.join(split_dir, "seg"), exist_ok=True)

    frames: Dict[str, list] = {}
    render_poses: Dict[str, list] = {}
    for i, point in enumerate(points):
        out = rend.render_at(point, qpos=qpos)
        name = f"r_{i}"
        Image.fromarray(out["rgba"]).save(
            os.path.join(rgb_dir, name + ".png")
        )
        Image.fromarray(out["depth_mm"]).save(
            os.path.join(depth_dir, f"depth{i}.png")
        )
        if write_seg:
            Image.fromarray(out["seg_actor"]).save(
                os.path.join(split_dir, "seg", name + ".png")
            )
        frames[name] = out["c2w"].tolist()
        render_poses[name] = out["mat44"].tolist()

    with open(os.path.join(split_dir, "transforms.json"), "w") as f:
        json.dump({"focal": float(rend.camera.fy), "frames": frames}, f)
    if pose_out:
        os.makedirs(os.path.dirname(pose_out), exist_ok=True)
        with open(pose_out, "w") as f:
            json.dump(render_poses, f)


def generate_sapien_scene(cfg: dict) -> str:
    """Single-scene generation (data_gen.py:79-87): 100 train / 50 test /
    50 val random sphere poses at radius 4. Config keys: urdf_file, out_dir,
    img_wh, counts (optional {split: n}), articulation_deg (optional qpos),
    seed, save_render_pose_dir (optional)."""
    rend = SapienSceneRenderer(cfg["urdf_file"], tuple(cfg.get("img_wh", (512, 512))))
    rng = np.random.default_rng(cfg.get("seed", 0))
    counts = cfg.get("counts", {"train": 100, "test": 50, "val": 50})
    qpos = (
        qpos_for_degrees(rend.n_dof, float(cfg["articulation_deg"]))
        if cfg.get("articulation_deg") is not None
        else None
    )
    pose_dir = cfg.get("save_render_pose_dir")
    for split, n in counts.items():
        points = [sample_sphere_point(rng) for _ in range(n)]
        _write_split(
            rend,
            os.path.join(cfg["out_dir"], split),
            points,
            qpos,
            pose_out=os.path.join(pose_dir, split + ".json") if pose_dir else None,
        )
    return cfg["out_dir"]


def generate_sapien_multi(cfg: dict) -> str:
    """Articulated multi-config generation in the sapien_multi layout the
    loaders consume ({root}/{instance}/{split}/{deg}_degree/...,
    datasets/sapien_multi.py:123-199): one renderer per URDF instance, one
    subdirectory per articulation degree with the joint(s) posed there.
    Config keys: urdf_files (list), out_dir, img_wh, degrees, n_images,
    seed."""
    degrees = list(cfg.get("degrees", range(0, 100, 10)))
    n_images = int(cfg.get("n_images", 60))
    rng = np.random.default_rng(cfg.get("seed", 0))
    for inst, urdf in enumerate(cfg["urdf_files"]):
        rend = SapienSceneRenderer(urdf, tuple(cfg.get("img_wh", (320, 240))))
        for split in ("train", "val"):
            for deg in degrees:
                points = [sample_sphere_point(rng) for _ in range(n_images)]
                _write_split(
                    rend,
                    os.path.join(
                        cfg["out_dir"], str(inst), split, f"{int(deg)}_degree"
                    ),
                    points,
                    qpos_for_degrees(rend.n_dof, float(deg)),
                    write_seg=True,
                )
    return cfg["out_dir"]


def replay_sapien_scene(cfg: dict) -> str:
    """Saved-pose replay (data_utils.py:244-288 / data_gen.py:77-79): render
    at the mat44 poses stored by a previous run's save_render_pose_dir.
    Config keys: urdf_file, out_dir, img_wh, render_pose_path ({split}.json
    files), splits."""
    rend = SapienSceneRenderer(cfg["urdf_file"], tuple(cfg.get("img_wh", (512, 512))))
    qpos = (
        qpos_for_degrees(rend.n_dof, float(cfg["articulation_deg"]))
        if cfg.get("articulation_deg") is not None
        else None
    )
    for split in cfg.get("splits", ("train", "test", "val")):
        with open(os.path.join(cfg["render_pose_path"], split + ".json")) as f:
            poses = json.load(f)
        points = [np.asarray(m)[:3, 3] for m in poses.values()]
        _write_split(rend, os.path.join(cfg["out_dir"], split), points, qpos)
    return cfg["out_dir"]
