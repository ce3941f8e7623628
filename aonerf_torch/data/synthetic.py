"""Analytic articulated "laptop" scene, ray-traced in numpy (counterpart of
``aonerf.data.synthetic``).

A base slab and a lid slab hinged at its back edge, the lid pitched by the
articulation angle. It gives real multi-view-consistent views in memory;
``generate_single_scene`` writes them in the SAPIEN layout (with depth
PNGs on request), ``replay_scene`` re-renders the poses of a saved
transforms.json and ``generate_multi_scene`` writes the articulated
sapien_multi layout, with PIL. The datagen CLI
(``aonerf_torch.data.datagen.generate``) drives all three.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from aonerf_torch.data.camera import get_ray_directions_np, look_at_c2w

# 35 deg vertical field of view; images are 320x240 native.
FOVY_DEG = 35.0


@dataclass
class Box:
    """Oriented box: axis-aligned with ``half`` extents in its own frame,
    placed by the 4x4 ``pose`` (box-to-world); ``color`` is base albedo."""

    half: np.ndarray
    pose: np.ndarray
    color: np.ndarray


def _rot_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def laptop_scene(articulation_deg: float, instance_seed: int = 0) -> List[Box]:
    """Two-part laptop: base slab on the 'table', lid hinged at the back edge,
    opened by ``articulation_deg`` (0 = closed flat). The instance seed varies
    the part sizes and colors."""
    rng = np.random.default_rng(instance_seed + 12345)
    bw = 1.0 + 0.3 * rng.uniform(-1, 1)  # base half-width (x)
    bd = 0.7 + 0.2 * rng.uniform(-1, 1)  # base half-depth (y)
    th = 0.06  # slab half-thickness
    base_color = rng.uniform(0.25, 0.9, size=3)
    lid_color = rng.uniform(0.25, 0.9, size=3)

    base_pose = np.eye(4)
    base_pose[2, 3] = -0.4  # sit slightly below origin

    # Lid hinges about the back edge of the base (y = -bd, z = base top).
    hinge = np.eye(4)
    hinge[1, 3] = -bd
    hinge[2, 3] = base_pose[2, 3] + th
    lid_local = np.eye(4)
    lid_local[1, 3] = bd  # lid extends forward from the hinge before rotation
    lid_local[2, 3] = th
    lid_pose = hinge @ _rot_x(-articulation_deg) @ lid_local

    return [
        Box(half=np.array([bw, bd, th]), pose=base_pose, color=base_color),
        Box(half=np.array([bw, bd, th]), pose=lid_pose, color=lid_color),
    ]


def _ray_box_hits(
    o: np.ndarray, d: np.ndarray, box: Box
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ray/oriented-box intersection.

    Returns (hit (N,), t (N,), normal_world (N, 3)) for first entry points.
    """
    w2b = np.linalg.inv(box.pose)
    ob = o @ w2b[:3, :3].T + w2b[:3, 3]
    db = d @ w2b[:3, :3].T
    db = np.where(np.abs(db) < 1e-12, 1e-12, db)
    inv = 1.0 / db
    lo = (-box.half - ob) * inv
    hi = (box.half - ob) * inv
    t0 = np.minimum(lo, hi)
    t1 = np.maximum(lo, hi)
    tmin = t0.max(axis=-1)
    tmax = t1.min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)  # inside-the-box rays exit-hit

    # Normal = axis of the slab that produced tmin (box frame), world-rotated.
    axis = np.argmax(t0, axis=-1)
    n_box = np.zeros_like(ob)
    n_box[np.arange(len(axis)), axis] = -np.sign(db[np.arange(len(axis)), axis])
    n_world = n_box @ box.pose[:3, :3].T
    return hit, t, n_world


def render_scene(
    boxes: List[Box],
    c2w: np.ndarray,
    h: int,
    w: int,
    focal: float,
    light_dir: np.ndarray = np.array([0.3, 0.5, 0.8]),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-trace the scene. Returns (rgb (H,W,3) float in [0,1],
    alpha (H,W) bool, seg (H,W) uint8 part ids starting at 1)."""
    dirs = get_ray_directions_np(h, w, focal).reshape(-1, 3)
    d = dirs @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    best_t = np.full(len(d), np.inf)
    rgb = np.zeros((len(d), 3))
    seg = np.zeros(len(d), dtype=np.uint8)
    light = light_dir / np.linalg.norm(light_dir)
    for idx, box in enumerate(boxes):
        hit, t, n = _ray_box_hits(o, d, box)
        closer = hit & (t < best_t)
        shade = 0.45 + 0.55 * np.abs(n @ light)
        rgb[closer] = np.clip(box.color * shade[closer, None], 0.0, 1.0)
        seg[closer] = idx + 1
        best_t = np.where(closer, t, best_t)

    alpha = np.isfinite(best_t)
    return rgb.reshape(h, w, 3), alpha.reshape(h, w), seg.reshape(h, w)


def render_depth(boxes: List[Box], c2w: np.ndarray, h: int, w: int, focal: float) -> np.ndarray:
    """Camera-frame z-depth (meters; 0 where no hit), the quantity the
    reference stores from SAPIEN's depth texture."""
    dirs = get_ray_directions_np(h, w, focal).reshape(-1, 3)
    d = dirs @ c2w[:3, :3].T
    norm = np.linalg.norm(d, axis=-1)
    d = d / norm[:, None]
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    best_t = np.full(len(d), np.inf)
    for box in boxes:
        hit, t, _ = _ray_box_hits(o, d, box)
        best_t = np.where(hit & (t < best_t), t, best_t)
    # ray length -> z-depth: the camera-frame direction has z = -1 before
    # normalization, so z = t / ||dir_cam||.
    z = np.where(np.isfinite(best_t), best_t / norm, 0.0)
    return z.reshape(h, w)


def write_depth_png(path: str, depth_m: np.ndarray) -> None:
    """Depth as a millimeter uint16 PNG, the reference's on-disk format."""
    from PIL import Image

    mm = np.clip(depth_m * 1000.0, 0, np.iinfo(np.uint16).max).astype(np.uint16)
    Image.fromarray(mm).save(path)


def random_pose_on_sphere(
    rng: np.random.Generator, radius: float = 4.0, jitter: float = 0.5
) -> np.ndarray:
    """Random camera on a sphere shell (radius +/- jitter) looking at the
    origin, from the upper hemisphere (20-70 deg elevation)."""
    r = radius + rng.uniform(-jitter, jitter)
    theta = rng.uniform(0, 2 * np.pi)
    phi = rng.uniform(np.deg2rad(20), np.deg2rad(70))  # elevation
    eye = np.array(
        [r * np.cos(phi) * np.cos(theta), r * np.cos(phi) * np.sin(theta), r * np.sin(phi)]
    )
    return look_at_c2w(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]))


def _write_frame(
    rgb: np.ndarray, alpha: np.ndarray, seg: np.ndarray, rgb_path: str, seg_path: Optional[str]
) -> None:
    """The RGBA frame (alpha from the hit mask) and, with ``seg_path``, the
    L-mode segmentation (255 on the object)."""
    from PIL import Image  # only the writers need PIL

    rgba = np.concatenate(
        [np.clip(rgb * 255, 0, 255).astype(np.uint8), (alpha[..., None] * 255).astype(np.uint8)], axis=-1
    )
    Image.fromarray(rgba, mode="RGBA").save(rgb_path)
    if seg_path is not None:
        Image.fromarray((seg > 0).astype(np.uint8) * 255, mode="L").save(seg_path)


def generate_single_scene(
    root: str,
    img_wh: Tuple[int, int] = (320, 240),
    n_train: int = 20,
    n_val: int = 4,
    n_test: int = 4,
    articulation_deg: float = 80.0,
    instance_seed: int = 0,
    seed: int = 0,
    write_depth: bool = False,
) -> str:
    """Write a single-scene dataset in the SAPIEN layout
    ({root}/{split}/rgb/r_#.png RGBA + transforms.json with a 'focal' key),
    the same files ``aonerf.data.synthetic.generate_single_scene`` writes;
    ``write_depth`` adds {split}/depth/r_#.png (mm uint16) as the reference
    generator does."""
    w, h = img_wh
    focal = 0.5 * h / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    boxes = laptop_scene(articulation_deg, instance_seed)
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        rgb_dir = os.path.join(root, split, "rgb")
        os.makedirs(rgb_dir, exist_ok=True)
        if write_depth:
            os.makedirs(os.path.join(root, split, "depth"), exist_ok=True)
        frames: Dict[str, list] = {}
        for i in range(count):
            c2w = random_pose_on_sphere(rng)
            rgb, alpha, seg = render_scene(boxes, c2w, h, w, focal)
            name = f"r_{i}"
            _write_frame(rgb, alpha, seg, os.path.join(rgb_dir, name + ".png"), None)
            if write_depth:
                write_depth_png(os.path.join(root, split, "depth", name + ".png"),
                                render_depth(boxes, c2w, h, w, focal))
            frames[name] = c2w.tolist()
        with open(os.path.join(root, split, "transforms.json"), "w") as f:
            json.dump({"focal": focal, "frames": frames}, f)
    return root


def replay_scene(
    root: str,
    transforms_path: str,
    split: str = "replay",
    img_wh: Tuple[int, int] = (320, 240),
    articulation_deg: float = 80.0,
    instance_seed: int = 0,
    write_depth: bool = False,
) -> str:
    """Re-render the scene at the saved camera poses of an existing
    transforms.json (its c2w matrices, and its focal when present) into a
    new {root}/{split}/ in the same layout: the reference's replay mode."""
    with open(transforms_path) as f:
        meta = json.load(f)
    w, h = img_wh
    focal = float(meta.get("focal") or 0.5 * h / np.tan(0.5 * np.deg2rad(FOVY_DEG)))
    boxes = laptop_scene(articulation_deg, instance_seed)
    rgb_dir = os.path.join(root, split, "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    if write_depth:
        os.makedirs(os.path.join(root, split, "depth"), exist_ok=True)
    frames: Dict[str, list] = {}
    for name, mat in meta["frames"].items():
        c2w = np.asarray(mat, dtype=np.float64)
        rgb, alpha, seg = render_scene(boxes, c2w, h, w, focal)
        _write_frame(rgb, alpha, seg, os.path.join(rgb_dir, name + ".png"), None)
        if write_depth:
            write_depth_png(os.path.join(root, split, "depth", name + ".png"), render_depth(boxes, c2w, h, w, focal))
        frames[name] = c2w.tolist()
    with open(os.path.join(root, split, "transforms.json"), "w") as f:
        json.dump({"focal": focal, "frames": frames}, f)
    return root


def generate_multi_scene(
    root: str,
    img_wh: Tuple[int, int] = (320, 240),
    n_instances: int = 2,
    degrees: Tuple[int, ...] = (0, 10, 20, 30, 40, 50, 60, 70, 80, 90),
    n_images: int = 4,
    seed: int = 0,
    val_degrees: Tuple[int, ...] = (),
    n_val_images: int = 0,
) -> str:
    """Write an articulated multi-config dataset in the sapien_multi layout
    ({root}/{instance}/{split}/{deg}_degree/{rgb,seg}/r_#.png +
    transforms.json with a 'camera_angle_x'), the same files as
    ``aonerf.data.synthetic.generate_multi_scene``. ``val_degrees`` (e.g.
    ``sapien_multi.DEFAULT_VAL_DEGREES``) adds {instance}/val/{deg}_degree
    dirs of held-out articulations, ``n_val_images`` views each (default:
    ``n_images``)."""
    w, h = img_wh
    focal = 0.5 * h / np.tan(0.5 * np.deg2rad(FOVY_DEG))
    # camera_angle_x consistent with focal at native width 320
    camera_angle_x = 2.0 * np.arctan(0.5 * 320 / (focal * 320 / w))
    rng = np.random.default_rng(seed)
    splits = [("train", degrees, n_images)]
    if val_degrees:
        splits.append(("val", tuple(val_degrees), n_val_images or n_images))
    for inst in range(n_instances):
        inst_name = f"{10000 + inst}"
        for split, split_degrees, split_images in splits:
            for deg in split_degrees:
                base = os.path.join(root, inst_name, split, f"{deg}_degree")
                os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
                os.makedirs(os.path.join(base, "seg"), exist_ok=True)
                boxes = laptop_scene(float(deg), instance_seed=inst)
                frames: Dict[str, list] = {}
                for i in range(split_images):
                    c2w = random_pose_on_sphere(rng)
                    rgb, alpha, seg = render_scene(boxes, c2w, h, w, focal)
                    name = f"r_{i}"
                    _write_frame(rgb, alpha, seg, os.path.join(base, "rgb", name + ".png"),
                                 os.path.join(base, "seg", name + ".png"))
                    frames[name] = c2w.tolist()
                with open(os.path.join(base, "transforms.json"), "w") as f:
                    json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)
    return root
