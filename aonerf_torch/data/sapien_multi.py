"""Articulated multi-configuration SAPIEN layout (counterpart of
``aonerf.data.sapien_multi``).

  {root}/{instance}/{split}/{deg}_degree/{rgb,seg}/r_#.png + transforms.json

Every (instance, articulation, view) is decoded once (by the native loader,
else PIL) into host arrays: the rgb with the seg mask's background set to
white (or black), the mask, the c2w. ``device_buffers`` stacks them for the
train step, which samples its batches on the device. Validation reads full views
(``get_image``); a dataset whose instances differ in articulation or view
count is sampled on the host (``sample_train``). The test sweep renders
``create_spheric_poses(radius=4)`` with the pose index as the interpolated
articulation id (``get_test_image``). All three carry the view as the auto-encoder's source image, ``src_imgs``: (3, h,
w) in [-1, 1] (``normalized_image``).
A held-out ``val/`` split of the midpoint degrees is used when every
instance has one.
"""

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np, get_rays_np
from aonerf_torch.native import decode_png_u8_native
from aonerf_torch.ops.rays import create_spheric_poses

NEAR, FAR = 2.0, 6.0

IDX_TO_DEG_TRAIN = {i: 10 * i for i in range(10)}
# the held-out validation articulations: the midpoints of the train degrees
IDX_TO_DEG_VAL = {i: 5 + 10 * i for i in range(9)}
DEFAULT_VAL_DEGREES = tuple(IDX_TO_DEG_VAL[i] for i in sorted(IDX_TO_DEG_VAL))


@dataclass
class _View:
    c2w: np.ndarray  # (3, 4)
    rgb: np.ndarray  # (h, w, 3) uint8, background-masked
    mask: np.ndarray  # (h, w) bool


def _decode_rgb(path: str, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8: the native decoder's, else PIL's, resized."""
    from PIL import Image  # only the loader needs PIL

    rgba = decode_png_u8_native(path, w, h)
    if rgba is not None:
        return rgba[..., :3]
    return np.asarray(Image.open(path).convert("RGB").resize((w, h), Image.LANCZOS))


def _decode_seg(path: str, w: int, h: int) -> np.ndarray:
    """(h, w) bool: the native decoder's RGBA with a colour channel above 0,
    else PIL's image, resized, with any channel above 0 (as JAX reads it)."""
    from PIL import Image

    rgba = decode_png_u8_native(path, w, h)
    if rgba is not None:
        return (rgba[..., :3] > 0).any(axis=-1)
    seg = np.asarray(Image.open(path).resize((w, h), Image.LANCZOS)) > 0
    return seg.any(axis=-1) if seg.ndim == 3 else seg


class SapienMultiDataset:
    """Every (instance, articulation, view) of one split in host memory."""

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (320, 240),
        white_back: bool = True,
        eval_inference: Optional[str] = None,
        ray_batch_size: int = 4096,
    ):
        """``split`` 'val' reads the held-out val/ dirs where every instance
        has them, else the train dirs; any other split reads the train dirs.
        ``eval_inference`` (the render directory's name) sets up the
        spheric test poses; ``ray_batch_size`` is ``sample_train``'s pixel
        count."""
        self.root_dir = root_dir
        self.ray_batch_size = ray_batch_size
        self.split = split
        self.img_wh = img_wh
        self.white_back = white_back
        self.near, self.far = NEAR, FAR
        self.instance_ids = sorted(f.name for f in os.scandir(root_dir) if f.is_dir())
        self.uses_val_split = split == "val" and self.has_val_split(root_dir)
        self._subdir = "val" if self.uses_val_split else "train"
        if eval_inference is not None:
            self.poses_test = create_spheric_poses(radius=4.0)
        self._views: Dict[Tuple[int, int], List[_View]] = {}
        self._deg_names: Dict[int, List[str]] = {}
        self.focal: Optional[float] = None
        self._load_all()
        w, h = img_wh
        self.directions = get_ray_directions_np(h, w, self.focal)

    @staticmethod
    def has_val_split(root_dir: str) -> bool:
        """True when every instance dir holds a non-empty val/ subdir."""
        instances = [f.path for f in os.scandir(root_dir) if f.is_dir()]
        if not instances:
            return False
        return all(
            os.path.isdir(os.path.join(p, "val")) and any(os.scandir(os.path.join(p, "val"))) for p in instances
        )

    def _deg_dirs(self, instance: str) -> List[str]:
        base = os.path.join(self.root_dir, instance, self._subdir)
        names = [f.name for f in os.scandir(base) if f.is_dir()]
        order = np.argsort([int(n.split("_")[0]) for n in names])
        return [names[i] for i in order]

    def _load_all(self) -> None:
        w, h = self.img_wh
        bg = 255 if self.white_back else 0
        for ii, instance in enumerate(self.instance_ids):
            deg_names = self._deg_dirs(instance)
            self._deg_names[ii] = deg_names
            for di, deg_name in enumerate(deg_names):
                base = os.path.join(self.root_dir, instance, self._subdir, deg_name)
                with open(os.path.join(base, "transforms.json")) as f:
                    meta = json.load(f)
                if self.focal is None:
                    self.focal = focal_from_meta(meta, self.img_wh)
                files = os.listdir(os.path.join(base, "rgb"))
                order = np.argsort([int(f.split("_")[1].split(".")[0]) for f in files])
                views = []
                for fname in (files[i] for i in order):
                    img = _decode_rgb(os.path.join(base, "rgb", fname), w, h)
                    seg = _decode_seg(os.path.join(base, "seg", fname), w, h)
                    rgb = np.full((h, w, 3), bg, dtype=np.uint8)
                    rgb[seg] = img[seg]
                    c2w = np.asarray(meta["frames"][fname.split(".")[0]], dtype=np.float32)[:3, :4]
                    views.append(_View(c2w=c2w, rgb=rgb, mask=seg))
                self._views[(ii, di)] = views

    @property
    def n_instances(self) -> int:
        return len(self.instance_ids)

    def n_articulations(self, instance_idx: int = 0) -> int:
        return len(self._deg_names[instance_idx])

    def n_images(self, instance_idx: int = 0, deg_idx: int = 0) -> int:
        return len(self._views[(instance_idx, deg_idx)])

    def degrees_rad(self, instance_idx: int = 0) -> np.ndarray:
        """Articulation angles (radians, float32) in directory order."""
        return np.asarray([np.deg2rad(int(n.split("_")[0])) for n in self._deg_names[instance_idx]], np.float32)

    @staticmethod
    def normalized_image(view: _View) -> np.ndarray:
        """(3, h, w) float32 image in [-1, 1] for the image encoder."""
        img = view.rgb.astype(np.float32) / 255.0
        return np.moveaxis((img - 0.5) / 0.5, -1, 0)

    def sample_train(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One host batch: ``ray_batch_size`` random pixels of a random
        (instance, articulation, view), drawn from ``rng`` in JAX's order
        (instance, articulation, view, pixels), with the view as
        ``src_imgs``. The instances may differ in articulation and view
        count."""
        ii = int(rng.integers(self.n_instances))
        di = int(rng.integers(self.n_articulations(ii)))
        vi = int(rng.integers(self.n_images(ii, di)))
        view = self._views[(ii, di)][vi]
        w, h = self.img_wh
        rays_o, viewdirs, rays_d, _ = get_rays_np(self.directions, view.c2w)
        pix = rng.integers(0, h * w, size=self.ray_batch_size)
        deg = float(np.deg2rad(int(self._deg_names[ii][di].split("_")[0])))
        return {
            "rays_o": rays_o[pix],
            "rays_d": rays_d[pix],
            "viewdirs": viewdirs[pix],
            "target": view.rgb.reshape(-1, 3).astype(np.float32)[pix] / 255.0,
            "instance_mask": view.mask.reshape(-1)[pix],
            "src_imgs": self.normalized_image(view),
            "deg": np.float32(deg),
            "instance_id": np.int32(ii),
            "articulation_id": np.int32(di),
        }

    def get_image(self, instance_idx: int, deg_idx: int, image_idx: int) -> Dict[str, np.ndarray]:
        """A full view's rays and targets, for validation."""
        view = self._views[(instance_idx, deg_idx)][image_idx]
        rays_o, viewdirs, rays_d, radii = get_rays_np(self.directions, view.c2w)
        deg = float(np.deg2rad(int(self._deg_names[instance_idx][deg_idx].split("_")[0])))
        return {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "viewdirs": viewdirs,
            "radii": radii,
            "target": view.rgb.reshape(-1, 3).astype(np.float32) / 255.0,
            "instance_mask": view.mask.reshape(-1),
            "src_imgs": self.normalized_image(view),
            "deg": np.float32(deg),
            "instance_id": np.int32(instance_idx),
            "articulation_id": np.int32(deg_idx),
        }

    def device_buffers(self) -> Dict[str, np.ndarray]:
        """The whole split stacked for upload: rgb (n_i, n_d, n_v, h*w, 3)
        uint8, mask (n_i, n_d, n_v, h*w) uint8 0/1, c2w (n_i, n_d, n_v, 3, 4),
        deg (n_d,) radians, directions (h*w, 3) camera frame. Needs the same
        articulation and view counts for every instance."""
        n_i, n_d, n_v = self.n_instances, self.n_articulations(0), self.n_images(0, 0)
        w, h = self.img_wh
        rgb = np.zeros((n_i, n_d, n_v, h * w, 3), np.uint8)
        mask = np.zeros((n_i, n_d, n_v, h * w), np.uint8)
        c2w = np.zeros((n_i, n_d, n_v, 3, 4), np.float32)
        for ii in range(n_i):
            if self.n_articulations(ii) != n_d:
                raise ValueError("device_buffers requires uniform articulation count")
            for di in range(n_d):
                views = self._views[(ii, di)]
                if len(views) != n_v:
                    raise ValueError("device_buffers requires uniform image count")
                for vi, view in enumerate(views):
                    rgb[ii, di, vi] = view.rgb.reshape(-1, 3)
                    mask[ii, di, vi] = view.mask.reshape(-1).astype(np.uint8)
                    c2w[ii, di, vi] = view.c2w
        return {
            "rgb": rgb,
            "mask": mask,
            "c2w": c2w,
            "deg": self.degrees_rad(0),
            "directions": self.directions.reshape(-1, 3).astype(np.float32),
        }

    def get_test_image(self, instance_idx: int, pose_idx: int) -> Dict[str, np.ndarray]:
        """Spheric test pose ``pose_idx``, whose index is also the
        interpolated articulation id; the target is the 0-degree view
        ``pose_idx % n_images``, as in the reference."""
        view = self._views[(instance_idx, 0)][pose_idx % self.n_images(instance_idx, 0)]
        rays_o, viewdirs, rays_d, radii = get_rays_np(self.directions, self.poses_test[pose_idx][:3, :4])
        return {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "viewdirs": viewdirs,
            "radii": radii,
            "target": view.rgb.reshape(-1, 3).astype(np.float32) / 255.0,
            "instance_mask": view.mask.reshape(-1),
            "src_imgs": self.normalized_image(view),
            "instance_id": np.int32(instance_idx),
            "articulation_id": np.int32(pose_idx),
        }
