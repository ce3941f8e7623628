"""Single-scene SAPIEN layout (counterpart of ``aonerf.data.sapien``).

  {root}/{split}/rgb/r_#.png + {root}/{split}/transforms.json
  (4x4 c2w per frame; 'focal' or 'camera_angle_x'), near/far = 2/6,
  RGBA composited on white.

train: every ray of every image in flat (N, 3) host buffers, which the
trainer uploads once and gathers batches from on the device. val/test:
per-image rays and targets. The train buffers are built by the native
loader (``aonerf_torch.native``: PNG decode and world rays in C++ on a
thread pool) and through PIL when ``AONERF_NO_NATIVE`` is set or an image
needs resizing; val/test views are decoded with PIL.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np, get_rays_np
from aonerf_torch.native import load_scene_native

__all__ = ["NEAR", "FAR", "ImageSample", "SapienDataset", "focal_from_meta"]

NEAR, FAR = 2.0, 6.0


def _sorted_image_files(rgb_dir: str) -> List[str]:
    files = os.listdir(rgb_dir)
    order = np.argsort([int(f.split("_")[1].split(".")[0]) for f in files])
    return [files[i] for i in order]


def _load_rgba(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    from PIL import Image  # only the file loader needs PIL

    img = Image.open(path)
    img = img.resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.ones_like(arr)], axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    return arr  # (h, w, 4)


@dataclass
class ImageSample:
    """One full eval image's rays and targets (H*W rows)."""

    rays_o: np.ndarray
    rays_d: np.ndarray
    viewdirs: np.ndarray
    radii: np.ndarray
    target: np.ndarray
    instance_mask: np.ndarray


class SapienDataset:
    """One scene's views as host numpy arrays: flat train buffers, or
    per-image val/test views."""

    def __init__(
        self,
        root_dir: str,
        split: str = "test",
        img_wh: Tuple[int, int] = (320, 240),
        white_back: bool = True,
    ):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}: expected 'train', 'val' or 'test'")
        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.white_back = white_back
        self.near, self.far = NEAR, FAR

        base = os.path.join(root_dir, split)
        with open(os.path.join(base, "transforms.json")) as f:
            self.meta = json.load(f)
        self.focal = focal_from_meta(self.meta, img_wh)
        w, h = img_wh
        self.directions = get_ray_directions_np(h, w, self.focal)
        self.img_files = _sorted_image_files(os.path.join(base, "rgb"))
        self._base = base
        if split == "train":
            self._build_train_buffers()

    def _frame_c2w(self, img_file: str) -> np.ndarray:
        return np.asarray(self.meta["frames"][img_file.split(".")[0]], dtype=np.float32)[:3, :4]

    def _build_train_buffers(self) -> None:
        # Preallocated flat (N_total, 3) buffers written in place: by the
        # native loader, else by a thread pool through PIL (which releases
        # the GIL while decoding). viewdirs aliases rays_d, as in the
        # reference.
        w, h = self.img_wh
        n_img, n_pix = len(self.img_files), h * w
        self.all_rays_o = np.empty((n_img * n_pix, 3), np.float32)
        self.all_rays_d = np.empty((n_img * n_pix, 3), np.float32)
        self.all_viewdirs = self.all_rays_d
        self.all_rgbs = np.empty((n_img * n_pix, 3), np.float32)

        c2ws = np.stack([self._frame_c2w(f) for f in self.img_files])
        if load_scene_native([os.path.join(self._base, "rgb", f) for f in self.img_files], c2ws,
                             self.directions, h, w, True, self.all_rays_o, self.all_rays_d, self.all_rgbs):
            return

        def load(i: int) -> None:
            img_file = self.img_files[i]
            rgba = _load_rgba(os.path.join(self._base, "rgb", img_file), self.img_wh)
            sl = slice(i * n_pix, (i + 1) * n_pix)
            rgb = self.all_rgbs[sl].reshape(h, w, 3)
            np.multiply(rgba[..., :3], rgba[..., 3:], out=rgb)
            rgb += 1.0
            rgb -= rgba[..., 3:]
            rays_o, viewdirs, _, _ = get_rays_np(self.directions, self._frame_c2w(img_file))
            self.all_rays_o[sl] = rays_o
            self.all_rays_d[sl] = viewdirs

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 2)) as ex:
            list(ex.map(load, range(n_img)))

    @property
    def num_rays(self) -> int:
        return len(self.all_rays_o)

    @property
    def num_images(self) -> int:
        return len(self.img_files)

    def train_buffers(self) -> Dict[str, np.ndarray]:
        """The whole scene's rays (rays_o, rays_d, viewdirs aliasing rays_d)
        and white-composited targets, for batch sampling on the device."""
        return {
            "rays_o": self.all_rays_o,
            "rays_d": self.all_rays_d,
            "viewdirs": self.all_viewdirs,
            "target": self.all_rgbs,
        }

    def get_image(self, idx: int) -> ImageSample:
        """Per-image rays and targets for validation or test rendering."""
        img_file = self.img_files[idx]
        c2w = self._frame_c2w(img_file)
        rgba = _load_rgba(os.path.join(self._base, "rgb", img_file), self.img_wh)
        instance_mask = (rgba[..., 3] > 0).reshape(-1)
        rgb = (rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])).reshape(-1, 3)
        rays_o, viewdirs, rays_d, radii = get_rays_np(self.directions, c2w)
        return ImageSample(
            rays_o=rays_o,
            rays_d=rays_d,
            viewdirs=viewdirs,
            radii=radii,
            target=rgb.astype(np.float32),
            instance_mask=instance_mask,
        )
