"""Single-scene SAPIEN layout, eval side (counterpart of
``aonerf.data.sapien``).

  {root}/{split}/rgb/r_#.png + {root}/{split}/transforms.json
  (4x4 c2w per frame; 'focal' or 'camera_angle_x'), near/far = 2/6,
  RGBA composited on white.

Only per-image test/val views are loaded; the flat train buffers come with
the training path.
"""

import json
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from aonerf_torch.data.camera import focal_from_meta, get_ray_directions_np, get_rays_np

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
    """Per-image eval views of one scene, as host numpy arrays."""

    def __init__(
        self,
        root_dir: str,
        split: str = "test",
        img_wh: Tuple[int, int] = (320, 240),
        white_back: bool = True,
    ):
        if split not in ("val", "test"):
            raise NotImplementedError(f"split {split!r}: only 'val' and 'test' are ported")
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

    def _frame_c2w(self, img_file: str) -> np.ndarray:
        return np.asarray(self.meta["frames"][img_file.split(".")[0]], dtype=np.float32)[:3, :4]

    @property
    def num_images(self) -> int:
        return len(self.img_files)

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
