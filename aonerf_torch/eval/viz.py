"""Validation image grids: GT | prediction | depth | opacity (own copy of
``aonerf.eval.viz``).

Reference parity: utils/train_helper.py:138-159 (visualize_val_rgb_opa_depth)
and :311-332 (visualize_val_rgb_opacity) — a single grid image assembled from
the validation render for the experiment logger. cv2/torchvision are not in
this image, so the grid is plain numpy + a perceptual-ish depth colormap.
"""

from typing import Optional, Tuple

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img, np.float64), 0.0, 1.0) * 255.0).astype(np.uint8)


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 using a blue->green->red ramp
    (stand-in for the reference's cv2 JET colormap, train_helper.py:9-22)."""
    d = np.asarray(depth, np.float64)
    finite = np.isfinite(d)
    lo = d[finite].min() if finite.any() else 0.0
    hi = d[finite].max() if finite.any() else 1.0
    x = np.zeros_like(d) if hi == lo else np.clip((d - lo) / (hi - lo), 0, 1)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return _to_u8(np.stack([r, g, b], axis=-1))


def visualize_val_rgb_opa_depth(
    img_wh: Tuple[int, int],
    target: np.ndarray,
    rgb: np.ndarray,
    depth: Optional[np.ndarray] = None,
    acc: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Horizontal grid [GT | pred | depth | opacity] as (H, W*k, 3) uint8.

    Inputs are flat per-ray arrays of one image (H*W rows).
    """
    w, h = img_wh
    panels = [
        _to_u8(np.asarray(target).reshape(h, w, 3)),
        _to_u8(np.asarray(rgb).reshape(h, w, 3)),
    ]
    if depth is not None:
        panels.append(colorize_depth(np.asarray(depth).reshape(h, w)))
    if acc is not None:
        a = _to_u8(np.asarray(acc).reshape(h, w))
        panels.append(np.repeat(a[..., None], 3, axis=-1))
    return np.concatenate(panels, axis=1)
