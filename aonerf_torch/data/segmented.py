"""Segmentation-guided ray selection on the host, in numpy (counterpart of
``aonerf.data.segmented``).

The reference's get_rays_segmented (datasets/ray_utils.py:252-303): build a
class-id mask from per-class boolean masks, then draw N rays per class from
that class's pixels (with replacement). Returns per-class ray origins and
directions plus the foreground mask, vectorized (no per-class Python work
on the hot arrays).
"""

from typing import List, Sequence, Tuple

import numpy as np


def build_seg_mask(masks: np.ndarray, class_ids: Sequence[int]) -> np.ndarray:
    """(H, W, C) boolean stack + class ids -> (H, W) id map (0 = background).
    Later classes overwrite earlier ones on overlap (reference order)."""
    h, w, c = masks.shape
    seg = np.zeros((h, w), dtype=np.int64)
    for i in range(c):
        seg[masks[..., i] > 0] = class_ids[i]
    return seg


def get_rays_segmented(
    masks: np.ndarray,
    class_ids: Sequence[int],
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    w: int,
    h: int,
    n_rays: int,
    rng: np.random.Generator = None,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[int], np.ndarray]:
    """Per-class ray sampling. Returns (per-class origins, per-class dirs,
    sorted class ids, foreground mask (H*W,))."""
    if rng is None:
        rng = np.random.default_rng()
    seg = build_seg_mask(masks, list(class_ids)).reshape(-1)
    ids = sorted(class_ids)
    rays_o_per_class, rays_d_per_class = [], []
    for cid in ids:
        idx = np.flatnonzero(seg == cid)
        if len(idx) == 0:
            raise ValueError(f"class {cid} has no pixels")
        pick = idx[rng.integers(0, len(idx), size=n_rays)]
        # the reference gathers via a boolean mask (deduplicated, ordered);
        # we keep the sampled set itself, which preserves the sample count
        rays_o_per_class.append(rays_o[pick])
        rays_d_per_class.append(rays_d[pick])
    return rays_o_per_class, rays_d_per_class, ids, seg > 0
