"""Output writers of the test render: image sequences, depth and opacity
maps, the video, and the stats JSON (counterpart of ``aonerf.eval.io``).

Every writer takes host numpy arrays, one per view, and writes the same
files as the JAX package's. ``store_video`` needs imageio with an mp4
backend (ffmpeg or pyav) and raises ``RuntimeError`` without one; the
caller then writes ``store_gif``'s animated GIF, as the JAX Trainer does.
"""

import json
import os
from typing import Dict, Sequence

import numpy as np
from PIL import Image

from aonerf_torch.eval.viz import _to_u8, colorize_depth


def store_image(dirpath: str, rgbs: Sequence[np.ndarray], name: str = "image") -> None:
    """Write each (H, W, 3) float image as {name}{i:03d}.jpg."""
    os.makedirs(dirpath, exist_ok=True)
    for i, rgb in enumerate(rgbs):
        Image.fromarray(_to_u8(rgb)).save(os.path.join(dirpath, f"{name}{i:03d}.jpg"))


def store_depth_img(dirpath: str, depths: Sequence[np.ndarray], name: str = "depth") -> None:
    """Depth maps normalized to their finite range as grayscale PNGs, plus
    each raw map as {name}{i:03d}.npy."""
    os.makedirs(dirpath, exist_ok=True)
    for i, depth in enumerate(depths):
        d = np.asarray(depth, dtype=np.float64)
        finite = np.isfinite(d)
        lo = d[finite].min() if finite.any() else 0.0
        hi = d[finite].max() if finite.any() else 1.0
        norm = np.zeros_like(d) if hi == lo else np.clip((d - lo) / (hi - lo), 0, 1)
        Image.fromarray((norm * 255).astype(np.uint8)).save(os.path.join(dirpath, f"{name}{i:03d}.png"))
        np.save(os.path.join(dirpath, f"{name}{i:03d}.npy"), np.asarray(depth))


def store_depth_raw(dirpath: str, depths: Sequence[np.ndarray], name: str = "depth_raw") -> None:
    """Raw depth twice: millimetre uint16 PNGs, the dataset's own depth format
    (non-finite values store as 0; clipped at 65.535 m), and a lossless
    {name}.npz with one float array per view."""
    os.makedirs(dirpath, exist_ok=True)
    for i, depth in enumerate(depths):
        d = np.asarray(depth, dtype=np.float64)
        mm = np.where(np.isfinite(d), np.rint(d * 1000.0), 0.0)
        mm = np.clip(mm, 0, np.iinfo(np.uint16).max).astype(np.uint16)
        Image.fromarray(mm).save(os.path.join(dirpath, f"{name}{i:03d}.png"))
    np.savez_compressed(
        os.path.join(dirpath, f"{name}.npz"),
        **{f"{name}{i:03d}": np.asarray(d) for i, d in enumerate(depths)},
    )


def store_depth_color(dirpath: str, depths: Sequence[np.ndarray], name: str = "depth") -> None:
    """Colormapped depth PNGs (the val grids' colormap), plus each raw map as
    {name}{i:03d}.npy."""
    os.makedirs(dirpath, exist_ok=True)
    for i, depth in enumerate(depths):
        Image.fromarray(colorize_depth(np.asarray(depth))).save(os.path.join(dirpath, f"{name}{i:03d}.png"))
        np.save(os.path.join(dirpath, f"{name}{i:03d}.npy"), np.asarray(depth))


def store_opacity(dirpath: str, accs: Sequence[np.ndarray], name: str = "opacity") -> None:
    """Accumulated-opacity maps as grayscale PNGs."""
    os.makedirs(dirpath, exist_ok=True)
    for i, acc in enumerate(accs):
        a = np.clip(np.nan_to_num(np.asarray(acc, np.float64)), 0.0, 1.0)
        Image.fromarray((a * 255).astype(np.uint8)).save(os.path.join(dirpath, f"{name}{i:03d}.png"))


def store_video(dirpath: str, rgbs: Sequence[np.ndarray], name: str = "video") -> str:
    """mp4 of a rendered sequence at 20 fps; returns its path. Raises
    ``RuntimeError`` when imageio or its mp4 backend is missing."""
    try:
        import imageio

        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"{name}.mp4")
        imageio.mimwrite(path, [_to_u8(r) for r in rgbs], fps=20, quality=8)
        return path
    except (ImportError, ValueError, OSError) as e:  # no imageio, or no plugin that writes mp4
        raise RuntimeError(
            "store_video requires imageio with an mp4 backend (ffmpeg/pyav); "
            "use store_gif or the jpg sequence"
        ) from e


def store_gif(dirpath: str, rgbs: Sequence[np.ndarray], name: str = "video") -> str:
    """Animated GIF of a rendered sequence at 20 fps (PIL only); returns its
    path."""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"{name}.gif")
    frames = [Image.fromarray(_to_u8(r)) for r in rgbs]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=50, loop=0)
    return path


def write_stats(path: str, **metric_dicts: Dict[str, float]) -> None:
    """results.json: one entry per metric, each a {split: value} dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {name: {k: float(v) for k, v in d.items()} for name, d in metric_dicts.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
