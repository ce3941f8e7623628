"""Tiled full-image rendering (counterpart of ``aonerf.eval.render``).

Rays are padded to a whole number of ``chunk``-ray tiles by repeating the
last ray, each tile goes through the model, and the fine level is cropped
back to the image's rays. Single device; the sharded branch of the JAX
renderer is not ported yet.
"""

from typing import Callable, Dict, Tuple

import torch

_RAY_KEYS = ("rays_o", "rays_d", "viewdirs")


def make_image_renderer(
    model, white_bkgd: bool, near: float, far: float, chunk: int = 4096
) -> Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns fn(rays) -> (rgb (N,3), acc (N,), depth (N,)) of the fine
    level, where rays holds (N, 3) 'rays_o'/'rays_d'/'viewdirs' on the
    model's device."""

    @torch.no_grad()
    def render(rays: Dict[str, torch.Tensor]):
        n = rays["rays_o"].shape[0]
        n_pad = (-n) % chunk
        padded = {}
        for k in _RAY_KEYS:
            v = rays[k]
            if n_pad:
                v = torch.cat([v, v[-1:].expand(n_pad, v.shape[-1])], dim=0)
            padded[k] = v
        outs = []
        for i in range(0, n + n_pad, chunk):
            tile = {k: v[i : i + chunk] for k, v in padded.items()}
            outs.append(model(tile, False, white_bkgd, near, far)[-1])
        rgb, acc, depth = (torch.cat(parts, dim=0)[:n] for parts in zip(*outs))
        return rgb, acc, depth

    return render
