"""Tiled full-image rendering (counterpart of ``aonerf.eval.render``).

Rays are padded to a whole number of ``chunk``-ray tiles by repeating the
last ray, each tile goes through the model, and the fine level is cropped
back to the image's rays. Latents given to a renderer (the articulated
field's (1, C) codes) go to the model with every tile. Single device; the
sharded branch of the JAX renderer is not ported yet.
"""

from typing import Callable, Dict, Tuple

import numpy as np
import torch

_RAY_KEYS = ("rays_o", "rays_d", "viewdirs")

Rendered = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _render_tiles(render_tile: Callable[[Dict[str, torch.Tensor]], Rendered], rays, chunk: int) -> Rendered:
    """(rgb (N,3), acc (N,), depth (N,)) of N rays rendered ``chunk`` at a
    time by ``render_tile``, the tail tile padded with the last ray."""
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
        outs.append(render_tile({k: v[i : i + chunk] for k, v in padded.items()}))
    rgb, acc, depth = (torch.cat(parts, dim=0)[:n] for parts in zip(*outs))
    return rgb, acc, depth


def make_chunk_renderer(model, white_bkgd: bool, near: float, far: float) -> Callable[..., Rendered]:
    """Deterministic fine-level renderer of one ray chunk: fn(rays[,
    latents]) -> (rgb, acc, depth), rays as in :func:`make_image_renderer`
    (for the vanilla field, any number: its kernels choose their ray tile)."""

    @torch.no_grad()
    def render_chunk(rays: Dict[str, torch.Tensor], *latents) -> Rendered:
        return model(rays, False, white_bkgd, near, far, *latents)[-1]

    return render_chunk


def render_rays_chunked(
    render_chunk: Callable[[Dict[str, torch.Tensor]], Rendered], rays: Dict[str, torch.Tensor], chunk: int = 4096
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render all rays in fixed-size chunks (padding the tail tile).

    rays: dict with (N, 3) 'rays_o'/'rays_d'/'viewdirs' on the model's
    device. Returns host numpy (rgb (N,3), acc (N,), depth (N,)).
    """
    rgb, acc, depth = _render_tiles(render_chunk, rays, chunk)
    return rgb.cpu().numpy(), acc.cpu().numpy(), depth.cpu().numpy()


def make_image_renderer(
    model, white_bkgd: bool, near: float, far: float, chunk: int = 4096
) -> Callable[..., Rendered]:
    """Returns fn(rays[, latents]) -> (rgb (N,3), acc (N,), depth (N,)) of
    the fine level, where rays holds (N, 3) 'rays_o'/'rays_d'/'viewdirs' on
    the model's device and latents the articulated field's codes. ``model``
    is a field or any callable with a field's signature: the auto-encoder
    passes its ``render`` (the field with the encoded latents), as JAX's
    renderer takes ``method=model.render``."""
    render_chunk = make_chunk_renderer(model, white_bkgd, near, far)

    def render(rays: Dict[str, torch.Tensor], *latents) -> Rendered:
        return _render_tiles(lambda tile: render_chunk(tile, *latents), rays, chunk)

    return render
