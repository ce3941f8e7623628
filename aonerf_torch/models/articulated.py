"""Articulated NeRF: a latent-conditioned field warped by a deformation MLP
(counterpart of ``aonerf.models.articulated``).

Per sample point:
  1. deformation MLP (4x128): [xyz | shape code | articulation code] -> dxyz;
     the canonical point is xyz + dxyz
  2. the warped point, position-encoded (``enc_after``), with the shape code
     into the 8x256 trunk, whose input is concatenated again after pts_4
  3. view branch (4x128): [bottleneck | viewdir enc | appearance code] -> rgb
  4. sigma = softplus(raw + density_bias), rgb = sigmoid(raw) stretched by
     rgb_padding
over the vanilla NeRF's two-level hierarchy. No TPU kernel computes this
field; its products are ``torch.nn.functional.linear``, in fp32 or, with
``compute_dtype=torch.bfloat16``, as flax's bf16 ``Dense`` computes them
(``models.mlp.linear``; ``models.bf16_form`` spells the whole form out): each
product rounded to bf16 and its bias added with a second rounding, the
latents' products rounded and added in order, the elementwise operations and
the position encoding in bf16, the raw outputs cast to fp32. Parameters stay
fp32.

Each layer is one ``nn.Linear`` whose weight (out, in) holds the flax
kernel's rows in their order, latent by latent: ``deform_0`` = [pos 3 |
shape 128 | articulation 32], ``pts_0`` = [enc 63 | shape 128], ``pts_5`` =
[x 256 | enc 63 | shape 128], ``views_0`` = [bottleneck 256 | viewdir enc 27
| appearance 128]. ``utils.bridge`` carries the weights by a transpose. Two
schedules compute the same function from the same parameters: the concat
path builds each layer's whole input; ``latent_dense`` contracts a latent's
columns once on its (V, C) rows and broadcast-adds the (V, out) result.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aonerf_torch import DeviceLike, default_device, full_fp32
from aonerf_torch.models.mlp import COMPUTE_DTYPES, linear, round_exact
from aonerf_torch.ops import sampling
from aonerf_torch.ops.encoding import pos_enc, pos_enc_dim
from aonerf_torch.ops.render import volumetric_rendering

Latents = Dict[str, torch.Tensor]


def broadcast_latent(latent: torch.Tensor, n_rows: int) -> torch.Tensor:
    """A (C,), (1, C) or (B, C) latent to (n_rows, C): a single code on every
    row, or each of B codes on its n_rows // B consecutive rows."""
    latent = torch.atleast_2d(latent)
    b, c = latent.shape
    if b == 1:
        return latent.expand(n_rows, c)
    if n_rows % b:
        raise ValueError(f"latent batch {b} does not divide rows {n_rows}")
    return latent.repeat_interleave(n_rows // b, dim=0)


def latent_linear(
    layer: nn.Linear, x_var: torch.Tensor, latents: List[torch.Tensor], n_rows: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``layer`` over [x_var | broadcast(latent) ...] without building the
    broadcasts: x_var @ W[:, :v]^T + b, plus each latent's columns contracted
    on its own rows and broadcast. In bf16 each product is rounded, the bias
    added after x_var's, and every add rounded, in that order. A latent's
    product (its few rows) is summed exactly (fp64) and rounded once: every
    row of its view takes it, so one of its entries rounded to the other
    neighbour by a summation order (an fp32 sum within its error of a tie)
    would move a whole view's rows."""
    w = layer.weight
    off = x_var.shape[-1]
    if compute_dtype == torch.float32:
        y = F.linear(x_var, w[:, :off], layer.bias)
    else:
        w = w.to(compute_dtype)
        y = F.linear(x_var, w[:, :off]) + layer.bias.to(compute_dtype)
    for lat in latents:
        lat = torch.atleast_2d(lat)
        d = lat.shape[-1]
        if compute_dtype == torch.float32:
            p = F.linear(lat.to(w.dtype), w[:, off : off + d])
        else:
            p = round_exact(F.linear(lat.to(compute_dtype).double(), w[:, off : off + d].double()), compute_dtype)
        y = y + broadcast_latent(p, n_rows)
        off += d
    if off != w.shape[1]:
        raise ValueError(f"inputs of width {off} for a layer of {w.shape[1]}")
    return y


def _check_compute(compute_dtype, fused_head: bool = False) -> None:
    todo = []
    if compute_dtype not in COMPUTE_DTYPES.values():
        todo.append(f"compute_dtype={compute_dtype} (fp32 and bf16 run)")
    if fused_head:
        todo.append("fused_head (mlp.fused_density_bottleneck)")
    if todo:
        raise NotImplementedError("not ported yet: " + ", ".join(todo))


class ArticulatedNeRFMLP(nn.Module):
    def __init__(
        self,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        netdepth: int = 8,
        netwidth: int = 256,
        netdepth_deformation: int = 4,
        netwidth_deformation: int = 128,
        netdepth_condition: int = 4,
        netwidth_condition: int = 128,
        shape_latent_dim: int = 128,
        appearance_latent_dim: int = 128,
        articulation_latent_dim: int = 32,
        skip_layer: int = 4,
        input_ch: int = 3,
        input_ch_view: int = 3,
        num_rgb_channels: int = 3,
        num_density_channels: int = 1,
        deformation_mlp: bool = True,
        enc_after: bool = True,
        embed_deg: bool = False,
        density_bias_init: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
        fused_head: bool = False,
        latent_dense: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Xavier-uniform kernels and zero biases (the density head's bias
        ``density_bias_init``), drawn on the CPU from ``generator`` and then
        moved to ``device``."""
        super().__init__()
        _check_compute(compute_dtype, fused_head)
        if latent_dense and (netdepth - 1) % skip_layer == 0 and netdepth > 1:
            raise ValueError(
                "latent_dense does not support a skip concat after the final trunk layer "
                "(netdepth-1 divisible by skip_layer); use latent_dense=False for this depth"
            )
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        self.netdepth, self.netdepth_deformation, self.netdepth_condition = (
            netdepth, netdepth_deformation, netdepth_condition,
        )
        self.skip_layer = skip_layer
        self.num_rgb_channels, self.num_density_channels = num_rgb_channels, num_density_channels
        self.deformation_mlp, self.enc_after, self.embed_deg = deformation_mlp, enc_after, embed_deg
        self.latent_dense, self.compute_dtype = latent_dense, compute_dtype

        enc = pos_enc_dim(input_ch, min_deg_point, max_deg_point)
        feat = input_ch if enc_after else enc  # width of the samples passed in
        lat = shape_latent_dim + articulation_latent_dim

        def linear(fan_in, fan_out):  # no draw from the global generator
            return nn.Linear(fan_in, fan_out, device="meta")

        if deformation_mlp:
            wd = netwidth_deformation
            self.deform_0 = linear(feat + lat, wd)
            for i in range(1, netdepth_deformation):
                setattr(self, f"deform_{i}", linear(wd, wd))
            self.deform_out = linear(wd, input_ch if enc_after else feat)
            trunk_in = (enc if enc_after else feat) + shape_latent_dim
        else:
            trunk_in = feat + lat
        for i in range(netdepth):
            skip = i > 1 and (i - 1) % skip_layer == 0
            fan_in = trunk_in if i == 0 else netwidth + (trunk_in if skip else 0)
            setattr(self, f"pts_{i}", linear(fan_in, netwidth))
        last_skip = netdepth > 1 and (netdepth - 1) % skip_layer == 0
        head_in = netwidth + (trunk_in if last_skip else 0)
        self.density = linear(head_in, num_density_channels)
        self.bottleneck = linear(head_in, netwidth)
        view = pos_enc_dim(input_ch_view, 0, deg_view)
        self.views_0 = linear(netwidth + view + appearance_latent_dim, netwidth_condition)
        for i in range(1, netdepth_condition):
            setattr(self, f"views_{i}", linear(netwidth_condition, netwidth_condition))
        self.rgb = linear(netwidth_condition, num_rgb_channels)
        self.to_empty(device="cpu")
        with torch.no_grad():
            for layer in self.children():
                nn.init.xavier_uniform_(layer.weight, generator=generator)
                nn.init.zeros_(layer.bias)
            self.density.bias.fill_(density_bias_init)
        self.to(default_device(device))

    def _layer(self, name: str, idx: int) -> nn.Linear:
        return getattr(self, f"{name}_{idx}")

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(layer, x, self.compute_dtype)

    def _latent_dense(self, layer: nn.Linear, x_var: torch.Tensor, latents, n_rows: int) -> torch.Tensor:
        return latent_linear(layer, x_var, latents, n_rows, self.compute_dtype)

    def forward(
        self, pos: torch.Tensor, condition: torch.Tensor, latents: Latents
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pos (B, S, 3) raw points with ``enc_after``, else (B, S, enc)
        encoded points; condition (B, view enc) encoded view directions;
        latents 'density', 'color' and 'articulation' (or, with
        ``embed_deg``, 'articulation_deg'), each (C,), (1, C) or (V, C).

        Returns (raw_rgb (B, S, 3), raw_density (B, S, 1)).
        """
        with full_fp32():  # a caller that differentiates holds it around the backward too
            return self._forward(pos, condition, latents)

    def _forward(self, pos: torch.Tensor, condition: torch.Tensor, latents: Latents):
        shape_code, appearance_code = latents["density"], latents["color"]
        articulation_code = latents["articulation_deg" if self.embed_deg else "articulation"]
        num_rays, num_samples, feat_dim = pos.shape
        n_rows = num_rays * num_samples
        dtype = self.compute_dtype
        bf16 = dtype != torch.float32
        if bf16:  # the fp32 path keeps its inputs' dtype (fp64 in an oracle)
            pos, condition = pos.to(dtype), condition.to(dtype)
        pos = pos.reshape(n_rows, feat_dim)

        if self.latent_dense:
            trunk_latents = [shape_code]
            if self.deformation_mlp:
                x = torch.relu(self._latent_dense(self.deform_0, pos, [shape_code, articulation_code], n_rows))
                for idx in range(1, self.netdepth_deformation):
                    x = torch.relu(self._dense(self._layer("deform", idx), x))
                x = self._dense(self.deform_out, x) + pos
                if self.enc_after:
                    x = pos_enc(x, self.min_deg_point, self.max_deg_point)
                var_inputs = x  # the row-varying part of the trunk input
            else:
                var_inputs = pos
                trunk_latents = [shape_code, articulation_code]
            x = None
            for idx in range(self.netdepth):
                layer = self._layer("pts", idx)
                if idx == 0:
                    h = self._latent_dense(layer, var_inputs, trunk_latents, n_rows)
                elif (idx - 1) % self.skip_layer == 0 and idx - 1 > 0:
                    # the concat path appended its inputs after layer idx-1
                    h = self._latent_dense(layer, torch.cat([x, var_inputs], dim=-1), trunk_latents, n_rows)
                else:
                    h = self._dense(layer, x)
                x = torch.relu(h)
        else:
            shape_b = broadcast_latent(shape_code, n_rows)
            articulation_b = broadcast_latent(articulation_code, n_rows)
            if bf16:
                shape_b, articulation_b = shape_b.to(dtype), articulation_b.to(dtype)
            x = torch.cat([pos, shape_b, articulation_b], dim=-1)
            if self.deformation_mlp:
                for idx in range(self.netdepth_deformation):
                    x = torch.relu(self._dense(self._layer("deform", idx), x))
                x = self._dense(self.deform_out, x) + pos
                if self.enc_after:
                    x = pos_enc(x, self.min_deg_point, self.max_deg_point)
                x = torch.cat([x, shape_b], dim=-1)
            inputs = x
            for idx in range(self.netdepth):
                x = torch.relu(self._dense(self._layer("pts", idx), x))
                if idx % self.skip_layer == 0 and idx > 0:
                    x = torch.cat([x, inputs], dim=-1)

        raw_density = self._dense(self.density, x).reshape(num_rays, num_samples, self.num_density_channels)
        bottleneck = self._dense(self.bottleneck, x)
        if self.latent_dense:
            # the per-ray view condition and the per-view appearance code both
            # broadcast: their columns are contracted on (B, 27) and (V, 128)
            x = torch.relu(self._latent_dense(self.views_0, bottleneck, [condition, appearance_code], n_rows))
            for idx in range(1, self.netdepth_condition):
                x = torch.relu(self._dense(self._layer("views", idx), x))
        else:
            cond = condition[:, None, :].expand(num_rays, num_samples, condition.shape[-1]).reshape(n_rows, -1)
            appearance_b = broadcast_latent(appearance_code, n_rows)
            x = torch.cat([bottleneck, cond, appearance_b.to(dtype) if bf16 else appearance_b], dim=-1)
            for idx in range(self.netdepth_condition):
                x = torch.relu(self._dense(self._layer("views", idx), x))
        raw_rgb = self._dense(self.rgb, x).reshape(num_rays, num_samples, self.num_rgb_channels)
        if bf16:
            raw_rgb, raw_density = raw_rgb.to(torch.float32), raw_density.to(torch.float32)
        return raw_rgb, raw_density


class ArticulatedNeRF(nn.Module):
    """The two-level articulated field. Its MLPs always take their default
    widths (8x256 trunk, 4x128 deformation and view branches), as in JAX."""

    num_levels = 2

    def __init__(
        self,
        num_coarse_samples: int = 64,
        num_fine_samples: int = 128,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        noise_std: float = 0.0,
        lindisp: bool = False,
        rgb_padding: float = 0.001,
        density_bias: float = -1.0,
        sigma_activation: str = "softplus",
        sigma_cap: Optional[float] = None,
        tail_to_background: bool = False,
        enc_after: bool = True,
        embed_deg: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        latent_dense: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """``sigma_activation`` 'softplus' (the auto-decoder's: softplus of
        raw + density_bias) or 'relu' (raw sigma, density head bias 0.3);
        ``sigma_cap`` soft-caps sigma at cap * tanh(sigma / cap);
        ``tail_to_background`` moves the last sample's weight from its color
        to the background's and out of acc."""
        super().__init__()
        _check_compute(compute_dtype)
        if sigma_activation not in ("softplus", "relu"):
            raise ValueError(f"sigma_activation {sigma_activation!r}: expected 'softplus' or 'relu'")
        device = default_device(device)
        self.num_coarse_samples, self.num_fine_samples = num_coarse_samples, num_fine_samples
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        self.lindisp, self.rgb_padding, self.density_bias = lindisp, rgb_padding, density_bias
        self.noise_std = noise_std
        self.sigma_activation, self.sigma_cap = sigma_activation, sigma_cap
        self.tail_to_background, self.enc_after = tail_to_background, enc_after
        self.compute_dtype = compute_dtype
        mlp_kwargs = dict(
            min_deg_point=min_deg_point, max_deg_point=max_deg_point, deg_view=deg_view, enc_after=enc_after,
            embed_deg=embed_deg, density_bias_init=0.3 if sigma_activation == "relu" else 0.0,
            compute_dtype=compute_dtype, latent_dense=latent_dense, generator=generator, device=device,
        )
        self.coarse_mlp = ArticulatedNeRFMLP(**mlp_kwargs)
        self.fine_mlp = ArticulatedNeRFMLP(**mlp_kwargs)

    def sigma_from_raw(self, raw_sigma: torch.Tensor) -> torch.Tensor:
        """The field's density from its MLP's raw density: softplus of raw +
        ``density_bias`` or ReLU, then soft-capped at ``sigma_cap``."""
        if self.sigma_activation == "softplus":
            sigma = F.softplus(raw_sigma + self.density_bias)
        else:
            sigma = torch.relu(raw_sigma)
        if self.sigma_cap is not None:
            sigma = self.sigma_cap * torch.tanh(sigma / self.sigma_cap)
        return sigma

    def forward(
        self,
        rays: Dict[str, torch.Tensor],
        randomized: bool,
        white_bkgd: bool,
        near: float,
        far: float,
        latents: Latents,
        draws=None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """rays: 'rays_o', 'rays_d', 'viewdirs' (B, 3); latents as
        ``ArticulatedNeRFMLP.forward`` takes them. ``draws``
        (``ops.random.Draws``) gives the coarse jitter and then the fine
        exponential draws when ``randomized``, and with ``noise_std`` > 0
        each level's sigma noise after its samples: ``uniform * noise_std``
        added to the (fp32) raw sigma before the activation, as JAX's field.

        Returns [(comp_rgb, acc, depth)] per level, coarse first.
        """
        if randomized and draws is None:
            raise ValueError("randomized rendering needs draws")
        o, d = rays["rays_o"], rays["rays_d"]
        viewdirs_enc = pos_enc(rays["viewdirs"], 0, self.deg_view)
        ret = []
        t_vals = weights = None
        for i_level, mlp in enumerate((self.coarse_mlp, self.fine_mlp)):
            if i_level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    o, d, self.num_coarse_samples, near, far, randomized, self.lindisp, draws=draws
                )
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                # the fine samples carry no gradient, so neither need the weights
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1].detach(), o, d, t_vals, self.num_fine_samples, randomized,
                    draws=draws,
                )
            if not self.enc_after:
                samples = pos_enc(samples, self.min_deg_point, self.max_deg_point)
            raw_rgb, raw_sigma = mlp(samples, viewdirs_enc, latents)
            if randomized and self.noise_std > 0:
                raw_sigma = raw_sigma + draws.noise(raw_sigma.shape) * self.noise_std

            rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
            sigma = self.sigma_from_raw(raw_sigma)

            comp_rgb, acc, weights, depth = volumetric_rendering(rgb, sigma, t_vals, d, white_bkgd=white_bkgd)
            if self.tail_to_background:
                w_last = weights[..., -1]
                bg = 1.0 if white_bkgd else 0.0
                comp_rgb = comp_rgb + w_last[..., None] * (bg - rgb[..., -1, :])
                acc = acc - w_last
            ret.append((comp_rgb, acc, depth))
        return ret
