"""flax's bf16 arithmetic for the articulated models, spelled out: the plain
form that the port's bf16 field, encoder and joint-state decoder are held to
(``tests/test_torch_bf16_articulated_rule.py`` states the rule, ``chip_smoke.py``
applies it on the card).

flax with ``dtype=bfloat16`` (``aonerf/models/{articulated,resnet,joint_state}.py``)
computes, as its HLO states it:

  Dense         input and kernel in bf16, the products summed in fp32 and the
                sum rounded to bf16; the bias rounded to bf16 and added, the
                sum rounded again
  latent Dense  (``_latent_dense``) the row-varying part as a Dense; then, for
                each latent, its bf16 product with its kernel rows, rounded,
                broadcast and added, each add rounded
  elementwise   ReLU, concatenation, the warped point ``deform_out(x) + pos``
                (``pos`` rounded to bf16 on entry) and ``pos_enc`` (scales in
                bf16, ``+ pi/2`` with pi/2 rounded to bf16, sin rounded) in bf16
  raw outputs   cast to fp32; sigmoid, softplus, the sigma cap, the
                integrator and the losses in fp32
  encoder       convolutions in bf16 (one rounding, no bias); instance-norm
                statistics in fp32, the result in bf16; the global pool and
                the ``_fc`` heads in fp32
  joint state   three Dense in bf16, the output cast to fp32

``Form(sums, rounding)`` evaluates that function from a port module's fp32
weights:

  sums      'fp64': each product summed in fp64 (the reference); 'fp32': in
            fp32 by ``torch.matmul`` / ``conv2d``; 'fp32_reversed': in fp32
            over the contraction reversed
  rounding  'flax': flax's rounding points, above; 'none': no rounding, the
            model in the working dtype of ``sums`` (fp64 with 'fp64': the fp64
            evaluation; fp32 otherwise: the fp32 module); 'operands': every
            product's operands rounded to bf16, its output and every other
            operation in fp32 (the vanilla kernels' ``dot_bf16``);
            'bias_first': as 'flax' but the bias added to the fp32 sum before
            its one rounding (``F.linear`` / ``addmm`` with a bf16 bias)

The last three are the controls the rule turns away. Activations travel as
tensors of the working dtype (bf16 under 'flax' and 'bias_first'); a product
is summed as ``sums`` says and rounded from there directly.
"""

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from aonerf_torch.ops import sampling
from aonerf_torch.ops.render import volumetric_rendering

SUMS = ("fp64", "fp32", "fp32_reversed")
ROUNDINGS = ("flax", "none", "operands", "bias_first")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp64 values rounded to the nearest bf16 value, ties to even, in one
    step (no intermediate fp32), as fp64."""
    m, e = torch.frexp(x.double())
    return torch.ldexp(torch.round(m * 256.0), (e - 8).double())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (2^-7 of its binade), as fp64."""
    _, e = torch.frexp(x.double().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), (e - 8).double())


class Form:
    def __init__(self, sums: str = "fp64", rounding: str = "flax"):
        if sums not in SUMS or rounding not in ROUNDINGS:
            raise ValueError(f"Form({sums!r}, {rounding!r})")
        self.sums, self.rounding = sums, rounding
        bf16 = rounding in ("flax", "bias_first")
        self.act = torch.bfloat16 if bf16 else (torch.float64 if rounding == "none" and sums == "fp64"
                                                else torch.float32)
        self.out = torch.float64 if self.act == torch.float64 else torch.float32
        # (layer name, or the conv module, input, output) of each product, when a list
        self.record: Optional[List] = None

    def __repr__(self) -> str:
        return f"Form({self.sums!r}, {self.rounding!r})"

    # ------------------------------------------------------------- products

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.rounding == "none":
            return x.to(self.act).double()
        return x.to(torch.bfloat16).double()

    def _sum(self, fn, a: torch.Tensor, b: torch.Tensor, reverse) -> torch.Tensor:
        """fn(a, b) in fp64 (exact for bf16 operands up to the fp64 sum) or in
        fp32, over the contraction as given or reversed (``reverse`` flips
        it on both operands)."""
        a, b = self._operand(a), self._operand(b)
        if self.sums == "fp64":
            return fn(a, b)
        if self.sums == "fp32_reversed":
            a, b = reverse(a, b)
        return fn(a.float(), b.float()).double()

    def _round(self, p: torch.Tensor) -> torch.Tensor:
        """A product's fp64 value in the working dtype, rounded once."""
        if self.act == torch.bfloat16:
            return round_bf16(p).to(torch.bfloat16)
        return p.to(self.act)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (N, K) @ w (K, M), rounded to the working dtype."""
        return self._round(self._sum(torch.matmul, x, w, lambda a, b: (a.flip(-1), b.flip(0))))

    def bias(self, b: torch.Tensor) -> torch.Tensor:
        return b.to(self.act)

    def dense(self, layer, x: torch.Tensor, name: str = "") -> torch.Tensor:
        """A port ``nn.Linear`` as flax's Dense(dtype) computes it."""
        w = layer.weight.t()
        if self.rounding == "bias_first":
            p = self._sum(torch.matmul, x, w, lambda a, b: (a.flip(-1), b.flip(0)))
            y = round_bf16(p + self.bias(layer.bias).double()).to(torch.bfloat16)
        else:
            y = self.matmul(x, w) + self.bias(layer.bias)
        if self.record is not None:
            self.record.append((name, x, y))
        return y

    def latent_dense(self, layer, x_var: torch.Tensor, latents, n_rows: int, name: str = "") -> torch.Tensor:
        """flax's ``_latent_dense``: the Dense of [x_var | broadcast(latent) ...]
        with each latent's product on its own rows, rounded, broadcast and
        added in order."""
        w = layer.weight.t()
        off = x_var.shape[-1]
        y = self.dense(_Slice(w[:off].t(), layer.bias), x_var)
        if self.record is not None:
            self.record.pop()
        for lat in latents:
            lat = torch.atleast_2d(lat).to(self.act)
            d = lat.shape[-1]
            y = y + broadcast(self.matmul(lat, w[off:off + d]), n_rows)
            off += d
        if self.record is not None:
            self.record.append((name, (x_var, [torch.atleast_2d(lat) for lat in latents]), y))
        return y

    def conv(self, conv, x: torch.Tensor) -> torch.Tensor:
        """A port ``nn.Conv2d`` (no bias) as flax's Conv(dtype): one rounding."""
        def fn(a, w):
            return F.conv2d(a, w, stride=conv.stride, padding=conv.padding)

        y = self._round(self._sum(fn, x, conv.weight, lambda a, w: (a.flip(1), w.flip(1))))
        if self.record is not None:
            self.record.append((conv, x, y))
        return y

    # ---------------------------------------------------- the articulated MLP

    def pos_enc(self, x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
        if max_deg == min_deg:
            return x
        scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype)
        xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
        half_pi = torch.tensor(0.5 * math.pi, dtype=x.dtype)
        return torch.cat([x, torch.sin(torch.cat([xb, xb + half_pi], dim=-1))], dim=-1)

    def mlp(self, m, pos: torch.Tensor, condition: torch.Tensor, latents: Dict[str, torch.Tensor]):
        """The port ``ArticulatedNeRFMLP`` ``m`` (its weights and settings)
        evaluated in this form, either schedule. Returns (raw_rgb, raw_density)
        in fp32 (fp64 for the fp64 evaluation)."""
        shape_code, appearance_code = latents["density"], latents["color"]
        art_code = latents["articulation_deg" if m.embed_deg else "articulation"]
        num_rays, num_samples, feat = pos.shape
        n = num_rays * num_samples
        pos = pos.reshape(n, feat).to(self.act)
        relu = torch.relu

        def layer(name):
            return getattr(m, name)

        if m.latent_dense:
            trunk_latents = [shape_code]
            if m.deformation_mlp:
                x = relu(self.latent_dense(m.deform_0, pos, [shape_code, art_code], n, "deform_0"))
                for i in range(1, m.netdepth_deformation):
                    x = relu(self.dense(layer(f"deform_{i}"), x, f"deform_{i}"))
                x = self.dense(m.deform_out, x, "deform_out") + pos
                if m.enc_after:
                    x = self.pos_enc(x, m.min_deg_point, m.max_deg_point)
                var = x
            else:
                var, trunk_latents = pos, [shape_code, art_code]
            for i in range(m.netdepth):
                name = f"pts_{i}"
                if i == 0:
                    h = self.latent_dense(layer(name), var, trunk_latents, n, name)
                elif (i - 1) % m.skip_layer == 0 and i - 1 > 0:
                    h = self.latent_dense(layer(name), torch.cat([x, var], dim=-1), trunk_latents, n, name)
                else:
                    h = self.dense(layer(name), x, name)
                x = relu(h)
        else:
            shape_b = broadcast(shape_code, n).to(self.act)
            x = torch.cat([pos, shape_b, broadcast(art_code, n).to(self.act)], dim=-1)
            if m.deformation_mlp:
                for i in range(m.netdepth_deformation):
                    x = relu(self.dense(layer(f"deform_{i}"), x, f"deform_{i}"))
                x = self.dense(m.deform_out, x, "deform_out") + pos
                if m.enc_after:
                    x = self.pos_enc(x, m.min_deg_point, m.max_deg_point)
                x = torch.cat([x, shape_b], dim=-1)
            inputs = x
            for i in range(m.netdepth):
                x = relu(self.dense(layer(f"pts_{i}"), x, f"pts_{i}"))
                if i % m.skip_layer == 0 and i > 0:
                    x = torch.cat([x, inputs], dim=-1)
        raw_density = self.dense(m.density, x, "density").reshape(num_rays, num_samples, -1)
        bottleneck = self.dense(m.bottleneck, x, "bottleneck")
        condition = condition.to(self.act)
        if m.latent_dense:
            x = relu(self.latent_dense(m.views_0, bottleneck, [condition, appearance_code], n, "views_0"))
            for i in range(1, m.netdepth_condition):
                x = relu(self.dense(layer(f"views_{i}"), x, f"views_{i}"))
        else:
            cond = condition[:, None, :].expand(num_rays, num_samples, -1).reshape(n, -1)
            x = torch.cat([bottleneck, cond, broadcast(appearance_code, n).to(self.act)], dim=-1)
            for i in range(m.netdepth_condition):
                x = relu(self.dense(layer(f"views_{i}"), x, f"views_{i}"))
        raw_rgb = self.dense(m.rgb, x, "rgb").reshape(num_rays, num_samples, -1)
        return raw_rgb.to(self.out), raw_density.to(self.out)

    def field(self, f, rays, white_bkgd: bool, near: float, far: float, latents, samples=None):
        """The port ``ArticulatedNeRF`` ``f``'s deterministic two-level render
        with its MLPs in this form: [(comp_rgb, acc, depth)] per level, the
        raw outputs [(raw_rgb, raw_density)] per level and the points they
        were taken at, [(B, S, 3)] per level. ``samples``, one (B, S, 3)
        tensor per level, gives the raw outputs at those points instead of
        at this form's own."""
        rays = {k: v.to(self.out) for k, v in rays.items()}
        o, d = rays["rays_o"], rays["rays_d"]
        venc = self.pos_enc(rays["viewdirs"], 0, f.deg_view) if self.out == torch.float64 else \
            _pos_enc32(rays["viewdirs"], f.deg_view)
        ret, raws, at = [], [], []
        t_vals = weights = None
        for i, mlp in enumerate((f.coarse_mlp, f.fine_mlp)):
            if i == 0:
                t_vals, pts = sampling.sample_along_rays(o, d, f.num_coarse_samples, near, far, False, f.lindisp)
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, pts = sampling.sample_pdf(t_mids, weights[..., 1:-1], o, d, t_vals, f.num_fine_samples,
                                                  False)
            raw_rgb, raw_sigma = self.mlp(mlp, pts, venc, latents)
            if samples is None:
                raws.append((raw_rgb, raw_sigma))
                at.append(pts)
            else:
                raws.append(self.mlp(mlp, samples[i], venc, latents))
                at.append(samples[i])
            rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * f.rgb_padding) - f.rgb_padding
            if f.sigma_activation == "softplus":
                sigma = F.softplus(raw_sigma + f.density_bias)
            else:
                sigma = torch.relu(raw_sigma)
            if f.sigma_cap is not None:
                sigma = f.sigma_cap * torch.tanh(sigma / f.sigma_cap)
            comp, acc, weights, depth = volumetric_rendering(rgb, sigma, t_vals, d, white_bkgd=white_bkgd)
            if f.tail_to_background:
                w_last = weights[..., -1]
                comp = comp + w_last[..., None] * ((1.0 if white_bkgd else 0.0) - rgb[..., -1, :])
                acc = acc - w_last
            ret.append((comp, acc, depth))
        return ret, raws, at

    # ------------------------------------------------- encoder and decoder

    def _norm(self, norm, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if norm.norm_type == "instance":
            var, mean = torch.var_mean(x32, dim=(2, 3), correction=0, keepdim=True)
            return ((x32 - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)
        return F.group_norm(x32, 1, norm.weight.to(x32.dtype), norm.bias.to(x32.dtype), eps=1e-6).to(x.dtype)

    def _block(self, blk, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self._norm(blk.norm0, self.conv(blk.conv1, x)))
        y = self._norm(blk.norm1, self.conv(blk.conv2, y))
        residual = x if blk.downsample is None else self._norm(blk.norm2, self.conv(blk.downsample, x))
        return torch.relu(y + residual)

    def encoder(self, enc, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The port ``MultiHeadImgEncoder`` ``enc`` on (B, 3, H, W) images:
        {head: (B, C)} in fp32 (fp64 for the fp64 evaluation)."""
        x = torch.relu(self._norm(enc.norm0, self.conv(enc.conv1, x.to(self.act))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)

        def stage(s, h):
            for i in range(s.blocks):
                h = self._block(getattr(s, f"block{i}"), h)
            return h

        for si in range(enc.shared_layers):
            x = stage(getattr(enc, f"layer{si + 1}"), x)
        out = {}
        for name in enc.heads:
            h = x
            for si in range(enc.shared_layers, 4):
                h = stage(getattr(enc, f"{name}_layer{si + 1}"), h)
            fc = getattr(enc, f"{name}_fc")
            pooled = h.to(self.out).mean(dim=(2, 3))
            out[name] = F.linear(pooled, fc.weight.to(self.out), fc.bias.to(self.out))
        return out

    def joint_state(self, dec, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.act)
        x = torch.relu(self.dense(dec.Dense_0, x, "Dense_0"))
        x = torch.relu(self.dense(dec.Dense_1, x, "Dense_1"))
        return self.dense(dec.Dense_2, x, "Dense_2").to(self.out)

    def autoencoder(self, ae, rays, src_imgs, deg, white_bkgd: bool, near: float, far: float):
        """The port ``AutoEncoderArticulatedNeRF``'s deterministic forward:
        (levels, codes, pred_state); the degree code is the fp32 (fp64)
        embedding row."""
        codes = self.encoder(ae.encoder, src_imgs)
        pred_state = self.joint_state(ae.joint_state_decoder, codes["articulation"])
        latents = dict(codes)
        if ae.embed_deg:
            latents["articulation_deg"] = ae.deg_code(deg).to(self.out)
        levels, _, _ = self.field(ae.field, rays, white_bkgd, near, far, latents)
        return levels, codes, pred_state


class _Slice:
    """A weight slice and bias with ``nn.Linear``'s attribute names."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        self.weight, self.bias = weight, bias


def broadcast(latent: torch.Tensor, n_rows: int) -> torch.Tensor:
    """A (C,), (1, C) or (V, C) latent on n_rows rows, each of V codes on its
    n_rows // V consecutive rows."""
    latent = torch.atleast_2d(latent)
    if latent.shape[0] == 1:
        return latent.expand(n_rows, -1)
    return latent.repeat_interleave(n_rows // latent.shape[0], dim=0)


def _pos_enc32(x: torch.Tensor, deg: int) -> torch.Tensor:
    """The view directions' encoding in fp32, as the field computes it."""
    return Form("fp32", "none").pos_enc(x.float(), 0, deg)


# ------------------------------------------------------------------ the rule

# Per layer (each product from the same input, no cascade): every output
# within LAYER_ULPS bf16 ulp of the reference (Form('fp64', 'flax')), the ulp
# taken at the largest of the layer's terms (a rounded product followed by a
# bias add that cancels it moves the output by the product's ulp), and the
# share of outputs that differ from the reference at most LAYER_SHARE_FACTOR
# x flax's own share on that layer, and never less than LAYER_SHARE_FLOOR
# outputs' worth.
LAYER_ULPS = 1.0
LAYER_SHARE_FACTOR = 4.0
LAYER_SHARE_FLOOR = 4


def term_scale(layer, x) -> torch.Tensor:
    """The sum of the magnitudes of every term of a recorded product's
    outputs (bf16 operands, the bias and, for a latent Dense, x of the form
    (x_var, latents), each latent's products): at least the magnitude of
    every partial sum flax rounds on the way."""
    def a(t):
        return round_bf16(t.double()).abs()

    if isinstance(layer, torch.nn.Conv2d):
        return F.conv2d(a(x), a(layer.weight), stride=layer.stride, padding=layer.padding)
    w = a(layer.weight.t())
    if isinstance(x, tuple):
        x_var, lats = x
        off = x_var.shape[-1]
        out = a(x_var) @ w[:off] + a(layer.bias)
        for lat in lats:
            out = out + broadcast(a(lat) @ w[off:off + lat.shape[-1]], out.shape[0])
            off += lat.shape[-1]
        return out
    return a(x) @ w + a(layer.bias)


def layer_errors(y: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor):
    """(largest error in bf16 ulps at ``scale``, share of outputs that
    differ from ``ref``)."""
    y, ref = y.double(), ref.double()
    ulp = bf16_ulp(torch.maximum(scale.double().abs(), ref.abs()))
    diff = (y - ref).abs()
    return (diff / ulp).max().item(), (diff > 0).double().mean().item()


def layer_limit(flax_share: float, n: int) -> float:
    return LAYER_SHARE_FACTOR * max(flax_share, LAYER_SHARE_FLOOR / n)


def layer_passes(errors, flax_share: float, n: int) -> bool:
    ulps, share = errors
    return ulps <= LAYER_ULPS and share <= layer_limit(flax_share, n)


# End to end: the share of rows (sample points, each level's raw rgb and
# density; codes and states entry by entry) whose largest difference from
# flax's raw output exceeds ROW_THRESHOLD x the largest |output| of that
# level, and the rms of comp_rgb (codes, states) against the fp64
# evaluation; each at most E2E_FACTOR x the farthest legitimate evaluation's,
# the share never less than E2E_SHARE_FLOOR rows' worth.
ROW_THRESHOLD = 3e-3
E2E_FACTOR = 2.0
E2E_SHARE_FLOOR = 2


def row_share(raw: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of rows of (..., C) outputs with max |raw - ref| beyond
    ROW_THRESHOLD x max |ref|."""
    raw, ref = raw.double().reshape(-1, raw.shape[-1]), ref.double().reshape(-1, ref.shape[-1])
    diff = (raw - ref).abs().amax(dim=-1)
    return (diff > ROW_THRESHOLD * ref.abs().max()).double().mean().item()


def e2e_limits(legit_shares, legit_rms, n_rows: int):
    """(share limit, rms limit) from the legitimate evaluations' values."""
    return (E2E_FACTOR * max(max(legit_shares), E2E_SHARE_FLOOR / n_rows), E2E_FACTOR * max(legit_rms))


def rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    return (x.double() - ref.double()).pow(2).mean().sqrt().item()
