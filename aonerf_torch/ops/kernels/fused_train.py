"""The differentiable fused level: K1 forward, K2 weight-gradient backward
(counterpart of ``aonerf.ops.kernels.fused_train``).

``fused_level_bwd`` launches the CUDA kernels of ``csrc/fused_train.cu`` on
CUDA tensors and runs ``fused_level_bwd_ref``, the plain PyTorch version of
the same function, on CPU tensors. Anything else raises; a CUDA call never
falls back to the plain version.

Gradients flow to the 26 MLP weights only. Sample positions carry none in
this architecture (coarse t-values are parameter-free, fine t-values are
detached), so t, rays and encodings get no gradient. The integrator backward
is analytic:

  w_i = alpha_i T_i,   T_i = prod_{j<i} (1 - alpha_j + 1e-10)
  dL/dalpha_i = g_w_i T_i - sum_{j>i} g_w_j w_j / max(1 - alpha_i + 1e-10, 1e-10)
"""

import ctypes
from typing import Callable, Dict, List, Tuple

import torch

from aonerf_torch.ops import encoding, sampling
from aonerf_torch.ops.kernels import build
from aonerf_torch.ops.kernels.fused_render import (
    RAY_TILE,
    WEIGHT_NAMES,
    _check_inputs,
    fused_render_level,
    kernel_params,
)

# Launches of the CUDA backward since the count was last set to 0.
launches = 0


def _relu_mask(x: torch.Tensor) -> torch.Tensor:
    return (x > 0.0).to(x.dtype)


def fused_level_bwd_ref(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    g_comp: torch.Tensor,
    g_acc: torch.Tensor,
    g_depth: torch.Tensor,
    g_weights: torch.Tensor,
    white_bkgd: bool,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the level's weight gradient, written out as
    the TPU kernel's body is (``_bwd_kernel``). Same arguments and outputs as
    :func:`fused_level_bwd`, on any device.

    ``mm`` computes the MLP backward's products that the CUDA kernel runs on
    the tensor cores (every dW and every delta . W^T but the narrow heads');
    tests pass an emulation of the kernel's 3xTF32 arithmetic. The default is
    plain ``@``."""
    w = kernel_params
    R, S = t_vals.shape
    xe = samples_enc.reshape(R * S, -1)
    relu = torch.relu

    hs = [relu(xe @ w["w0"] + w["b0"])]
    for i in (1, 2, 3, 4):
        hs.append(relu(hs[-1] @ w[f"w{i}"] + w[f"b{i}"]))
    hs.append(relu(hs[-1] @ w["w5x"] + xe @ w["w5i"] + w["b5"]))
    for i in (6, 7):
        hs.append(relu(hs[-1] @ w[f"w{i}"] + w[f"b{i}"]))
    h7 = hs[7]
    raw_sigma = h7 @ w["wd"] + w["bd"]  # (rows, 1)
    btl = h7 @ w["wb"] + w["bb"]
    c_part = viewdirs_enc @ w["wvb"]
    c_rows = c_part[:, None, :].expand(R, S, c_part.shape[-1]).reshape(R * S, -1)
    zv = btl @ w["wva"] + c_rows + w["bv"]
    hv = relu(zv)
    raw_rgb = hv @ w["wr"] + w["br"]

    dnorm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True))
    dists = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
    dists = dists * dnorm
    sigma = relu(raw_sigma.reshape(R, S))
    expterm = torch.exp(-sigma * dists)
    alpha = 1.0 - expterm
    v = torch.clamp(1.0 - alpha + 1e-10, min=1e-10)
    logv = torch.log(v)
    trans = torch.exp(torch.cat([torch.zeros_like(logv[:, :1]), torch.cumsum(logv[:, :-1], -1)], -1))
    weights = alpha * trans
    rgb = torch.sigmoid(raw_rgb).reshape(R, S, 3)

    # integrator backward
    g_w = torch.sum(g_comp[:, None, :] * rgb, dim=-1)
    if white_bkgd:
        g_w = g_w - torch.sum(g_comp, dim=-1)[:, None]
    g_w = g_w + g_acc[:, None] + g_depth[:, None] * t_vals + g_weights
    gww = g_w * weights
    # suffix_i = sum_{j>i} gww_j, summed directly (a difference of prefix sums
    # would cancel where v is tiny)
    later = torch.flip(torch.cumsum(torch.flip(gww[:, 1:], [-1]), -1), [-1])
    suffix = torch.cat([later, torch.zeros_like(gww[:, :1])], -1)
    g_alpha = g_w * trans - suffix / v
    g_raw_sigma = (g_alpha * expterm * dists * _relu_mask(raw_sigma.reshape(R, S))).reshape(R * S, 1)
    sig = rgb.reshape(R * S, 3)
    g_raw_rgb = (g_comp[:, None, :] * weights[..., None]).reshape(R * S, 3) * sig * (1.0 - sig)

    # MLP backward
    g = {}
    g["wr"], g["br"] = hv.t() @ g_raw_rgb, g_raw_rgb.sum(0, keepdim=True)
    delta_v = (g_raw_rgb @ w["wr"].t()) * _relu_mask(zv)
    g["wva"], g["bv"] = mm(btl.t(), delta_v), delta_v.sum(0, keepdim=True)
    g_btl = mm(delta_v, w["wva"].t())
    g["wvb"] = viewdirs_enc.t() @ delta_v.reshape(R, S, -1).sum(1)
    g["wb"], g["bb"] = mm(h7.t(), g_btl), g_btl.sum(0, keepdim=True)
    g["wd"], g["bd"] = h7.t() @ g_raw_sigma, g_raw_sigma.sum(0, keepdim=True)
    g_h = mm(g_btl, w["wb"].t()) + g_raw_sigma @ w["wd"].t()
    for i in (7, 6):
        delta = g_h * _relu_mask(hs[i])
        g[f"w{i}"], g[f"b{i}"] = mm(hs[i - 1].t(), delta), delta.sum(0, keepdim=True)
        g_h = mm(delta, w[f"w{i}"].t())
    delta = g_h * _relu_mask(hs[5])
    g["w5x"], g["w5i"], g["b5"] = mm(hs[4].t(), delta), mm(xe.t(), delta), delta.sum(0, keepdim=True)
    g_h = mm(delta, w["w5x"].t())
    for i in (4, 3, 2, 1):
        delta = g_h * _relu_mask(hs[i])
        g[f"w{i}"], g[f"b{i}"] = mm(hs[i - 1].t(), delta), delta.sum(0, keepdim=True)
        g_h = mm(delta, w[f"w{i}"].t())
    delta = g_h * _relu_mask(hs[0])
    g["w0"], g["b0"] = mm(xe.t(), delta), delta.sum(0, keepdim=True)
    return {n: g[n] for n in WEIGHT_NAMES}


def _padded_offsets(shapes: List[Tuple[int, ...]]) -> List[int]:
    """Start of each gradient in the kernel's flat output: in WEIGHT_NAMES
    order, each padded to a multiple of 4 floats (16-byte aligned)."""
    offsets, n = [], 0
    for shape in shapes:
        offsets.append(n)
        size = 1
        for s in shape:
            size *= s
        n += (size + 3) // 4 * 4
    return offsets + [n]


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fused_train")
        fn = lib.aonerf_fused_level_bwd
        n_ptr = 4 + len(WEIGHT_NAMES) + 4 + 6
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in (
            "aonerf_fused_level_bwd_partial_floats", "aonerf_fused_level_bwd_saved_floats",
            "aonerf_fused_level_bwd_ranges", "aonerf_fused_level_bwd_narrow_floats",
        ):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cotangents(g_comp, g_acc, g_depth, g_weights, R, S, device):
    for name, x, shape in (
        ("g_comp", g_comp, (R, 3)), ("g_acc", g_acc, (R,)), ("g_depth", g_depth, (R,)),
        ("g_weights", g_weights, (R, S)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected float32 on {device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def fused_level_bwd(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    g_comp: torch.Tensor,
    g_acc: torch.Tensor,
    g_depth: torch.Tensor,
    g_weights: torch.Tensor,
    white_bkgd: bool,
    ray_tile: int = RAY_TILE,
) -> Dict[str, torch.Tensor]:
    """Gradients of the 26 level weights (each shaped like its weight) from
    the cotangents of :func:`fused_render_level`'s outputs: g_comp (R,3),
    g_acc (R,), g_depth (R,), g_weights (R,S). R % ray_tile == 0.

    On CUDA tensors this launches the backward (``csrc/fused_train.cu``):
    pass A and B1 with one block per ``ray_tile`` rays, B2 over a fixed
    number of row ranges, then the reduction; on CPU tensors it runs the
    plain version.
    """
    global launches
    R, S = t_vals.shape
    if R % ray_tile != 0:
        raise ValueError(f"rays {R} not a multiple of ray_tile {ray_tile}")
    if t_vals.device.type == "cpu":
        return fused_level_bwd_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc,
            g_comp, g_acc, g_depth, g_weights, white_bkgd,
        )
    if t_vals.device.type != "cuda":
        raise ValueError(f"fused_level_bwd runs on cuda or cpu, not {t_vals.device}")

    dev = t_vals.device
    xenc = samples_enc.reshape(R * S, samples_enc.shape[-1])
    _check_inputs(kernel_params, t_vals, rays_d, viewdirs_enc, xenc, R, S)
    _check_cotangents(g_comp, g_acc, g_depth, g_weights, R, S, dev)
    lib = _library()
    shapes = [tuple(kernel_params[n].shape) for n in WEIGHT_NAMES]
    offsets = _padded_offsets(shapes)
    n_out = lib.aonerf_fused_level_bwd_partial_floats()
    if n_out != offsets[-1]:
        raise RuntimeError(f"fused_level_bwd: kernel layout has {n_out} floats, expected {offsets[-1]}")
    n_blocks = R // ray_tile
    per_row = lib.aonerf_fused_level_bwd_saved_floats()
    saved = torch.empty(R * S * per_row, dtype=torch.float32, device=dev)
    delta = torch.empty(R * S * per_row, dtype=torch.float32, device=dev)
    grow = torch.empty(R * S * 4, dtype=torch.float32, device=dev)
    partials = torch.empty(lib.aonerf_fused_level_bwd_ranges() * n_out, dtype=torch.float32, device=dev)
    narrow = torch.empty(n_blocks * lib.aonerf_fused_level_bwd_narrow_floats(), dtype=torch.float32, device=dev)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.aonerf_fused_level_bwd(
            t_vals.data_ptr(), rays_d.data_ptr(), viewdirs_enc.data_ptr(), xenc.data_ptr(),
            *[kernel_params[n].data_ptr() for n in WEIGHT_NAMES],
            g_comp.data_ptr(), g_acc.data_ptr(), g_depth.data_ptr(), g_weights.data_ptr(),
            saved.data_ptr(), grow.data_ptr(), delta.data_ptr(), partials.data_ptr(), narrow.data_ptr(),
            out.data_ptr(),
            R, S, ray_tile, int(white_bkgd), stream,
        )
    if err != 0:  # e.g. ray_tile x S needs more shared memory than a block has
        raise RuntimeError(f"fused_level_bwd: CUDA launch failed with error {err}")
    launches += 1
    return {
        n: out[offsets[i] : offsets[i] + kernel_params[n].numel()].view(shapes[i])
        for i, n in enumerate(WEIGHT_NAMES)
    }


class FusedLevel(torch.autograd.Function):
    """One level as a differentiable function of its 26 weights: K1 forward,
    K2 backward (counterpart of ``make_fused_level``)."""

    @staticmethod
    def forward(ctx, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile, *weights):
        kp = dict(zip(WEIGHT_NAMES, weights))
        out = fused_render_level(kp, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile)
        ctx.save_for_backward(t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, *weights)
        ctx.white_bkgd, ctx.ray_tile = white_bkgd, ray_tile
        return out

    @staticmethod
    def backward(ctx, g_comp, g_acc, g_depth, g_weights):
        t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, *weights = ctx.saved_tensors
        grads = fused_level_bwd(
            dict(zip(WEIGHT_NAMES, weights)), t_vals, rays_o, rays_d, viewdirs_enc, samples_enc,
            g_comp.contiguous(), g_acc.contiguous(), g_depth.contiguous(), g_weights.contiguous(),
            ctx.white_bkgd, ctx.ray_tile,
        )
        return (None,) * 7 + tuple(grads[n] for n in WEIGHT_NAMES)


def fused_level(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    ray_tile: int = RAY_TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_render_level` with gradients to ``kernel_params``."""
    return FusedLevel.apply(
        t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile,
        *[kernel_params[n] for n in WEIGHT_NAMES],
    )


def fused_nerf_forward(
    coarse_mlp,
    fine_mlp,
    rays: Dict[str, torch.Tensor],
    randomized: bool,
    white_bkgd: bool,
    near: float,
    far: float,
    num_coarse_samples: int = 64,
    num_fine_samples: int = 128,
    lindisp: bool = False,
    draws=None,
    level: Callable = fused_level,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The two-level hierarchical forward with each level in ``level``.

    rays: 'rays_o', 'rays_d' (unit), 'viewdirs' (B, 3), B a multiple of
    ``RAY_TILE``. ``draws`` (see ``ops.random``) gives the coarse jitter and
    then the fine exponential draws when ``randomized``. Returns
    [(comp_rgb, acc, depth)] per level, coarse first.
    """
    o, d = rays["rays_o"], rays["rays_d"]
    viewdirs_enc = encoding.pos_enc(rays["viewdirs"], 0, coarse_mlp.deg_view)
    ret = []
    t_vals = weights = None
    for i_level, mlp in enumerate((coarse_mlp, fine_mlp)):
        if i_level == 0:
            t_vals, samples = sampling.sample_along_rays(
                o, d, num_coarse_samples, near, far, randomized, lindisp, draws=draws
            )
        else:
            t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
            t_vals, samples = sampling.sample_pdf(
                t_mids, weights[..., 1:-1], o, d, t_vals, num_fine_samples, randomized, draws=draws
            )
        t_vals = t_vals.contiguous()
        samples_enc = encoding.pos_enc(samples, mlp.min_deg_point, mlp.max_deg_point)
        comp_rgb, acc, depth, weights = level(
            kernel_params(mlp), t_vals, o, d, viewdirs_enc, samples_enc, white_bkgd
        )
        ret.append((comp_rgb, acc, depth))
    return ret
