"""The differentiable fused level: the spilling training forward K1s, and the
weight-gradient backward K2 from what it saved (counterpart of
``aonerf.ops.kernels.fused_train``).

``fused_level_fwd_spill`` and ``fused_level_bwd_saved`` launch the CUDA
kernels of ``csrc/fused_train.cu`` on CUDA tensors and run their plain
PyTorch versions (``*_ref``) on CPU tensors. Anything else raises; a CUDA
call never falls back to the plain version. ``fused_level_bwd`` is the two
composed: the gradient from the level's inputs alone.

Each training step runs each level's MLP forward once: K1s computes K1's
outputs (the same bits) and saves every sample's activations (``saved``,
SAVED_FLOATS a sample) and raw sigma and rgb (``raw``, 4 a sample); the
backward reads them. K1 (``fused_render``) serves and validates.

``noise`` (R, S), where given, is added to each sample's raw sigma before the
ReLU (``models.nerf``'s ``noise_std``: the draws times noise_std); ``raw``
holds the noisy sigma, so the backward, which takes sigma and its ReLU mask
from ``raw``, is that of the noisy level unchanged. K1 takes no noise:
serving and validation render deterministically.

``dot_bf16`` is the TPU kernels' mode of that name (see ``fused_render``):
the forward's products and its transmittance sum take bf16-rounded operands,
and the saved activations are the rounded ones, which the TPU backward keeps
in bf16 and ``saved`` holds as ``torch.bfloat16`` (:func:`saved_dtype`); the
backward's products round their operands too, but its integrator recomputes
the transmittance in fp32, and every bias gradient and the per-ray sum for
``wvb`` add the unrounded fp32 deltas. On the card B1 keeps its deltas in a
bf16 scratch, the operands B2 multiplies, and sums the bias gradients itself
from the fp32 deltas it holds.

The ray tile (rays a CUDA block) of K1s, and of K2 in bf16 mode, is chosen
per launch (``choose_ray_tile``); K1s' outputs do not depend on it. K2's
per-block head sums (wd, bd, wr, br, wvb) do, so its bits do: in fp32 K2
keeps ``RAY_TILE`` (16) rays a block, and so its bits, unless the caller
names a tile; in bf16 mode, held to the bf16 rule and not to bits, it takes
the tile that fills the card (2 at the fast preset's batch of 224).

Gradients flow to the 26 MLP weights only. Sample positions carry none in
this architecture (coarse t-values are parameter-free, fine t-values are
detached), so t, rays and encodings get no gradient. The integrator backward
is analytic:

  w_i = alpha_i T_i,   T_i = prod_{j<i} (1 - alpha_j + 1e-10)
  dL/dalpha_i = g_w_i T_i - sum_{j>i} g_w_j w_j / max(1 - alpha_i + 1e-10, 1e-10)
"""

import ctypes
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from aonerf_torch.ops import encoding, sampling
from aonerf_torch.ops.kernels import build
from aonerf_torch.ops.kernels.fused_render import (
    COND_WIDTH,
    POS_DIM,
    RAY_TILE,
    VIEW_DIM,
    WEIGHT_NAMES,
    WIDTH,
    _check_inputs,
    bf16_products,
    check_forward_layout,
    check_launch,
    fwd_operands,
    integrate_ref,
    kernel_params,
    launch_ray_tile,
    level_activations_ref,
    round_bf16,
    slice_order,
    tf32_safe_nan_,
    widths,
)

# Saved activations per sample: h0..h7, the bottleneck, the view hidden layer.
SAVED_FLOATS = 9 * WIDTH + COND_WIDTH
# B1's tensor-core products, in the order its weight stream reads them
# (csrc/nerf_level.cuh's B1Schedule), each in its flax (in, out) layout; in
# bf16 mode it reads them from :func:`b1_weights_bf16` and, beside them, only
# the narrow heads of B1_HEADS, rounded.
B1_WEIGHTS = ("wva", "wb", "w7", "w6", "w5x", "w4", "w3", "w2", "w1")
B1_PACK_ELEMS = WIDTH * COND_WIDTH + 8 * WIDTH * WIDTH
B1_HEADS = ("wd", "wr")

# Launches of K1s (fwd_launches) and of the CUDA backward (launches) since
# each count was last set to 0, in fp32; bf16_fwd_launches and bf16_launches
# count the same in bf16 mode. fwd_tiles and bwd_tiles: the ray tile of each
# K1s and K2 launch's shape, (rays, samples, dot_bf16) -> tile, since each
# was last cleared.
fwd_launches = 0
launches = 0
bf16_fwd_launches = 0
bf16_launches = 0
fwd_tiles: Dict[Tuple[int, int, bool], int] = {}
bwd_tiles: Dict[Tuple[int, int, bool], int] = {}


def saved_dtype(dot_bf16: bool) -> torch.dtype:
    """The dtype of ``saved`` (and of the backward's delta scratch):
    ``torch.bfloat16`` in bf16 mode, whose values are bf16, else fp32."""
    return torch.bfloat16 if dot_bf16 else torch.float32


def _masked(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """g where x > 0, else 0: the ReLU's backward. A select, as XLA computes
    the Pallas kernel's ``g * (x > 0)``: a NaN x or a NaN g under a closed
    mask gives 0."""
    return torch.where(x > 0.0, g, 0.0)


def bias_grad(delta: torch.Tensor) -> torch.Tensor:
    """A bias's gradient: its layer's deltas summed over the rows, in the
    deltas' own precision (the TPU kernel's ``bias_grad``)."""
    return delta.sum(0, keepdim=True)


def fused_level_fwd_spill_ref(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
    dot_bf16: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K1s. Same arguments and outputs as
    :func:`fused_level_fwd_spill`, on any device: those of
    ``fused_render_level_ref``, then ``saved`` (R*S, SAVED_FLOATS; in bf16
    mode ``torch.bfloat16``, the rounded activations exactly, whatever the
    inputs' dtype) and ``raw`` (R*S, 4) in the kernel's layout; ``mm`` as in
    ``level_activations_ref``; ``noise`` (R, S) added to raw sigma."""
    R, S = t_vals.shape
    acts, raw_sigma, raw_rgb = level_activations_ref(
        kernel_params, viewdirs_enc, samples_enc.reshape(R * S, -1), S, mm=mm, dot_bf16=dot_bf16
    )
    if noise is not None:
        raw_sigma = raw_sigma + noise.reshape(R * S, 1)
    saved = torch.cat(acts, -1)
    if dot_bf16:
        saved = saved.to(torch.bfloat16)
    del acts
    raw = torch.cat([raw_sigma, raw_rgb], -1)
    return (*integrate_ref(raw_sigma, raw_rgb, t_vals, rays_d, white_bkgd, dot_bf16=dot_bf16), saved, raw)


def fused_level_bwd_saved_ref(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    saved: torch.Tensor,
    raw: torch.Tensor,
    g_comp: torch.Tensor,
    g_acc: torch.Tensor,
    g_depth: torch.Tensor,
    g_weights: torch.Tensor,
    white_bkgd: bool,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
    dot_bf16: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the backward from what K1s saved, written out
    as the TPU kernel's body is (``_bwd_kernel``). Same arguments and outputs
    as :func:`fused_level_bwd_saved`, on any device.

    ``mm`` computes the MLP backward's products that the CUDA kernel runs on
    the tensor cores (every dW and every delta . W^T but the narrow heads');
    tests pass an emulation of the kernel's 3xTF32 arithmetic. The default is
    plain ``@``. With ``dot_bf16`` every product, these and the heads',
    rounds its operands to bf16; the integrator backward, the deltas, the
    bias gradients and the per-ray sum for ``wvb`` stay fp32. ``saved`` may
    be of any dtype (``torch.bfloat16`` as the bf16 forward gives it): it is
    widened to the inputs' dtype."""
    w = kernel_params
    dot = torch.matmul
    if dot_bf16:
        mm, dot = bf16_products(mm), bf16_products(torch.matmul)
    R, S = t_vals.shape
    saved = saved.to(t_vals.dtype)
    xe = samples_enc.reshape(R * S, -1)
    hs = [saved[:, i * WIDTH : (i + 1) * WIDTH] for i in range(8)]
    h7 = hs[7]
    btl = saved[:, 8 * WIDTH : 9 * WIDTH]
    hv = saved[:, 9 * WIDTH :]
    raw_sigma, raw_rgb = raw[:, :1], raw[:, 1:]

    dnorm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True))
    dists = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
    dists = dists * dnorm
    sigma = torch.relu(raw_sigma.reshape(R, S))
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
    g_raw_sigma = _masked(g_alpha * expterm * dists, raw_sigma.reshape(R, S)).reshape(R * S, 1)
    sig = rgb.reshape(R * S, 3)
    g_raw_rgb = (g_comp[:, None, :] * weights[..., None]).reshape(R * S, 3) * sig * (1.0 - sig)

    # MLP backward; hv = relu(zv), so hv > 0 is zv's mask
    g = {}
    g["wr"], g["br"] = dot(hv.t(), g_raw_rgb), bias_grad(g_raw_rgb)
    delta_v = _masked(dot(g_raw_rgb, w["wr"].t()), hv)
    g["wva"], g["bv"] = mm(btl.t(), delta_v), bias_grad(delta_v)
    g_btl = mm(delta_v, w["wva"].t())
    g["wvb"] = dot(viewdirs_enc.t(), delta_v.reshape(R, S, -1).sum(1))
    g["wb"], g["bb"] = mm(h7.t(), g_btl), bias_grad(g_btl)
    g["wd"], g["bd"] = dot(h7.t(), g_raw_sigma), bias_grad(g_raw_sigma)
    g_h = mm(g_btl, w["wb"].t()) + dot(g_raw_sigma, w["wd"].t())
    for i in (7, 6):
        delta = _masked(g_h, hs[i])
        g[f"w{i}"], g[f"b{i}"] = mm(hs[i - 1].t(), delta), bias_grad(delta)
        g_h = mm(delta, w[f"w{i}"].t())
    delta = _masked(g_h, hs[5])
    g["w5x"], g["w5i"], g["b5"] = mm(hs[4].t(), delta), mm(xe.t(), delta), bias_grad(delta)
    g_h = mm(delta, w["w5x"].t())
    for i in (4, 3, 2, 1):
        delta = _masked(g_h, hs[i])
        g[f"w{i}"], g[f"b{i}"] = mm(hs[i - 1].t(), delta), bias_grad(delta)
        g_h = mm(delta, w[f"w{i}"].t())
    delta = _masked(g_h, hs[0])
    g["w0"], g["b0"] = mm(xe.t(), delta), bias_grad(delta)
    return {n: g[n] for n in WEIGHT_NAMES}


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
    dot_bf16: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_level_bwd`, on any device:
    :func:`fused_level_bwd_saved_ref` from what :func:`fused_level_fwd_spill_ref`
    saves. ``mm`` as there."""
    inputs = (kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc)
    *_, saved, raw = fused_level_fwd_spill_ref(*inputs, white_bkgd, dot_bf16=dot_bf16)
    return fused_level_bwd_saved_ref(
        *inputs, saved, raw, g_comp, g_acc, g_depth, g_weights, white_bkgd, mm=mm, dot_bf16=dot_bf16
    )


def b1_weights_bf16(kernel_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """B1's bf16 pack: its product weights in ``B1_WEIGHTS`` order, each in
    its flax (in, out) layout, untransposed, packed into one flat contiguous
    ``torch.bfloat16`` buffer of ``B1_PACK_ELEMS`` on the weights' device,
    each rounded to bf16 (to nearest, ties to even) and every 32-column
    block of a row put in ``BF16_SLICE_ORDER``, as the forward's pack
    (``kernel_weights_t_bf16``); detached. One concatenation, one rounding
    and one gather a launch. Undone, its values are those of
    ``bf16_params(kernel_params)``'s weights, in order."""
    rows = torch.cat([kernel_params[n].detach().reshape(-1, 32) for n in B1_WEIGHTS])
    return rows.to(torch.bfloat16).index_select(1, slice_order(rows.device)).view(-1)


def b1_weights(kernel_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 B1's product weights, name -> a copy in its flax (in, out)
    layout, detached: views of one flat buffer (one concatenation a launch,
    each view 16-byte aligned) in which every NaN is made TF32-safe
    (``fused_render.tf32_safe_nan_``); every other value keeps its bits."""
    flat = tf32_safe_nan_(torch.cat([kernel_params[n].detach().reshape(-1) for n in B1_WEIGHTS]))
    views, start = {}, 0
    for n in B1_WEIGHTS:
        w = kernel_params[n]
        views[n] = flat[start : start + w.numel()].view(w.shape)
        start += w.numel()
    return views


def bwd_operands(kernel_params: Dict[str, torch.Tensor], dot_bf16: bool):
    """What the backward kernels take beside the inputs: the 26 weights (in
    fp32 mode with B1's product weights from :func:`b1_weights`; in bf16
    mode with the narrow heads of B1_HEADS rounded to bf16, B1 reading no
    other) and B1's pack, :func:`b1_weights_bf16` in bf16 mode, else None
    (fp32 B1 streams the flax-layout weights)."""
    if not dot_bf16:
        return {**kernel_params, **b1_weights(kernel_params)}, None
    heads = {n: round_bf16(kernel_params[n].detach()) for n in B1_HEADS}
    return {**kernel_params, **heads}, b1_weights_bf16(kernel_params)


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


# The loaded library of each pair of encoded widths.
_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}


def _library(pos_dim: int = POS_DIM, view_dim: int = VIEW_DIM):
    """K1s' and K2's library for these encoded widths, built at first use."""
    lib = _libs.get((pos_dim, view_dim))
    if lib is None:
        lib = build.load("fused_train", build.width_defines(pos_dim, view_dim))
        n_w = len(WEIGHT_NAMES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (
            ("aonerf_fused_level_fwd_spill", 4 + n_w + 1 + 7),
            ("aonerf_fused_level_bwd_saved", 4 + n_w + 1 + 4 + 2 + 5),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + [i32] * 5 + [ptr]
            fn.restype = i32
        for name in (
            "aonerf_fused_level_bwd_partial_floats", "aonerf_fused_level_bwd_saved_floats",
            "aonerf_fused_level_bwd_ranges", "aonerf_fused_level_b1_bf16_bytes",
        ):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.aonerf_fused_level_bwd_narrow_floats.argtypes = [i32]
        lib.aonerf_fused_level_bwd_narrow_floats.restype = i32
        lib.aonerf_fused_level_bwd_smem_bytes.argtypes = [i32, i32]
        lib.aonerf_fused_level_bwd_smem_bytes.restype = i32
        if lib.aonerf_fused_level_bwd_saved_floats() != SAVED_FLOATS:
            raise RuntimeError(f"fused_train: kernel saves {lib.aonerf_fused_level_bwd_saved_floats()} floats "
                               f"a sample, expected {SAVED_FLOATS}")
        if lib.aonerf_fused_level_b1_bf16_bytes() != 2 * B1_PACK_ELEMS:
            raise RuntimeError(f"fused_train: kernel's B1 pack is {lib.aonerf_fused_level_b1_bf16_bytes()} bytes, "
                               f"expected {2 * B1_PACK_ELEMS}")
        check_forward_layout(lib, "aonerf_fused_level", "fused_train", pos_dim, view_dim, smem="fwd_smem_bytes")
        lib = _libs[(pos_dim, view_dim)] = lib
    return lib


def _check(name, x, shape, device, dtype=torch.float32):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {str(dtype).replace('torch.', '')} on {device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_cotangents(g_comp, g_acc, g_depth, g_weights, R, S, device):
    for name, x, shape in (
        ("g_comp", g_comp, (R, 3)), ("g_acc", g_acc, (R,)), ("g_depth", g_depth, (R,)),
        ("g_weights", g_weights, (R, S)),
    ):
        _check(name, x, shape, device)


def _device_of(fn_name, t_vals, R, ray_tile):
    """'cpu' or 'cuda' for a call of fn_name; raises on anything else, or
    unless ray_tile (where given) divides R."""
    if ray_tile is not None and (ray_tile <= 0 or R % ray_tile != 0):
        raise ValueError(f"rays {R} not a multiple of ray_tile {ray_tile}")
    if t_vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn_name} runs on cuda or cpu, not {t_vals.device}")
    return t_vals.device.type


def _bwd_tile(ray_tile: Optional[int], dot_bf16: bool) -> Optional[int]:
    """K2's tile before the card is asked: the caller's, else RAY_TILE in
    fp32 (its bits) and None in bf16 mode (chosen per launch on the card)."""
    return RAY_TILE if ray_tile is None and not dot_bf16 else ray_tile


def _launch(fn_name, dev, fn, *args):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(fn_name, err)


class BackwardScratch(NamedTuple):
    """The backward's device scratch, in the order the C entry points take it:
    grow (R*S*4), delta (R*S*SAVED_FLOATS, B1's deltas, which B2 reads: fp32,
    or in bf16 mode bf16, the rounded deltas B2 multiplies), the row ranges'
    partial sets, the B1 blocks' narrow sets (in bf16 mode with the bias
    sums), and out (the 26 gradients, padded)."""

    grow: torch.Tensor
    delta: torch.Tensor
    partials: torch.Tensor
    narrow: torch.Tensor
    out: torch.Tensor


def _backward_scratch(lib, kernel_params, R, S, ray_tile, dev, dot_bf16):
    """A :class:`BackwardScratch` and the 26 gradients as views of its out."""
    shapes = [tuple(kernel_params[n].shape) for n in WEIGHT_NAMES]
    offsets = _padded_offsets(shapes)
    n_out = lib.aonerf_fused_level_bwd_partial_floats()
    if n_out != offsets[-1]:
        raise RuntimeError(f"fused_train: kernel layout has {n_out} floats, expected {offsets[-1]}")
    f32 = dict(dtype=torch.float32, device=dev)
    grow = torch.empty(R * S * 4, **f32)
    delta = torch.empty(R * S * SAVED_FLOATS, dtype=saved_dtype(dot_bf16), device=dev)
    partials = torch.empty(lib.aonerf_fused_level_bwd_ranges() * n_out, **f32)
    narrow = torch.empty((R // ray_tile) * lib.aonerf_fused_level_bwd_narrow_floats(int(dot_bf16)), **f32)
    out = torch.empty(n_out, **f32)
    grads = {n: out[offsets[i] : offsets[i] + kernel_params[n].numel()].view(shapes[i])
             for i, n in enumerate(WEIGHT_NAMES)}
    return BackwardScratch(grow, delta, partials, narrow, out), grads


def fused_level_fwd_spill(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    ray_tile: Optional[int] = None,
    dot_bf16: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The level's training forward (K1s): :func:`fused_render_level`'s
    outputs (comp (R,3), acc (R,), depth (R,), weights (R,S), the same bits as
    K1's on the card), then what the backward reads: ``saved`` (R*S,
    SAVED_FLOATS), every sample's activations h0..h7, bottleneck and view
    hidden layer (with ``dot_bf16`` rounded to bf16, as ``torch.bfloat16``),
    and ``raw`` (R*S, 4), its raw sigma and rgb. ``noise`` (R, S) fp32, where
    given, is added to raw sigma in fp32 before the integrator and ``raw``
    see it (the outputs are then no longer K1's).

    On CUDA tensors this builds :func:`kernel_weights_t` and launches K1s,
    one block per ``ray_tile`` rays (None: the tile ``choose_ray_tile``
    picks, recorded in ``fwd_tiles``; the outputs do not depend on it), with
    ``dot_bf16`` its bf16 mode on :func:`kernel_weights_t_bf16` and the
    rounded narrow heads; on CPU tensors it runs the plain version.
    """
    global fwd_launches, bf16_fwd_launches
    R, S = t_vals.shape
    if _device_of("fused_level_fwd_spill", t_vals, R, ray_tile) == "cpu":
        return fused_level_fwd_spill_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, dot_bf16=dot_bf16,
            noise=noise,
        )
    dev = t_vals.device
    xenc = samples_enc.reshape(R * S, samples_enc.shape[-1])
    _check_inputs(kernel_params, t_vals, rays_d, viewdirs_enc, xenc, R, S)
    if noise is not None:
        _check("noise", noise, (R, S), dev)
    lib = _library(*widths(kernel_params))
    ray_tile = launch_ray_tile(R, S, ray_tile, dev, lib.aonerf_fused_level_fwd_smem_bytes)
    kernel_params, wt = fwd_operands(kernel_params, dot_bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    comp, acc, depth = torch.empty((R, 3), **f32), torch.empty((R,), **f32), torch.empty((R,), **f32)
    weights = torch.empty((R, S), **f32)
    saved = torch.empty((R * S, SAVED_FLOATS), dtype=saved_dtype(dot_bf16), device=dev)
    raw = torch.empty((R * S, 4), **f32)
    _launch(
        "fused_level_fwd_spill", dev, lib.aonerf_fused_level_fwd_spill,
        t_vals.data_ptr(), rays_d.data_ptr(), viewdirs_enc.data_ptr(), xenc.data_ptr(),
        *[kernel_params[n].data_ptr() for n in WEIGHT_NAMES], wt.data_ptr(),
        comp.data_ptr(), acc.data_ptr(), depth.data_ptr(), weights.data_ptr(), saved.data_ptr(), raw.data_ptr(),
        None if noise is None else noise.data_ptr(), R, S, ray_tile, int(white_bkgd), int(dot_bf16),
    )
    fwd_tiles[(R, S, dot_bf16)] = ray_tile
    if dot_bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return comp, acc, depth, weights, saved, raw


def fused_level_bwd_saved(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    saved: torch.Tensor,
    raw: torch.Tensor,
    g_comp: torch.Tensor,
    g_acc: torch.Tensor,
    g_depth: torch.Tensor,
    g_weights: torch.Tensor,
    white_bkgd: bool,
    ray_tile: Optional[int] = None,
    dot_bf16: bool = False,
    deltas: bool = False,
):
    """Gradients of the 26 level weights (each shaped like its weight) from
    what :func:`fused_level_fwd_spill` saved (``saved``, ``raw``) and the
    cotangents of its outputs: g_comp (R,3), g_acc (R,), g_depth (R,),
    g_weights (R,S). R % ray_tile == 0. ``saved`` is of
    :func:`saved_dtype` (``torch.bfloat16`` in bf16 mode) on either device;
    another dtype raises.

    On CUDA tensors this launches the backward (``csrc/fused_train.cu``): the
    integrator backward (one warp per ray), B1 with one block per
    ``ray_tile`` rays, B2 over a fixed number of row ranges, then the
    reduction. ``ray_tile`` None is RAY_TILE (16) in fp32; with ``dot_bf16``
    (B1 and B2 in bf16 mode: B1 on :func:`bwd_operands`) it is the tile
    ``choose_ray_tile`` picks from B1's shared memory on the card. The tile
    sets the order of B1's per-block head sums, and so the bits; it is
    recorded in ``bwd_tiles``. On CPU tensors it runs the plain version,
    which takes no tile. With ``deltas`` (CUDA tensors only) it returns
    (gradients, B1's deltas as (R*S, SAVED_FLOATS), the integrator backward's
    g_raw as (R*S, 4)), the operands B1 and B2 read beside the saved
    activations; the deltas are fp32, or in bf16 mode the rounded ones, as
    ``torch.bfloat16``.
    """
    global launches, bf16_launches
    R, S = t_vals.shape
    ray_tile = _bwd_tile(ray_tile, dot_bf16)
    on = _device_of("fused_level_bwd_saved", t_vals, R, ray_tile)
    if saved.dtype != saved_dtype(dot_bf16):  # on either device, so the CPU takes what the card takes
        raise ValueError(f"saved: {saved.dtype}, expected {str(saved_dtype(dot_bf16)).replace('torch.', '')}")
    if on == "cpu":
        if deltas:
            raise ValueError("fused_level_bwd_saved: deltas come from the kernel's scratch, on cuda tensors only")
        return fused_level_bwd_saved_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, saved, raw,
            g_comp, g_acc, g_depth, g_weights, white_bkgd, dot_bf16=dot_bf16,
        )
    dev = t_vals.device
    xenc = samples_enc.reshape(R * S, samples_enc.shape[-1])
    _check_inputs(kernel_params, t_vals, rays_d, viewdirs_enc, xenc, R, S)
    _check_cotangents(g_comp, g_acc, g_depth, g_weights, R, S, dev)
    _check("saved", saved, (R * S, SAVED_FLOATS), dev, saved_dtype(dot_bf16))
    _check("raw", raw, (R * S, 4), dev)
    lib = _library(*widths(kernel_params))
    ray_tile = launch_ray_tile(R, S, ray_tile, dev, lib.aonerf_fused_level_bwd_smem_bytes)
    kernel_params, b1_pack = bwd_operands(kernel_params, dot_bf16)
    scratch, grads = _backward_scratch(lib, kernel_params, R, S, ray_tile, dev, dot_bf16)
    _launch(
        "fused_level_bwd_saved", dev, lib.aonerf_fused_level_bwd_saved,
        t_vals.data_ptr(), rays_d.data_ptr(), viewdirs_enc.data_ptr(), xenc.data_ptr(),
        *[kernel_params[n].data_ptr() for n in WEIGHT_NAMES], b1_pack.data_ptr() if dot_bf16 else None,
        g_comp.data_ptr(), g_acc.data_ptr(), g_depth.data_ptr(), g_weights.data_ptr(),
        saved.data_ptr(), raw.data_ptr(), *[x.data_ptr() for x in scratch],
        R, S, ray_tile, int(white_bkgd), int(dot_bf16),
    )
    bwd_tiles[(R, S, dot_bf16)] = ray_tile
    if dot_bf16:
        bf16_launches += 1
    else:
        launches += 1
    if deltas:
        return grads, scratch.delta.view(R * S, SAVED_FLOATS), scratch.grow.view(R * S, 4)
    return grads


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
    ray_tile: Optional[int] = None,
    dot_bf16: bool = False,
) -> Dict[str, torch.Tensor]:
    """Gradients of the 26 level weights from the level's inputs and the
    cotangents of :func:`fused_render_level`'s outputs alone: K1s at the
    tile it chooses, then the backward from what it saved
    (:func:`fused_level_bwd_saved`) at ``ray_tile`` (None: K2's default). On
    CPU tensors it runs the plain version."""
    R, S = t_vals.shape
    if _device_of("fused_level_bwd", t_vals, R, _bwd_tile(ray_tile, dot_bf16)) == "cpu":
        return fused_level_bwd_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc,
            g_comp, g_acc, g_depth, g_weights, white_bkgd, dot_bf16=dot_bf16,
        )
    _check_cotangents(g_comp, g_acc, g_depth, g_weights, R, S, t_vals.device)
    inputs = (kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc)
    *_, saved, raw = fused_level_fwd_spill(*inputs, white_bkgd, dot_bf16=dot_bf16)
    return fused_level_bwd_saved(*inputs, saved, raw, g_comp, g_acc, g_depth, g_weights, white_bkgd,
                                 ray_tile=ray_tile, dot_bf16=dot_bf16)


class FusedLevel(torch.autograd.Function):
    """One level as a differentiable function of its 26 weights: K1s forward,
    K2 backward from what it saved, both in the mode ``dot_bf16`` says
    (counterpart of ``make_fused_level``). K1s runs at the tile it chooses
    (its outputs do not depend on it); K2 at ``ray_tile``, which sets the
    order of B1's per-block head sums and so its bits: None is 16 rays a
    block in fp32 and, in bf16 mode, the tile chosen per launch
    (:func:`fused_level_bwd_saved`). ``noise`` (or None) goes to K1s; K2
    reads the noisy raw sigma K1s saved."""

    @staticmethod
    def forward(ctx, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile, dot_bf16, noise,
                *weights):
        kp = dict(zip(WEIGHT_NAMES, weights))
        *out, saved, raw = fused_level_fwd_spill(
            kp, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, dot_bf16=dot_bf16, noise=noise
        )
        ctx.save_for_backward(t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, *weights)
        # neither inputs nor outputs: kept as attributes, dropped by backward
        ctx.saved_acts, ctx.raw = saved, raw
        ctx.white_bkgd, ctx.ray_tile, ctx.dot_bf16 = white_bkgd, ray_tile, dot_bf16
        return tuple(out)

    @staticmethod
    def backward(ctx, g_comp, g_acc, g_depth, g_weights):
        t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, *weights = ctx.saved_tensors
        grads = fused_level_bwd_saved(
            dict(zip(WEIGHT_NAMES, weights)), t_vals, rays_o, rays_d, viewdirs_enc, samples_enc,
            ctx.saved_acts, ctx.raw,
            g_comp.contiguous(), g_acc.contiguous(), g_depth.contiguous(), g_weights.contiguous(),
            ctx.white_bkgd, ctx.ray_tile, ctx.dot_bf16,
        )
        ctx.saved_acts = ctx.raw = None  # the fine level's saved is 3.85 GB at batch 2048 (1.92 in bf16)
        return (None,) * 9 + tuple(grads[n] for n in WEIGHT_NAMES)


def fused_level(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    ray_tile: Optional[int] = None,
    dot_bf16: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_render_level` with gradients to ``kernel_params``;
    ``ray_tile`` is the backward's (K2's) tile: None is RAY_TILE (16) in fp32,
    so the batch must be a multiple of it, and in bf16 mode the tile chosen
    per launch, so any batch. ``noise`` (R, S), where given, is added to raw
    sigma (:func:`fused_level_fwd_spill`)."""
    return FusedLevel.apply(
        t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, ray_tile, dot_bf16, noise,
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
    dot_bf16: bool = False,
    noise_std: float = 0.0,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The two-level hierarchical forward with each level in ``level``, in
    the kernels' bf16 mode with ``dot_bf16``.

    rays: 'rays_o', 'rays_d' (unit), 'viewdirs' (B, 3), B a multiple of
    ``RAY_TILE`` where ``level`` runs K2 (the default) in fp32. ``draws`` (see
    ``ops.random``) gives the coarse jitter and then the fine exponential
    draws when ``randomized``; with ``noise_std`` > 0 also each level's sigma
    noise after its samples (``draws.noise``, times noise_std), which
    ``level`` then takes as ``noise``. Returns [(comp_rgb, acc, depth)] per
    level, coarse first.
    """
    noisy = randomized and noise_std > 0
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
        extra = {"noise": draws.noise(t_vals.shape) * noise_std} if noisy else {}
        comp_rgb, acc, depth, weights = level(
            kernel_params(mlp), t_vals, o, d, viewdirs_enc, samples_enc, white_bkgd, dot_bf16=dot_bf16, **extra
        )
        ret.append((comp_rgb, acc, depth))
    return ret
