"""Fused NeRF level: MLP trunk + heads + alpha compositing for a set of rays
(counterpart of ``aonerf.ops.kernels.fused_render``).

``fused_render_level`` launches the CUDA kernel ``csrc/fused_render.cu`` on
CUDA tensors and runs ``fused_render_level_ref``, the plain PyTorch version of
the same function, on CPU tensors. Anything else raises; a CUDA call never
falls back to the plain version.

The function is the TPU kernel's: the skip layer as a split matmul, the view
condition contracted once per ray, transmittance as exp of an exclusive sum of
log(max(1 - alpha + 1e-10, 1e-10)), and depth without the NaN/clip step of
``ops/render.py``.

The encoded widths are the weights': w0 (P, 256) takes P encoded sample
features and wvb (V, 128) V encoded view-direction features, P and V of
any encoding degrees (``pos_enc_dim``), as the TPU kernel takes any. The
CUDA kernels are built for one pair a library (``build.width_defines``),
at first use of the pair; the default 63 / 27 (the 10 / 4 degrees) and any
other pair load side by side.

``dot_bf16`` is the TPU kernel's argument of that name: every product of the
level (the trunk, the heads, the view term) takes its two operands rounded to
bf16 (to nearest, ties to even) and sums in fp32; biases, ReLUs and the
integrator stay fp32, but for the transmittance's exclusive sum, which the TPU
kernel takes as a product too, so each log term is rounded to bf16 before it
is summed.
"""

import ctypes
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from aonerf_torch.ops.kernels import build

WEIGHT_NAMES = (
    "w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4",
    "w5x", "w5i", "b5", "w6", "b6", "w7", "b7",
    "wd", "bd", "wb", "bb", "wva", "wvb", "bv", "wr", "br",
)
WIDTH, COND_WIDTH = 256, 128
POS_DIM, VIEW_DIM = build.DEFAULT_WIDTHS  # the encoded widths at the 10 / 4 degrees
# Shared memory a block of the forward kernels may have on the H100 (the
# opt-in limit the card reports), which bounds the encoded widths the
# kernels' layout holds (:func:`forward_smem_bytes`).
H100_SMEM_PER_BLOCK = 232448


def pos_pad(pos_dim: int) -> int:
    """The K of w0 and w5i in the forward kernels: pos_dim padded with zero
    columns to a multiple of the 32-deep K-slice (csrc's kPosPad)."""
    return -(-pos_dim // 32) * 32


def weights_t_layout(pos_dim: int = POS_DIM) -> Tuple[Tuple[str, int, int], ...]:
    """The forward kernels' tensor-core product weights at encoded width
    pos_dim, in the order of the packed buffer of :func:`kernel_weights_t`:
    (name, out, in padded)."""
    pad = pos_pad(pos_dim)
    return (
        ("w0", WIDTH, pad), ("w1", WIDTH, WIDTH), ("w2", WIDTH, WIDTH), ("w3", WIDTH, WIDTH),
        ("w4", WIDTH, WIDTH), ("w5x", WIDTH, WIDTH), ("w5i", WIDTH, pad), ("w6", WIDTH, WIDTH),
        ("w7", WIDTH, WIDTH), ("wb", WIDTH, WIDTH), ("wva", COND_WIDTH, WIDTH),
    )


def wt_floats(pos_dim: int = POS_DIM) -> int:
    """Elements of :func:`kernel_weights_t`'s buffer at encoded width pos_dim."""
    return sum(rows * cols for _, rows, cols in weights_t_layout(pos_dim))


POS_PAD = pos_pad(POS_DIM)
WEIGHTS_T = weights_t_layout(POS_DIM)
WT_FLOATS = wt_floats(POS_DIM)
# The narrow heads the forward kernels read as fp32 (rounded in bf16 mode);
# every other weight of the forward reaches them in the packed copy.
FWD_HEADS = ("wd", "wr", "wvb")
# The largest ray tile (rays per CUDA block), and K2's: 16 rays of 193
# samples fill 48.25 chunks of 64 rows (1.5% padding; 4.6% at S=65) and fit
# the block's per-sample scratch into shared memory.
RAY_TILE = 16
CHUNK_ROWS = 64  # the forward kernels' rows a chunk
# The bf16 pack's order within each 32-column block of a row (gemm_bf16 in
# csrc/nerf_level.cuh): position 8 t + 4 s + 2 q + e holds column 16 s +
# 4 ((t & 1) ^ s) + 2 (t >> 1) + 8 q + e, so the 16-byte chunk t holds the
# four bf16 pairs that thread t of a warp multiplies in the block's two k16
# steps (columns 0-15, then 16-31).
BF16_SLICE_ORDER = tuple(16 * s + 4 * ((t & 1) ^ s) + 2 * (t >> 1) + 8 * q + e
                         for t in range(4) for s in range(2) for q in range(2) for e in range(2))

# Launches of the CUDA kernel since each count was last set to 0: in fp32
# (launches) and in bf16 mode (bf16_launches); and the ray tile of each
# launch's shape, (rays, samples, dot_bf16) -> tile, since it was last
# cleared.
launches = 0
bf16_launches = 0
launch_tiles: Dict[Tuple[int, int, bool], int] = {}
# The tiles launch_ray_tile chose: (rays, samples, card, id of smem_bytes) ->
# (smem_bytes, tile). The rule is pure, so a launch of a shape already seen
# asks the library nothing; smem_bytes (a ctypes function, which cannot be
# hashed) is kept beside its tile so that its id keeps naming it.
_chosen_tiles: Dict[Tuple[int, int, int, int], Tuple[Callable[[int, int], int], int]] = {}
# A launcher's return code at or above this is this plus the CUresult with
# which the driver refused one of the weight stream's TMA maps (kMapError).
MAP_ERROR = 1000


def widths(kernel_params: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """The encoded widths of a level's weights: (xenc's features, w0's
    rows; venc's features, wvb's rows)."""
    return kernel_params["w0"].shape[0], kernel_params["wvb"].shape[0]


def forward_smem_bytes(S: int, ray_tile: int, pos_dim: int = POS_DIM) -> int:
    """Shared memory of a forward block (K1, K1s) of ray_tile rays of S
    samples at encoded width pos_dim (csrc's forward_smem_bytes, which the
    libraries' smem functions return): the 1 KB-aligned weight ring of 5
    stages of 16 KB and its barriers, the chunk's 64 x 260 activation and
    64 x (pos_pad + 4) encoded inputs, 128 view terms a ray and 4 floats a
    sample."""
    ring = 1024 + 5 * 256 * 16 * 4 + 128
    return ring + 4 * (64 * (WIDTH + 4) + 64 * (pos_pad(pos_dim) + 4) + ray_tile * COND_WIDTH + 4 * ray_tile * S)


def kernel_params(mlp) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a ``NeRFMLP``, in ``WEIGHT_NAMES`` order.

    Kernels are in the flax (in, out) layout, biases (1, out); ``pts_5`` and
    ``views_0`` are split into their trunk/skip and bottleneck/view halves,
    as ``aonerf.ops.kernels.mlp_params_from_flax`` does. Every tensor is a
    contiguous copy or view. With grad enabled, autograd carries their
    gradients back to the ``nn.Linear`` weights and biases; without, they
    are detached.
    """
    grad = torch.is_grad_enabled()

    def k(layer):
        w = layer.weight if grad else layer.weight.detach()
        return w.t().contiguous()

    def b(layer):
        bias = layer.bias if grad else layer.bias.detach()
        return bias.reshape(1, -1).contiguous()

    out = {}
    for i in range(8):
        layer = getattr(mlp, f"pts_{i}")
        if i == 5:
            kern = k(layer)
            out["w5x"] = kern[:WIDTH].contiguous()
            out["w5i"] = kern[WIDTH:].contiguous()
        else:
            out[f"w{i}"] = k(layer)
        out[f"b{i}"] = b(layer)
    out["wd"], out["bd"] = k(mlp.density), b(mlp.density)
    out["wb"], out["bb"] = k(mlp.bottleneck), b(mlp.bottleneck)
    kv = k(mlp.views_0)
    out["wva"] = kv[:WIDTH].contiguous()
    out["wvb"] = kv[WIDTH:].contiguous()
    out["bv"] = b(mlp.views_0)
    out["wr"], out["br"] = k(mlp.rgb), b(mlp.rgb)
    return {n: out[n] for n in WEIGHT_NAMES}


def tf32_safe_nan_(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` with every NaN made torch's NaN (0x7fc00000), in place. The
    fp32 kernels split each weight into TF32 halves on the integer pipe,
    which carries a NaN whose mantissa's high bits are all set (0x7fffffff,
    the NaN the card's arithmetic gives, or its negation) into the sign or
    out of the word and so rounds it to a zero; 0x7fc00000 stays a NaN.
    Every other value keeps its bits."""
    return flat.masked_fill_(flat.isnan(), float("nan"))


def kernel_weights_t(kernel_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The forward kernels' copy of the product weights in
    :func:`weights_t_layout`: each transposed (out x in), w0 and w5i with
    zero columns that pad in from the encoded width to :func:`pos_pad`,
    packed in order into one flat contiguous fp32 buffer on the weights'
    device, detached, every NaN made TF32-safe (:func:`tf32_safe_nan_`). The
    kernels take it beside the flax-layout ``kernel_params``; it is rebuilt
    at every launch, since the weights move every training step."""
    first = kernel_params["w0"]
    flat = torch.zeros(wt_floats(first.shape[0]), dtype=first.dtype, device=first.device)
    for name, view in unpack_weights_t(flat).items():
        w = kernel_params[name].detach()
        view[:, : w.shape[0]].copy_(w.t())
    return tf32_safe_nan_(flat)


def kernel_weights_t_bf16(kernel_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The bf16 mode's copy of :func:`kernel_weights_t`: each weight rounded
    to bf16 (to nearest, ties to even) as it is transposed into a
    ``torch.bfloat16`` buffer, one pass a weight, then every 32-column block
    of a row put in ``BF16_SLICE_ORDER`` (one gather); detached. Undone, its
    values are ``kernel_weights_t(bf16_params(kernel_params))``'s."""
    first = kernel_params["w0"]
    flat = torch.zeros(wt_floats(first.shape[0]), dtype=torch.bfloat16, device=first.device)
    for name, view in unpack_weights_t(flat).items():
        w = kernel_params[name].detach()
        view[:, : w.shape[0]].copy_(w.t())
    return flat.view(-1, 32).index_select(1, slice_order(first.device)).view(-1)


@functools.lru_cache(maxsize=None)
def slice_order(device: torch.device) -> torch.Tensor:
    """``BF16_SLICE_ORDER`` as an index tensor on ``device``, for the bf16
    packs' gathers."""
    return torch.tensor(BF16_SLICE_ORDER, dtype=torch.long, device=device)


def choose_ray_tile(R: int, S: int, n_sms: int, smem_bytes: Callable[[int, int], int], max_smem: int) -> int:
    """The ray tile of a kernel that walks its block's rays in chunks (K1,
    K1s, and K2's B1 in bf16 mode) for R rays of S samples on a card of n_sms
    SMs whose blocks may have max_smem bytes of shared memory, where
    smem_bytes(S, T) is a block's of T rays: of the tiles T <= RAY_TILE that
    divide R and fit, the one with the fewest waves x chunks a block,
    ceil(R / T / n_sms) x ceil(T S / CHUNK_ROWS) (one block a SM: its shared
    memory and registers allow no second), ties to the larger T. On the
    H100, 16 at 2048 and 4096 rays (S = 65, 193), 2 at 224 and 256, 15 at
    3840. A row's outputs do not depend on the tile (B1's per-block head
    sums do)."""
    best = None
    for T in range(1, min(RAY_TILE, R) + 1):
        if R % T or smem_bytes(S, T) > max_smem:
            continue
        cost = -(-R // T // n_sms) * -(-(T * S) // CHUNK_ROWS)
        if best is None or cost <= best[0]:
            best = (cost, T)
    if best is None:
        raise ValueError(f"no ray tile fits {R} rays of {S} samples in a block's shared memory")
    return best[1]


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    """Card ``index``'s SMs and the shared memory a block may have (opt-in),
    as the card reports them."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def launch_ray_tile(R: int, S: int, ray_tile: Optional[int], device: torch.device,
                    smem_bytes: Optional[Callable[[int, int], int]] = None) -> Optional[int]:
    """``ray_tile`` once checked to divide R. Where it is None: on a CUDA
    device the tile :func:`choose_ray_tile` picks for that card, smem_bytes
    being the library's count of the launch's block's shared memory (asked
    once a shape); on the CPU None, since the plain versions take no tile."""
    if ray_tile is None and device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        key = (R, S, index, id(smem_bytes))
        chosen = _chosen_tiles.get(key)
        if chosen is None or chosen[0] is not smem_bytes:
            n_sms, max_smem = _card(index)
            chosen = _chosen_tiles[key] = (smem_bytes, choose_ray_tile(R, S, n_sms, smem_bytes, max_smem))
        ray_tile = chosen[1]
    if ray_tile is not None and (ray_tile <= 0 or R % ray_tile != 0):
        raise ValueError(f"rays {R} not a multiple of ray_tile {ray_tile}")
    return ray_tile


def fwd_operands(kernel_params: Dict[str, torch.Tensor], dot_bf16: bool):
    """What the forward kernels take beside the inputs: the 26 weights (in
    bf16 mode with the narrow heads of FWD_HEADS rounded to bf16) and the
    packed product weights, :func:`kernel_weights_t` or in bf16 mode
    :func:`kernel_weights_t_bf16`."""
    if not dot_bf16:
        return kernel_params, kernel_weights_t(kernel_params)
    heads = {n: round_bf16(kernel_params[n].detach()) for n in FWD_HEADS}
    return {**kernel_params, **heads}, kernel_weights_t_bf16(kernel_params)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to its dtype;
    an fp64 x rounds through fp32."""
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_params(kernel_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernels' weights in bf16 mode: every weight rounded to bf16 (still
    fp32 tensors, detached), every bias as it is; the values the bf16 packs
    (:func:`kernel_weights_t_bf16`, ``fused_train.b1_weights_bf16``) hold,
    which the tests hold them to."""
    return {n: round_bf16(v.detach()) if n.startswith("w") else v for n, v in kernel_params.items()}


def bf16_products(mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """``mm`` on both operands rounded to bf16: a product of the TPU kernel's
    ``dot_bf16`` mode."""
    return lambda a, b: mm(round_bf16(a), round_bf16(b))


def unpack_weights_t(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of :func:`kernel_weights_t`'s buffer: name -> (out, in padded);
    the padded encoded width is the one the buffer's size gives."""
    views, n = {}, 0
    pad = (flat.numel() - wt_floats(0)) // (2 * WIDTH)
    if pad % 32 or wt_floats(pad) != flat.numel():
        raise ValueError(f"{flat.numel()} elements: no packed layout of the forward's weights")
    for name, rows, cols in weights_t_layout(pad):
        views[name] = flat[n : n + rows * cols].view(rows, cols)
        n += rows * cols
    return views


def level_activations_ref(
    kernel_params: Dict[str, torch.Tensor],
    viewdirs_enc: torch.Tensor,
    xe: torch.Tensor,
    S: int,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
    dot_bf16: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The level's MLP on the R*S encoded samples ``xe`` (rows, P): the ten
    activations in the order the training forward saves them (h0..h7, the
    bottleneck, the view hidden layer), raw sigma (rows, 1) and raw rgb
    (rows, 3).

    ``mm`` computes the products that the CUDA kernels run on the tensor
    cores (every one in ``WEIGHTS_T``); tests pass an emulation of their
    3xTF32 arithmetic. The default is plain ``@``. With ``dot_bf16`` every
    product, these and the heads', rounds its operands to bf16 first, and
    the activations come back rounded, as the TPU kernel's backward keeps
    them and the CUDA training forward saves them."""
    w = kernel_params
    R = viewdirs_enc.shape[0]
    relu = torch.relu
    dot, keep = torch.matmul, (lambda a: a)
    if dot_bf16:
        mm, dot, keep = bf16_products(mm), bf16_products(torch.matmul), round_bf16

    hs = [keep(relu(mm(xe, w["w0"]) + w["b0"]))]
    for i in (1, 2, 3, 4):
        hs.append(keep(relu(mm(hs[-1], w[f"w{i}"]) + w[f"b{i}"])))
    hs.append(keep(relu(mm(hs[-1], w["w5x"]) + mm(xe, w["w5i"]) + w["b5"])))
    for i in (6, 7):
        hs.append(keep(relu(mm(hs[-1], w[f"w{i}"]) + w[f"b{i}"])))

    raw_sigma = dot(hs[7], w["wd"]) + w["bd"]  # (rows, 1)
    bottleneck = keep(mm(hs[7], w["wb"]) + w["bb"])
    c_part = dot(viewdirs_enc, w["wvb"])  # (R, 128), once per ray
    c_rows = c_part[:, None, :].expand(R, S, c_part.shape[-1]).reshape(R * S, -1)
    v = keep(relu(mm(bottleneck, w["wva"]) + c_rows + w["bv"]))
    raw_rgb = dot(v, w["wr"]) + w["br"]  # (rows, 3)
    return hs + [bottleneck, v], raw_sigma, raw_rgb


def integrate_ref(
    raw_sigma: torch.Tensor, raw_rgb: torch.Tensor, t_vals: torch.Tensor, rays_d: torch.Tensor, white_bkgd: bool,
    dot_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The level's integrator: (comp (R,3), acc (R,), depth (R,), weights
    (R,S)) from raw sigma (R*S, 1) and raw rgb (R*S, 3). With ``dot_bf16``
    the log terms are rounded to bf16 before their exclusive sum, as the TPU
    kernel's triangular product rounds them."""
    R, S = t_vals.shape
    dnorm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True))
    dists = torch.cat([t_vals[:, 1:] - t_vals[:, :-1], torch.full_like(t_vals[:, :1], 1e10)], -1)
    dists = dists * dnorm
    sigma = torch.relu(raw_sigma.reshape(R, S))
    alpha = 1.0 - torch.exp(-sigma * dists)
    logv = torch.log(torch.clamp(1.0 - alpha + 1e-10, min=1e-10))
    if dot_bf16:
        logv = round_bf16(logv)
    excl = torch.cat([torch.zeros_like(logv[:, :1]), torch.cumsum(logv[:, :-1], dim=-1)], -1)
    weights = alpha * torch.exp(excl)

    rgb = torch.sigmoid(raw_rgb).reshape(R, S, 3)
    comp = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * t_vals, dim=-1)
    if white_bkgd:
        comp = comp + (1.0 - acc[..., None])
    return comp, acc, depth, weights


def fused_render_level_ref(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
    dot_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused level. Same arguments and outputs as
    :func:`fused_render_level`, on any device; ``mm`` as in
    :func:`level_activations_ref`."""
    R, S = t_vals.shape
    _, raw_sigma, raw_rgb = level_activations_ref(
        kernel_params, viewdirs_enc, samples_enc.reshape(R * S, -1), S, mm=mm, dot_bf16=dot_bf16
    )
    return integrate_ref(raw_sigma, raw_rgb, t_vals, rays_d, white_bkgd, dot_bf16=dot_bf16)


def _check_inputs(kernel_params, t_vals, rays_d, viewdirs_enc, xenc, R, S):
    """Raises unless every input and weight has the shape the weights'
    encoded widths (:func:`widths`) give, fp32 on t_vals' device,
    contiguous and 16-byte aligned."""
    pos_dim, view_dim = widths(kernel_params)
    if pos_dim < 1 or view_dim < 1:
        raise ValueError(f"encoded widths {pos_dim} / {view_dim}: the kernels take at least one feature each")
    expect = {
        "t_vals": (t_vals, (R, S)),
        "rays_d": (rays_d, (R, 3)),
        "viewdirs_enc": (viewdirs_enc, (R, view_dim)),
        "samples_enc": (xenc, (R * S, pos_dim)),
    }
    shapes = {
        "w0": (pos_dim, WIDTH), "w5x": (WIDTH, WIDTH), "w5i": (pos_dim, WIDTH),
        "wd": (WIDTH, 1), "bd": (1, 1), "wb": (WIDTH, WIDTH), "bb": (1, WIDTH),
        "wva": (WIDTH, COND_WIDTH), "wvb": (view_dim, COND_WIDTH), "bv": (1, COND_WIDTH),
        "wr": (COND_WIDTH, 3), "br": (1, 3),
    }
    for i in (1, 2, 3, 4, 6, 7):
        shapes[f"w{i}"] = (WIDTH, WIDTH)
    for i in range(8):
        shapes[f"b{i}"] = (1, WIDTH)
    for n in WEIGHT_NAMES:
        expect[n] = (kernel_params[n], shapes[n])
    device = t_vals.device
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected float32 on {device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def check_launch(fn_name: str, err: int) -> None:
    """Raises unless a launcher returned 0."""
    if err >= MAP_ERROR:
        raise RuntimeError(
            f"{fn_name}: CUDA launch failed: a weight tensor map was refused (CUresult {err - MAP_ERROR})"
        )
    if err != 0:  # e.g. ray_tile x S needs more shared memory than a block has
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")


def check_forward_layout(lib, prefix: str, lib_name: str, pos_dim: int, view_dim: int,
                         smem: str = "smem_bytes") -> None:
    """Raises unless the library was built for these encoded widths
    (``<prefix>_pos_dim()``, ``_view_dim()``), its packed transposed
    weights (``_wt_floats()`` floats) are ``kernel_weights_t``'s and their
    bf16 pack (``_wt_bf16_bytes()`` bytes) is ``kernel_weights_t_bf16``'s,
    and its forward block's shared memory (``<prefix>_<smem>(S, ray_tile)``,
    declared for the tile rule) is :func:`forward_smem_bytes`'s."""
    fns = {n: getattr(lib, f"{prefix}_{n}") for n in ("pos_dim", "view_dim", "wt_floats", "wt_bf16_bytes")}
    for f in fns.values():
        f.argtypes, f.restype = [], ctypes.c_int
    smem_fn = getattr(lib, f"{prefix}_{smem}")
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    if (fns["pos_dim"](), fns["view_dim"]()) != (pos_dim, view_dim):
        raise RuntimeError(f"{lib_name}: library built for widths {fns['pos_dim']()} / {fns['view_dim']()}, "
                           f"expected {pos_dim} / {view_dim}")
    n = wt_floats(pos_dim)
    if fns["wt_floats"]() != n:
        raise RuntimeError(f"{lib_name}: kernel packs {fns['wt_floats']()} transposed weight floats, expected {n}")
    if fns["wt_bf16_bytes"]() != 2 * n:
        raise RuntimeError(f"{lib_name}: kernel's bf16 pack is {fns['wt_bf16_bytes']()} bytes, expected {2 * n}")
    for S, tile in ((193, 16), (65, 2)):
        if smem_fn(S, tile) != forward_smem_bytes(S, tile, pos_dim):
            raise RuntimeError(f"{lib_name}: forward block of {tile} rays x {S} samples takes {smem_fn(S, tile)} "
                               f"bytes of shared memory, expected {forward_smem_bytes(S, tile, pos_dim)}")


# The loaded library of each pair of encoded widths.
_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}


def _library(pos_dim: int = POS_DIM, view_dim: int = VIEW_DIM):
    """K1's library for these encoded widths, built at first use."""
    lib = _libs.get((pos_dim, view_dim))
    if lib is None:
        lib = build.load("fused_render", build.width_defines(pos_dim, view_dim))
        fn = lib.aonerf_fused_render_level
        fn.argtypes = [ctypes.c_void_p] * (4 + len(WEIGHT_NAMES) + 1 + 4) + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        check_forward_layout(lib, "aonerf_fused_render", "fused_render", pos_dim, view_dim)
        lib = _libs[(pos_dim, view_dim)] = lib
    return lib


def fused_render_level(
    kernel_params: Dict[str, torch.Tensor],
    t_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs_enc: torch.Tensor,
    samples_enc: torch.Tensor,
    white_bkgd: bool,
    ray_tile: Optional[int] = None,
    dot_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render one hierarchy level for R rays (R % ray_tile == 0).

    t_vals (R, S); rays_o/rays_d (R, 3); viewdirs_enc (R, V);
    samples_enc (R, S, P) or (R*S, P); weights from :func:`kernel_params`,
    whose w0 (P, 256) and wvb (V, 128) give the encoded widths.
    Returns (comp_rgb (R,3), acc (R,), depth (R,), weights (R,S)).

    On CUDA tensors this builds :func:`kernel_weights_t` and launches the
    kernel, one block per ``ray_tile`` rays (None: the tile of
    :func:`choose_ray_tile`, recorded in ``launch_tiles``; the outputs do not
    depend on it), which streams the product weights from that copy through
    TMA maps encoded for this launch; ``rays_o`` is not read there, as in the
    TPU kernel. With ``dot_bf16`` it launches the kernel's bf16 mode on
    :func:`kernel_weights_t_bf16` and the narrow heads rounded to bf16
    (:func:`fwd_operands`). On CPU tensors it runs the plain version.
    """
    global launches, bf16_launches
    R, S = t_vals.shape
    if t_vals.device.type == "cpu":
        launch_ray_tile(R, S, ray_tile, t_vals.device)
        return fused_render_level_ref(
            kernel_params, t_vals, rays_o, rays_d, viewdirs_enc, samples_enc, white_bkgd, dot_bf16=dot_bf16
        )
    if t_vals.device.type != "cuda":
        raise ValueError(f"fused_render_level runs on cuda or cpu, not {t_vals.device}")

    xenc = samples_enc.reshape(R * S, samples_enc.shape[-1])
    _check_inputs(kernel_params, t_vals, rays_d, viewdirs_enc, xenc, R, S)
    lib = _library(*widths(kernel_params))
    ray_tile = launch_ray_tile(R, S, ray_tile, t_vals.device, lib.aonerf_fused_render_smem_bytes)
    kernel_params, wt = fwd_operands(kernel_params, dot_bf16)
    comp = torch.empty((R, 3), dtype=torch.float32, device=t_vals.device)
    acc = torch.empty((R,), dtype=torch.float32, device=t_vals.device)
    depth = torch.empty((R,), dtype=torch.float32, device=t_vals.device)
    weights = torch.empty((R, S), dtype=torch.float32, device=t_vals.device)
    with torch.cuda.device(t_vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.aonerf_fused_render_level(
            t_vals.data_ptr(), rays_d.data_ptr(), viewdirs_enc.data_ptr(), xenc.data_ptr(),
            *[kernel_params[n].data_ptr() for n in WEIGHT_NAMES], wt.data_ptr(),
            comp.data_ptr(), acc.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            R, S, ray_tile, int(white_bkgd), int(dot_bf16), stream,
        )
    check_launch("fused_render_level", err)
    launch_tiles[(R, S, dot_bf16)] = ray_tile
    if dot_bf16:
        bf16_launches += 1
    else:
        launches += 1
    return comp, acc, depth, weights
