"""The bf16 forward walk's host side on the CPU: the bf16 pack of the
forward's product weights that K1 and K1s stream in bf16 mode, the ray tile
the forward wrappers choose per launch, and that the plain versions give the
same outputs whatever the tile (the CUDA kernels are held to that on the
card: tests/test_torch_gpu.py, chip_smoke.py phases 3, 5 and 13); and the
plain bf16 forward at the chosen tile against aonerf's Pallas kernel with
dot_bf16=True in interpret mode at the fast preset's tile of 2 rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops.kernels import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from tests.test_torch_bf16_kernels import BF16_TOL, OUTPUTS, _errors, _inputs
from tests.test_torch_kernels import _setup

torch.set_num_threads(1)

_SHAPES = {"w0": (63, 256), "w5x": (256, 256), "w5i": (63, 256), "wd": (256, 1), "wb": (256, 256),
           "wva": (256, 128), "wvb": (27, 128), "wr": (128, 3), "bd": (1, 1), "bb": (1, 256), "bv": (1, 128),
           "br": (1, 3), **{f"w{i}": (256, 256) for i in (1, 2, 3, 4, 6, 7)}, **{f"b{i}": (1, 256) for i in range(8)}}


def _weights(seed: int, ties: bool = False):
    """The 26 kernel weights from numpy; with ``ties``, every fourth weight
    moved exactly halfway between two bf16 values."""
    rng = np.random.default_rng(seed)
    kp = {n: torch.from_numpy((0.1 * rng.standard_normal(_SHAPES[n])).astype(np.float32)) for n in fr.WEIGHT_NAMES}
    if ties:
        for n, v in kp.items():
            halfway = (fr.round_bf16(v).view(torch.int32) + 0x8000).view(torch.float32)
            v.view(-1)[::4] = halfway.view(-1)[::4]
    return kp


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_bf16_pack_is_the_rounded_transposed_copy(seed, ties):
    kp = _weights(seed, ties)
    pack = fr.kernel_weights_t_bf16(kp)
    assert pack.dtype == torch.bfloat16 and pack.shape == (fr.WT_FLOATS,) and pack.is_contiguous()
    assert sorted(fr.BF16_SLICE_ORDER) == list(range(32))
    inverse = torch.argsort(torch.tensor(fr.BF16_SLICE_ORDER))
    unpacked = pack.view(-1, 32)[:, inverse].reshape(-1)  # each 32-column block of a row in column order
    want = fr.kernel_weights_t(fr.bf16_params(kp))
    assert torch.equal(unpacked.float().view(torch.int32), want.view(torch.int32))  # bit for bit, ties to even
    views = fr.unpack_weights_t(unpacked)
    assert not views["w0"][:, 63].any() and not views["w5i"][:, 63].any()
    assert torch.equal(views["wva"].float(), fr.round_bf16(kp["wva"].t()))


@pytest.mark.parametrize("dot_bf16", [False, True])
def test_fwd_operands_round_only_the_narrow_heads(dot_bf16):
    kp = _weights(3)
    params, wt = fr.fwd_operands(kp, dot_bf16)
    for n in fr.WEIGHT_NAMES:
        if dot_bf16 and n in fr.FWD_HEADS:
            assert torch.equal(params[n], fr.round_bf16(kp[n])) and not torch.equal(params[n], kp[n]), n
        else:
            assert params[n] is kp[n], n
    want = fr.kernel_weights_t_bf16(kp) if dot_bf16 else fr.kernel_weights_t(kp)
    assert wt.dtype == want.dtype and torch.equal(wt, want)


# The H100's SMs and the shared memory a block may have there, and a forward
# block's shared memory as the library counts it (csrc/nerf_level.cuh's
# forward_smem_bytes: 224,640 bytes at 16 rays, S = 193); on the card the
# wrappers read all three from the card and the library, and the gpu tests
# hold the tiles they choose (tests/test_torch_gpu.py).
H100_SMS, H100_SMEM = 132, 232448


def _h100_smem(S, T):
    return 167040 + 512 * T + 16 * T * S


def _rule(R, S, n_sms=H100_SMS):
    return fr.choose_ray_tile(R, S, n_sms, _h100_smem, H100_SMEM)


def test_forward_block_shared_memory():
    assert _h100_smem(193, 16) == 224640 <= H100_SMEM < _h100_smem(257, 16)
    assert _rule(4096, 193) == 16  # the largest tile fits at S = 193 ...
    assert _rule(4096, 257) == 8  # ... and not at S = 257, where the rule takes the next


@pytest.mark.parametrize("R,S,want", [
    (2048, 65, 16), (2048, 193, 16), (4096, 65, 16), (4096, 193, 16),  # the fp32 paths keep 16
    (224, 65, 2), (224, 193, 2), (256, 65, 2), (256, 193, 2),  # the fast preset: 112 / 128 blocks
    (3840, 65, 15), (3840, 193, 15),  # the test path's chunk: 256 blocks
])
def test_tile_rule_at_the_paths_shapes(R, S, want):
    assert _rule(R, S) == want


def _brute_force(R, S, n_sms):
    fits = [T for T in range(1, 17) if R % T == 0 and _h100_smem(S, T) <= H100_SMEM]
    cost = {T: -(-(R // T) // n_sms) * -(-(T * S) // fr.CHUNK_ROWS) for T in fits}
    least = min(cost.values())
    return max(T for T in fits if cost[T] == least)


@pytest.mark.parametrize("S", [1, 7, 65, 129, 193, 257, 400])
def test_tile_rule_divides_fits_and_minimises(S):
    for R in [*range(1, 300), 448, 1024, 2000, 2112, 3840, 4096, 4100]:
        for n_sms in (132, 114):
            T = _rule(R, S, n_sms)
            assert 1 <= T <= fr.RAY_TILE and R % T == 0, (R, S, T)
            assert _h100_smem(S, T) <= H100_SMEM, (R, S, T)
            assert T == _brute_force(R, S, n_sms), (R, S, n_sms, T)


def test_tile_rule_refuses_what_fits_no_block():
    with pytest.raises(ValueError, match="no ray tile"):
        _rule(16, 20000)
    with pytest.raises(ValueError, match="ray_tile"):
        fr.launch_ray_tile(18, 65, 4, torch.device("cpu"))
    assert fr.launch_ray_tile(18, 65, 6, torch.device("cpu")) == 6
    assert fr.launch_ray_tile(18, 65, None, torch.device("cpu")) is None  # the plain versions take no tile


def _cpu_level(R, S, seed):
    params, t, o, d, venc, xenc = _setup(R=R, S=S, seed=seed)
    return _inputs(params, t, o, d, venc, xenc)


@pytest.mark.parametrize("dot_bf16", [False, True])
def test_plain_versions_give_the_same_outputs_for_any_tile(dot_bf16):
    R, S = 8, 9
    kp, args = _cpu_level(R, S, 4)
    with torch.no_grad():
        k1 = [fr.fused_render_level(kp, *args, True, ray_tile=T, dot_bf16=dot_bf16) for T in (None, 1, 2, 4, 8)]
        k1s = [ft.fused_level_fwd_spill(kp, *args, True, ray_tile=T, dot_bf16=dot_bf16) for T in (None, 1, 2, 4, 8)]
    for outs in k1[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs, k1[0]))
    for outs in k1s[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs, k1s[0]))
    assert all(torch.equal(a, b) for a, b in zip(k1s[0][:4], k1[0]))  # K1s' outputs are K1's


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_bf16_ref_at_the_chosen_tile_matches_pallas_at_the_presets_tile(white_bkgd):
    R, S = 8, 9
    params, t, o, d, venc, xenc = _setup(R=R, S=S, seed=5)
    want = jax_fused_render_level(
        mlp_params_from_flax(params), jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(venc), jnp.asarray(xenc), white_bkgd, ray_tile=2, interpret=True, dot_bf16=True,
    )
    kp, args = _inputs(params, t, o, d, venc, xenc)
    with torch.no_grad():
        got = fr.fused_render_level(kp, *args, white_bkgd, dot_bf16=True)
    for name, g, w in zip(OUTPUTS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
    errs = _errors(got, want)
    assert all(errs[n] <= BF16_TOL[n] for n in OUTPUTS), errs


def test_fused_level_runs_the_forward_at_any_batch_and_the_backward_at_its_tile():
    R, S = 8, 9
    kp, args = _cpu_level(R, S, 6)
    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in kp.items()}
    comp, acc, depth, weights = ft.fused_level(leaves, *args, True, ray_tile=4, dot_bf16=True)
    (comp.sum() + acc.sum() + depth.sum() + weights.sum()).backward()
    assert all(torch.isfinite(leaves[n].grad).all() for n in fr.WEIGHT_NAMES)
    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in kp.items()}
    comp = ft.fused_level(leaves, *args, True)[0]  # the forward takes any batch
    with pytest.raises(ValueError, match="ray_tile"):  # K2 keeps its tile: 8 rays are no multiple of 16
        comp.sum().backward()
