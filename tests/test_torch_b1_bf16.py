"""K2's B1 in bf16 mode, its host side on the CPU: the bf16 pack of B1's
product weights that the kernel streams (``b1_weights_bf16``), what else the
backward takes in bf16 mode (``bwd_operands``), the ray tile K2 takes in
bf16 mode (``choose_ray_tile`` over B1's shared memory) and in fp32 (16),
and that the plain backward gives the same gradients whatever tile the
caller names (the CUDA kernel is held to the bf16 rule at the chosen tile
and at 16 on the card: tests/test_torch_gpu.py, chip_smoke.py phase 13)."""

import numpy as np
import pytest
import torch

from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from tests.test_torch_bf16_fwd_walk import H100_SMEM, H100_SMS, _cpu_level, _weights

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_b1_pack_is_the_rounded_flax_weights(seed, ties):
    kp = _weights(seed, ties)
    pack = ft.b1_weights_bf16(kp)
    assert pack.dtype == torch.bfloat16 and pack.shape == (ft.B1_PACK_ELEMS,) and pack.is_contiguous()
    inverse = torch.argsort(torch.tensor(fr.BF16_SLICE_ORDER))
    unpacked = pack.view(-1, 32)[:, inverse].reshape(-1).float()  # each 32-column block of a row in column order
    want = fr.bf16_params(kp)
    n = 0
    for name in ft.B1_WEIGHTS:  # wva, wb, w7 .. w1, each in its flax (in, out) layout
        w = want[name]
        got = unpacked[n: n + w.numel()].view(w.shape)
        assert torch.equal(got.view(torch.int32), w.view(torch.int32)), name  # bit for bit, ties to even
        n += w.numel()
    assert n == ft.B1_PACK_ELEMS == fr.WIDTH * fr.COND_WIDTH + 8 * fr.WIDTH * fr.WIDTH
    if ties:  # the ties are there, and rounding them away from zero would give other bits
        flat = torch.cat([kp[name].reshape(-1) for name in ft.B1_WEIGHTS])
        away = ((flat.view(torch.int32) + 0x8000) & -0x10000).view(torch.float32)
        assert not torch.equal(away, unpacked)


@pytest.mark.parametrize("dot_bf16", [False, True])
def test_bwd_operands_round_only_the_heads_b1_reads(dot_bf16):
    kp = _weights(3)
    params, pack = ft.bwd_operands(kp, dot_bf16)
    for n in fr.WEIGHT_NAMES:
        if dot_bf16 and n in ft.B1_HEADS:
            assert torch.equal(params[n], fr.round_bf16(kp[n])) and not torch.equal(params[n], kp[n]), n
        elif not dot_bf16 and n in ft.B1_WEIGHTS:  # fp32 B1's TF32-safe copies: the same bits
            assert params[n] is not kp[n] and params[n].is_contiguous(), n
            assert torch.equal(params[n].view(torch.int32), kp[n].view(torch.int32)), n
            assert params[n].data_ptr() % 16 == 0, n  # a TMA map's base
        else:
            assert params[n] is kp[n], n
    if dot_bf16:
        assert torch.equal(pack.view(torch.int16), ft.b1_weights_bf16(kp).view(torch.int16))
    else:
        assert pack is None


# B1's shared memory as the library counts it (csrc/fused_train.cu's
# delta_smem_bytes: the 83,072-byte weight ring, D and H of 64 x 260 floats,
# per-row g_raw, and 128 floats a ray; 225,408 bytes at 16 rays, at every S);
# on the card the wrapper reads it from the library and the SMs and the
# block's limit from the card, and the gpu tests hold the tiles it chooses.
def _b1_smem(S, T):
    return 217216 + 512 * T


def _rule(R, S, n_sms=H100_SMS):
    return fr.choose_ray_tile(R, S, n_sms, _b1_smem, H100_SMEM)


def test_b1_block_shared_memory():
    assert _b1_smem(193, 16) == 225408 <= H100_SMEM
    assert _b1_smem(100000, 16) == _b1_smem(7, 16)  # B1's block does not grow with S


@pytest.mark.parametrize("R,S,want", [
    (224, 65, 2), (224, 193, 2),  # the fast preset: 112 blocks of 3 / 7 chunks, where 16 rays give 14 of 17 / 49
    (2048, 65, 16), (2048, 193, 16),  # batch 2048: 128 blocks, one wave
])
def test_bwd_tile_rule_at_the_paths_shapes(R, S, want):
    T = _rule(R, S)
    assert T == want and R % T == 0 and _b1_smem(S, T) <= H100_SMEM
    waves, chunks = -(-(R // T) // H100_SMS), -(-(T * S) // fr.CHUNK_ROWS)
    for other in range(1, fr.RAY_TILE + 1):  # no tile that divides R takes fewer waves x chunks
        if R % other == 0:
            assert waves * chunks <= -(-(R // other) // H100_SMS) * -(-(other * S) // fr.CHUNK_ROWS), other


@pytest.mark.parametrize("S", [7, 65, 193])
def test_bwd_tile_rule_divides_fits_and_minimises(S):
    for R in [*range(1, 260), 448, 2048, 3840]:
        T = _rule(R, S)
        fits = [t for t in range(1, fr.RAY_TILE + 1) if R % t == 0 and _b1_smem(S, t) <= H100_SMEM]
        cost = {t: -(-(R // t) // H100_SMS) * -(-(t * S) // fr.CHUNK_ROWS) for t in fits}
        assert T == max(t for t in fits if cost[t] == min(cost.values())), (R, S, T)


class _UnhashableCount:
    """A block's shared memory as the library counts it, callable as the
    wrappers call the library's ctypes function, and, like it, unhashable."""

    __hash__ = None

    def __init__(self):
        self.calls = 0

    def __call__(self, S, T):
        self.calls += 1
        return _b1_smem(S, T)


def test_launch_tile_asks_the_library_once_a_shape(monkeypatch):
    monkeypatch.setattr(fr, "_card", lambda index: (H100_SMS, H100_SMEM))  # the H100's figures, no card asked
    monkeypatch.setattr(fr, "_chosen_tiles", {})
    count, other = _UnhashableCount(), _UnhashableCount()
    card = torch.device("cuda", 0)
    assert fr.launch_ray_tile(224, 65, None, card, count) == 2
    asked = count.calls
    assert asked > 0 and [fr.launch_ray_tile(224, 65, None, card, count) for _ in range(2)] == [2, 2]
    assert count.calls == asked  # the shape was seen: the library is not asked again
    assert fr.launch_ray_tile(2048, 65, None, card, count) == 16 and count.calls > asked  # a new shape is
    calls = count.calls
    assert [fr.launch_ray_tile(R, 65, None, card, count) for R in (224, 2048)] == [2, 16] and count.calls == calls
    assert fr.launch_ray_tile(224, 65, None, card, other) == 2 and other.calls > 0  # another block's count: asked
    assert fr.launch_ray_tile(224, 65, 7, card, count) == 7 and count.calls == calls  # a named tile asks nothing
    with pytest.raises(ValueError, match="ray_tile"):
        fr.launch_ray_tile(224, 65, 3, card, count)


@pytest.mark.parametrize("dot_bf16", [False, True])
def test_plain_backward_gives_the_same_gradients_for_any_tile(dot_bf16):
    R, S = 8, 9
    kp, args = _cpu_level(R, S, 7)
    rng = np.random.default_rng(8)
    cot = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, 3)), rng.standard_normal(R), 0.1 * rng.standard_normal(R), rng.standard_normal((R, S))))
    with torch.no_grad():
        *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=dot_bf16)
        tiles = (None, 1, 2, 4, 8) if dot_bf16 else (1, 2, 4, 8)  # fp32 names its tile: 8 rays are no 16
        split = [ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, ray_tile=T, dot_bf16=dot_bf16)
                 for T in tiles]
        whole = [ft.fused_level_bwd(kp, *args, *cot, True, ray_tile=T, dot_bf16=dot_bf16) for T in tiles]
    for got in split[1:] + whole:
        assert all(torch.equal(got[n], split[0][n]) for n in fr.WEIGHT_NAMES)


def test_bwd_default_tile_is_16_in_fp32_and_chosen_in_bf16():
    R, S = 8, 9  # a batch of no multiple of 16
    kp, args = _cpu_level(R, S, 9)
    cot = (torch.zeros(R, 3), torch.zeros(R), torch.zeros(R), torch.zeros(R, S))
    with torch.no_grad():
        *_, saved, raw = ft.fused_level_fwd_spill(kp, *args, True, dot_bf16=True)
        with pytest.raises(ValueError, match="ray_tile 16"):  # fp32 K2 keeps 16 rays a block
            ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True)
        with pytest.raises(ValueError, match="ray_tile 16"):
            ft.fused_level_bwd(kp, *args, *cot, True)
        with pytest.raises(ValueError, match="ray_tile 3"):  # a tile the caller names is checked in either mode
            ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, ray_tile=3, dot_bf16=True)
        got = ft.fused_level_bwd_saved(kp, *args, saved, raw, *cot, True, dot_bf16=True)  # bf16: any batch
    assert all(torch.isfinite(got[n]).all() for n in fr.WEIGHT_NAMES)
    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in kp.items()}
    comp, acc, depth, weights = ft.fused_level(leaves, *args, True, dot_bf16=True)
    (comp.sum() + acc.sum() + depth.sum() + weights.sum()).backward()  # the fast preset's path, any batch
    assert all(torch.isfinite(leaves[n].grad).all() for n in fr.WEIGHT_NAMES)
