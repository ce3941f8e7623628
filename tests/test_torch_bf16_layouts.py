"""The bf16 mode's scratch layouts on the CPU: the plain bf16 forward saves its
activations as ``torch.bfloat16`` (the values the fp32 layout held), the
plain backward from them equals the backward from their fp32 widening, and
the port's plain bf16 K2 from a bf16 ``saved`` is held to aonerf's Pallas
backward with dot_bf16=True in interpret mode. On the card K1s writes that
bf16 ``saved``, B1 a bf16 delta scratch and B2 reads both (tests/test_torch_gpu.py,
chip_smoke.py phase 13)."""

import numpy as np
import pytest
import torch

from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from tests.test_torch_bf16_backward import K2_TOL, TILE, _jax_bwd, _pallas_kept, _rel_errors
from tests.test_torch_fused_train import _level, _torch_kp

torch.set_num_threads(1)

R = 8  # two ray tiles of TILE rays


def _args(S, seed):
    params, inputs, cot = _level(R, S, seed=seed)
    return params, (_torch_kp(params), *map(torch.from_numpy, inputs)), tuple(map(torch.from_numpy, cot))


@pytest.mark.parametrize("S", [9, 65])
def test_plain_bf16_forward_saves_bf16_values(S):
    _, args, _ = _args(S, S)
    saved = ft.fused_level_fwd_spill(*args, True, ray_tile=TILE, dot_bf16=True)[4]
    assert saved.dtype == torch.bfloat16 == ft.saved_dtype(True) and saved.shape == (R * S, ft.SAVED_FLOATS)
    kp, t, o, d, venc, xenc = args
    acts, _, _ = fr.level_activations_ref(kp, venc, xenc.reshape(R * S, -1), S, dot_bf16=True)
    want = torch.cat(acts, -1)
    assert want.dtype == torch.float32
    assert torch.equal(saved.float().view(torch.int32), want.view(torch.int32))  # every bit of every value
    fp32 = ft.fused_level_fwd_spill(*args, True, ray_tile=TILE)[4]
    assert fp32.dtype == torch.float32 == ft.saved_dtype(False)  # fp32 mode keeps its layout


@pytest.mark.parametrize("S", [9, 65])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_plain_backward_from_bf16_saved_equals_its_fp32_widening(S, white_bkgd):
    _, args, cot = _args(S, S + 1)
    *_, saved, raw = ft.fused_level_fwd_spill(*args, white_bkgd, ray_tile=TILE, dot_bf16=True)
    got = ft.fused_level_bwd_saved(*args, saved, raw, *cot, white_bkgd, ray_tile=TILE, dot_bf16=True)
    wide = ft.fused_level_bwd_saved_ref(*args, saved.float(), raw, *cot, white_bkgd, dot_bf16=True)
    for name in fr.WEIGHT_NAMES:
        assert got[name].dtype == torch.float32 and torch.equal(got[name], wide[name]), name
    whole = ft.fused_level_bwd(*args, *cot, white_bkgd, ray_tile=TILE, dot_bf16=True)
    assert all(torch.equal(whole[n], got[n]) for n in fr.WEIGHT_NAMES)  # the composition saves bf16 too


# The port's plain bf16 K2 from the Pallas body's kept activations, given as
# the bf16 saved the card's K1s writes (exact: they are bf16 values), held
# to the Pallas backward with dot_bf16=True in interpret mode within
# K2_TOL, the tolerance of tests/test_torch_bf16_backward.py's
# test_k2_from_kept_matches_pallas_interpret (5e-5 of each gradient's
# largest entry; there from the same activations in fp32).
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_plain_bf16_k2_from_bf16_saved_matches_pallas_interpret(white_bkgd):
    S = 65
    params, inputs, cot = _level(R, S, seed=S + 10 + white_bkgd)
    want = _jax_bwd(params, inputs, cot, white_bkgd)
    kept, raw = _pallas_kept(params, inputs[3], inputs[4], S)
    saved = kept.to(torch.bfloat16)
    assert torch.equal(saved.float(), kept)
    args = (_torch_kp(params), *map(torch.from_numpy, inputs), saved, raw, *map(torch.from_numpy, cot), white_bkgd)
    errs = _rel_errors(ft.fused_level_bwd_saved(*args, ray_tile=TILE, dot_bf16=True), want)
    assert all(v <= K2_TOL for v in errs.values()), errs
    args32 = (*args[:6], kept, *args[7:])  # the control, in fp32 mode from the fp32 saved
    fp32 = _rel_errors(ft.fused_level_bwd_saved(*args32, ray_tile=TILE), want)
    assert sum(v > K2_TOL for v in fp32.values()) > len(fp32) // 2, fp32


def test_card_wrappers_check_the_saved_dtype():
    # fused_level_bwd_saved takes saved of saved_dtype only, on the CPU as on the card
    _, args, cot = _args(9, 3)
    for dot_bf16 in (False, True):
        *_, saved, raw = ft.fused_level_fwd_spill(*args, True, ray_tile=TILE, dot_bf16=dot_bf16)
        other = saved.float() if dot_bf16 else saved.to(torch.bfloat16)
        want = "expected float32" if not dot_bf16 else "expected bfloat16"
        with pytest.raises(ValueError, match=want):
            ft.fused_level_bwd_saved(*args, other, raw, *cot, True, ray_tile=TILE, dot_bf16=dot_bf16)
        with pytest.raises(ValueError, match=want):
            ft.fused_level_bwd_saved(*args, saved.double(), raw, *cot, True, ray_tile=TILE, dot_bf16=dot_bf16)
    # and the card's own check of saved, per mode
    shape, cpu = (2, ft.SAVED_FLOATS), torch.device("cpu")
    ft._check("saved", torch.zeros(shape, dtype=torch.bfloat16), shape, cpu, ft.saved_dtype(True))
    ft._check("saved", torch.zeros(shape), shape, cpu, ft.saved_dtype(False))
    with pytest.raises(ValueError, match="expected bfloat16"):
        ft._check("saved", torch.zeros(shape), shape, cpu, ft.saved_dtype(True))
    with pytest.raises(ValueError, match="expected float32"):
        ft._check("saved", torch.zeros(shape, dtype=torch.bfloat16), shape, cpu, ft.saved_dtype(False))
    assert np.dtype(np.float32).itemsize == 2 * torch.zeros((), dtype=ft.saved_dtype(True)).element_size()
