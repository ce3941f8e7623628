"""A NaN through one level, on the CPU: planted in a trunk weight, in a
view-branch weight, or in a cotangent, the port's plain level forward (K1's
and K1s') and its backward from K1s' saved activations (K2's) give NaN in
exactly the outputs and gradient entries where aonerf's Pallas kernels in
interpret mode give it, in fp32 and in bf16 mode. The CUDA kernels are held
to these plain versions' masks on the card (chip_smoke.py phase 25,
tests/test_torch_gpu.py)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.ops.kernels import mlp_params_from_flax
from aonerf.ops.kernels.fused_render import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels.fused_train import _fused_level_bwd_impl
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.ops.kernels import fused_train as ft
from tests.test_torch_fused_train import _level, _torch_kp

torch.set_num_threads(1)

R, S, TILE = 8, 9, 4
OUTPUTS = ("comp", "acc", "depth", "weights")
VIEW = ("wb", "bb", "wva", "wvb", "bv", "wr", "br")  # the view branch and the bottleneck that feeds it


def _plant(a, index, bits):
    """a[index] set to the float32 of ``bits``, in place."""
    a.view(np.uint32)[index] = bits


def _case(name):
    """(flax params, inputs, cotangents) with one NaN planted: in the trunk
    (pts_3's kernel, input 7 to unit 11), in the view branch (views_0's
    kernel, bottleneck input 5 to unit 9) or in one ray's acc cotangent;
    numpy's NaN (0x7fc00000) or the bits the name gives after the place."""
    params, inputs, cot = _level(R, S, seed=11)
    params = copy.deepcopy(params)
    cot = [c.copy() for c in cot]
    place, _, bits = name.partition(" ")
    bits = int(bits or "0x7fc00000", 16)
    if place == "trunk":
        _plant(params["params"]["pts_3"]["kernel"], (7, 11), bits)
    elif place == "view":
        _plant(params["params"]["views_0"]["kernel"], (5, 9), bits)
    else:
        _plant(cot[1], 2, bits)
    return params, inputs, tuple(cot)


# After the place, the NaN's bits where they are not numpy's: the card's
# arithmetic gives 0x7fffffff, its negation 0xffffffff.
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["trunk", "view", "cotangent", "trunk 0x7fffffff", "view 0xffffffff"])
def test_nan_masks_match_the_pallas_kernels(name, dot_bf16):
    white = True
    params, inputs, cot = _case(name)
    name = name.split()[0]
    jkp = {k: jnp.asarray(v) for k, v in mlp_params_from_flax(params).items()}
    want_fwd = jax_fused_render_level(jkp, *map(jnp.asarray, inputs), white, TILE, True, dot_bf16)
    want_bwd = _fused_level_bwd_impl(jkp, *map(jnp.asarray, inputs), *map(jnp.asarray, cot), white, TILE, True,
                                     dot_bf16)

    args = (_torch_kp(params), *map(torch.from_numpy, inputs))
    k1 = fr.fused_render_level(*args, white, ray_tile=TILE, dot_bf16=dot_bf16)
    k1s = ft.fused_level_fwd_spill(*args, white, ray_tile=TILE, dot_bf16=dot_bf16)
    grads = ft.fused_level_bwd_saved(*args, k1s[4], k1s[5], *map(torch.from_numpy, cot), white, ray_tile=TILE,
                                     dot_bf16=dot_bf16)

    for i, n in enumerate(OUTPUTS):
        want = np.isnan(np.asarray(want_fwd[i])).reshape(k1[i].shape)
        assert np.array_equal(torch.isnan(k1[i]).numpy(), want), f"K1 plain {n}"
        assert np.array_equal(torch.isnan(k1s[i]).numpy(), want), f"K1s plain {n}"
    for n in fr.WEIGHT_NAMES:
        want = np.isnan(np.asarray(want_bwd[n])).reshape(grads[n].shape)
        assert np.array_equal(torch.isnan(grads[n]).numpy(), want), f"K2 plain {n}"

    # what the reference's masks are: the ReLU's backward is a select (XLA
    # computes the Pallas kernel's g * (h > 0) as one), so a closed mask
    # gives 0 for a NaN cotangent too, and a NaN gradient reaches only the
    # columns an open mask lets it into
    fwd_nan = {n: bool(torch.isnan(k1[i]).all()) for i, n in enumerate(OUTPUTS)}
    share = {n: torch.isnan(grads[n]).double().mean().item() for n in fr.WEIGHT_NAMES}
    if name == "trunk":  # every output NaN; every delta above pts_3 is 0 (raw sigma and zv NaN: closed)
        assert all(fwd_nan.values()) and share["w3"] == share["b3"] == 0.0 and share["w0"] == 1.0
    elif name == "view":  # the color only
        assert fwd_nan == {"comp": True, "acc": False, "depth": False, "weights": False}
    else:  # the density's deltas: the view branch and the bottleneck stay finite
        assert not any(fwd_nan.values()) and share["wd"] == 1.0 and all(share[n] == 0.0 for n in VIEW)
    assert any(0.0 < v < 1.0 for v in share.values()), share  # masks, not all or nothing


def _tf32_big(x: np.ndarray) -> np.ndarray:
    """The big TF32 half of each float32 of ``x`` as the fp32 kernels split
    it on the integer pipe (csrc/nerf_level.cuh's tf32_rna): half a TF32
    ulp added to the bits, the 13 low bits cleared, in 32-bit arithmetic."""
    b = x.view(np.uint32).astype(np.uint64)
    return (((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFF000, 0xFFFFF000])
def test_fp32_weight_packs_keep_a_nan_through_the_tf32_split(bits):
    # the product weights the fp32 kernels split in-kernel (K1 and K1s from
    # kernel_weights_t, B1 from bwd_operands' copies): a NaN of any bits in
    # a trunk and a view weight splits to a NaN, where the raw bits of all
    # but 0x7fc00000 would split to a zero; every other value keeps its bits
    kp = _torch_kp(_level(R, S, seed=11)[0])
    planted = {n: v.clone() for n, v in kp.items()}
    for name, index in (("w3", (7, 11)), ("wva", (5, 9))):
        planted[name].view(torch.int32)[index] = int(np.array(bits, np.uint32).view(np.int32))
    raw = np.array([bits], np.uint32).view(np.float32)
    assert np.isnan(raw).all() and np.isnan(_tf32_big(raw)).all() == (bits == 0x7FC00000)

    wt, wt0 = fr.kernel_weights_t(planted).numpy(), fr.kernel_weights_t(kp).numpy()
    b1, b10 = ft.bwd_operands(planted, False)[0], ft.bwd_operands(kp, False)[0]
    b1 = np.concatenate([b1[n].numpy().ravel() for n in ft.B1_WEIGHTS])
    b10 = np.concatenate([b10[n].numpy().ravel() for n in ft.B1_WEIGHTS])
    for pack, clean in ((wt, wt0), (b1, b10)):
        nan = np.isnan(pack)
        assert nan.sum() == 2 and np.array_equal(np.isnan(_tf32_big(pack)), nan)
        assert np.array_equal(pack.view(np.uint32)[~nan], clean.view(np.uint32)[~nan])
