"""Port parity: the encoder's pixel-aligned ``spatials`` heads (the stem's,
each shared stage's and the head's layer4 map resized bilinearly to the
stem's h/2 x w/2, concatenated, a 1x1 conv ``{name}_pix``) against aonerf's
flax ``MultiHeadImgEncoder`` with the port's weights carried by the bridge,
at 64x48 (layer4 2x2 upsampled 12x / 16x to the stem's 24x32) and 80x60
(odd maps); the resize alone against ``jax.image.resize``.

``F.interpolate(mode='bilinear', align_corners=False)`` clamps the source
index at the borders where jax.image.resize drops the triangle kernel's
out-of-range taps and renormalizes; on an upsample both give the edge
pixel there, so the two differ by rounding only (measured at every pyramid
level of 64x48 and 80x60: at most 3 float32 ulps of the largest value). The
heads are held as tests/test_torch_resnet.py holds the vector heads: within
1e-4 of the head's largest fp64 output."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aonerf.models.resnet import MultiHeadImgEncoder as JaxEncoder
from aonerf_torch.models.resnet import MultiHeadImgEncoder
from aonerf_torch.utils.bridge import flax_leaves, module_flax_tree, module_state_dict_from_flax

torch.set_num_threads(2)

TOL = 1e-4  # tests/test_torch_resnet.py
CASES = {
    "color_64x48": (dict(spatials=("color",)), (2, 3, 48, 64)),
    "density_color_group_80x60": (dict(spatials=("density", "color"), norm_type="group"), (1, 3, 60, 80)),
    "articulation_views_mean_64x48": (dict(spatials=("articulation",)), (1, 2, 3, 48, 64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_heads_match_flax(case):
    kwargs, shape = CASES[case]
    enc = MultiHeadImgEncoder(**kwargs, generator=torch.Generator().manual_seed(5), device="cpu")
    with torch.no_grad():  # the 1x1 conv's bias off its zero init, so a dropped bias would show
        for name in kwargs["spatials"]:
            getattr(enc, f"{name}_pix").bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    tree = module_flax_tree(enc)
    jax_tree = jax.eval_shape(JaxEncoder(**kwargs).init, jax.random.PRNGKey(0), jnp.zeros((1,) + shape[-3:]))
    assert {p: np.shape(v) for p, v in flax_leaves(tree["params"])} == {
        p: tuple(v.shape) for p, v in flax_leaves(jax_tree["params"])}
    want = jax.device_get(jax.jit(JaxEncoder(**kwargs).apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
        exact = copy.deepcopy(enc).double()(torch.from_numpy(x).double())
    assert sorted(got) == sorted(want)
    h, w = (shape[-2] + 1) // 2, (shape[-1] + 1) // 2
    for k in got:
        if k in kwargs["spatials"]:
            assert got[k].shape == want[k].shape == (shape[0], 128 if k != "articulation" else 32, h, w), k
        scale = exact[k].abs().max().item()
        err = np.abs(got[k].numpy() - want[k]).max() / scale
        assert err <= TOL, (k, err)
        err64 = (got[k].double() - exact[k]).abs().max().item() / scale
        assert err64 <= TOL, (k, err64)
    assert list(module_state_dict_from_flax(tree)) == list(enc.state_dict())


@pytest.mark.parametrize("src,dst", [((2, 2), (24, 32)), ((3, 4), (24, 32)), ((6, 8), (24, 32)), ((12, 16), (24, 32)),
                                     ((24, 32), (24, 32)), ((2, 3), (30, 40)), ((4, 5), (30, 40)),
                                     ((15, 20), (30, 40))])
def test_bilinear_resize_matches_jax(src, dst):
    x = np.random.default_rng(sum(src)).uniform(-3, 3, (2, *src, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 8), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 3 * ulp
    # the borders: the edge pixels' values, as both clamp there
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=3 * ulp, rtol=0)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], atol=3 * ulp, rtol=0)
