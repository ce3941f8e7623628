"""Port parity: the multi-head ResNet34 encoder of aonerf_torch against
aonerf's flax ``MultiHeadImgEncoder``, with the port's weights carried to
flax by the bridge; and the torchvision-layout loader against
``init_from_torch_state_dict``.

Every image is at least 64x48, where each head's layer4 map is 2x2 or
larger: at 32x24 it is 1x1, instance norm makes it exactly 0 and every head
would output its bias alone. 80x60 gives odd maps (layer1 20x15, layer3 5x4,
layer4 3x2), as 320x240's layer3 (20x15) is."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models.resnet import MultiHeadImgEncoder as JaxEncoder
from aonerf.models.resnet import init_from_torch_state_dict
from aonerf_torch.models.resnet import STAGE_BLOCKS, MultiHeadImgEncoder, load_torchvision_resnet34
from aonerf_torch.utils.bridge import flax_leaves, module_flax_tree, module_state_dict_from_flax

torch.set_num_threads(2)

# Each head's output against the same encoder in fp64 (the port cast to
# double), max abs error / max |fp64|, on uniform [-1, 1] images: JAX's fp32
# up to 2.2e-5 and the port's fp32 up to 1.9e-5 (instance norm over a 2x2
# map divides by a 4-sample deviation), group norm ~5e-7. The port is held
# to JAX within 1e-4 of the head's largest fp64 output.
TOL = 1e-4

CASES = {
    "instance_64x48": (dict(), (2, 3, 48, 64)),
    "instance_odd_80x60": (dict(), (1, 3, 60, 80)),
    "group_global_mean_views": (dict(norm_type="group", global_size=16), (1, 2, 3, 48, 64)),
    "instance_max_views": (dict(agg_fct="max"), (2, 2, 3, 48, 64)),
}


def _maps(encoder, x):
    """The spatial size each stage's output has for input x."""
    sizes, hooks = {}, []

    def record(name):
        def hook(module, inputs, out):
            sizes[name] = tuple(out.shape[-2:])  # returns None: the output stays

        return hook

    for name in ("layer1", "layer3", "articulation_layer4"):
        hooks.append(getattr(encoder, name).register_forward_hook(record(name)))
    try:
        with torch.no_grad():
            encoder(x)
    finally:
        for h in hooks:
            h.remove()
    return sizes


@pytest.mark.parametrize("case", list(CASES))
def test_encoder_matches_flax(case):
    kwargs, shape = CASES[case]
    enc = MultiHeadImgEncoder(**kwargs, generator=torch.Generator().manual_seed(3), device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    want = jax.device_get(jax.jit(JaxEncoder(**kwargs).apply)(module_flax_tree(enc), jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
        exact = copy.deepcopy(enc).double()(torch.from_numpy(x).double())
    heads = ["color", "density", "articulation"] + (["global"] if "global_size" in kwargs else [])
    assert sorted(got) == sorted(want) == sorted(heads)
    n = shape[0]
    for k in heads:
        sizes = {"global": 16, "color": 128, "density": 128, "articulation": 32}
        assert got[k].shape == want[k].shape == (n, sizes[k]), k
        scale = exact[k].abs().max().item()
        err = np.abs(got[k].numpy() - want[k]).max() / scale
        assert err <= TOL, (k, err)
        if n > 1:  # the heads see their input: not a bias alone
            assert np.abs(want[k][0] - want[k][1]).max() > 1e-2 * scale, k
    sizes = _maps(enc, torch.from_numpy(x.reshape(-1, *shape[-3:])))
    assert min(sizes["articulation_layer4"]) >= 2
    if case == "instance_odd_80x60":
        assert (sizes["layer1"], sizes["layer3"], sizes["articulation_layer4"]) == ((15, 20), (4, 5), (2, 3))


def test_multiview_aggregates_each_view():
    # mean and max over V of the views encoded one by one (a batch of 3 and
    # a batch of 1 take other conv blockings: within TOL of the largest output)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 3, 3, 48, 64)).astype(np.float32))
    for agg, fn in (("mean", lambda t: t.mean(0)), ("max", lambda t: t.amax(0))):
        enc = MultiHeadImgEncoder(agg_fct=agg, generator=torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            got = enc(x)
            views = [enc(x[:, v]) for v in range(3)]
        for k in got:
            want = fn(torch.stack([v[k][0] for v in views]))
            torch.testing.assert_close(got[k][0], want, atol=TOL * want.abs().max().item(), rtol=0)


def test_bridge_round_trips_the_encoder_tree():
    enc = MultiHeadImgEncoder(norm_type="group", global_size=16, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():  # scales and biases off their init, so a swap would show
        for p in enc.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    jax_tree = jax.eval_shape(JaxEncoder(norm_type="group", global_size=16).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 3, 48, 64)))
    tree = module_flax_tree(enc)
    want = {p: tuple(v.shape) for p, v in flax_leaves(jax_tree["params"])}
    got = {p: np.shape(v) for p, v in flax_leaves(tree["params"])}
    assert got == want  # every flax leaf, named and shaped as flax names and shapes it
    back = module_state_dict_from_flax(tree)
    assert list(back) == list(enc.state_dict())
    for k, v in enc.state_dict().items():
        assert torch.equal(back[k], v), k


def _torchvision_state_dict(seed: int):
    """A random ResNet34 state dict in torchvision's key layout and shapes."""
    rng = np.random.default_rng(seed)
    sd = {"conv1.weight": rng.standard_normal((64, 3, 7, 7)).astype(np.float32)}
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{name}"] = rng.standard_normal(64).astype(np.float32)
    cin = 64
    for si, (blocks, width) in enumerate(zip(STAGE_BLOCKS["resnet34"], (64, 128, 256, 512))):
        for i in range(blocks):
            p = f"layer{si + 1}.{i}"
            c = cin if i == 0 else width
            sd[f"{p}.conv1.weight"] = rng.standard_normal((width, c, 3, 3)).astype(np.float32)
            sd[f"{p}.conv2.weight"] = rng.standard_normal((width, width, 3, 3)).astype(np.float32)
            for bn in ("bn1", "bn2"):
                sd[f"{p}.{bn}.weight"] = rng.standard_normal(width).astype(np.float32)
            if i == 0 and (c != width or si > 0):
                sd[f"{p}.downsample.0.weight"] = rng.standard_normal((width, c, 1, 1)).astype(np.float32)
                sd[f"{p}.downsample.1.weight"] = rng.standard_normal(width).astype(np.float32)
        cin = width
    sd["fc.weight"] = rng.standard_normal((1000, 512)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(1000).astype(np.float32)
    return sd


@pytest.mark.parametrize("norm_type", ["instance", "group"])
def test_torchvision_loader_matches_jax(norm_type):
    # JAX's loader on the port's own tree, bridged back, is the port's loader
    # bit for bit: shared stages, every head's layer4 copy, norms and fc heads
    # left as they were
    sd = _torchvision_state_dict(0)
    enc = MultiHeadImgEncoder(norm_type=norm_type, global_size=8, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    want = module_state_dict_from_flax(init_from_torch_state_dict(module_flax_tree(enc), sd))
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    load_torchvision_resnet34(enc, {k: torch.from_numpy(v) for k, v in sd.items()})
    got = enc.state_dict()
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    for head in ("global", "color", "density", "articulation"):
        assert torch.equal(got[f"{head}_layer4.block2.conv2.weight"], torch.from_numpy(sd["layer4.2.conv2.weight"]))
        assert torch.equal(got[f"{head}_fc.weight"], before[f"{head}_fc.weight"])
    if norm_type == "group":
        assert torch.equal(got["layer2.block0.norm2.weight"], before["layer2.block0.norm2.weight"])


def test_encoder_refuses_what_is_not_ported():
    # the pixel-aligned heads build (held to flax in tests/test_torch_resnet_spatials.py)
    enc = MultiHeadImgEncoder(spatials=("color",), device="cpu")
    assert enc.color_pix.weight.shape == (128, 64 + 64 + 128 + 256 + 512, 1, 1) and not hasattr(enc, "color_fc")
    with pytest.raises(ValueError, match="batch"):
        MultiHeadImgEncoder(norm_type="batch", device="cpu")
