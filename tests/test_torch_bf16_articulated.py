"""Port parity: the articulated field in bf16 (``compute_dtype=torch.bfloat16``,
both schedules) against flax's bf16 field under the articulated bf16 rule
(tests/test_torch_bf16_articulated_rule.py), layer by layer and end to end.
The first step's gradients: tests/test_torch_bf16_articulated_grads.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import ArticulatedNeRF as JaxArticulatedNeRF
from aonerf_torch.models import bf16_form as bf
from aonerf_torch.models.articulated import ArticulatedNeRF, latent_linear
from aonerf_torch.models.mlp import linear
from aonerf_torch.ops.encoding import pos_enc
from aonerf_torch.utils.bridge import module_flax_tree, module_state_dict_from_flax
from tests import bf16_flax
from tests import test_torch_bf16_articulated_rule as rule

torch.set_num_threads(2)

BF16 = torch.bfloat16
# the rule's legitimate evaluations in this process (flax without excess
# precision agrees with flax here; the rule's own test shows it)
LEGIT = ["flax", *rule.FORMS]


def port_field(f, latent_dense, dtype=BF16):
    out = ArticulatedNeRF(num_coarse_samples=rule.SC, num_fine_samples=rule.NF, latent_dense=latent_dense,
                          compute_dtype=dtype, device="cpu")
    out.load_state_dict(f.state_dict())
    return out


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["concat", "latent_dense"])
def field(request):
    ld = request.param
    f, tree, r, lat = rule.field_setup(ld)
    with torch.no_grad():
        levels64, _, pts = bf.Form("fp64", "none").field(f, _t(r), True, 2.0, 6.0, _t(lat))
    pts = [p.float() for p in pts]
    flax = bf16_flax.field_eval(tree, r, lat, [p.numpy() for p in pts], ld, rule.SC, rule.NF)
    return {"ld": ld, "f": f, "tree": tree, "rays": r, "lat": lat, "pts": pts, "comps64": [x[0] for x in levels64],
            "flax": flax}


def port_eval(model, r, lat, pts):
    """(comps per level, raws per level at ``pts``) of a port field."""
    with torch.no_grad():
        levels = model(_t(r), False, True, 2.0, 6.0, _t(lat))
        venc = pos_enc(torch.from_numpy(r["viewdirs"]), 0, 4)
        raws = [torch.cat(mlp(p, venc, _t(lat)), -1) for mlp, p in zip((model.coarse_mlp, model.fine_mlp), pts)]
    return [x[0] for x in levels], raws


def test_field_is_bf16_inside_and_fp32_outside(field):
    model = port_field(field["f"], field["ld"])
    assert model.compute_dtype == BF16 and model.coarse_mlp.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    comps, raws = port_eval(model, field["rays"], field["lat"], field["pts"])
    assert all(x.dtype == torch.float32 for x in comps + raws)
    # every raw output is a bf16 value: the heads' outputs are rounded
    assert all(torch.equal(x, x.to(BF16).float()) for x in raws)


def test_field_e2e_rule(field):
    # The port in bf16 among the rule's legitimate evaluations: the share of
    # rows off flax's raw outputs and comp_rgb's rms against fp64, each
    # within 2x the farthest legitimate evaluation; the port in fp32 misses.
    f, r, lat, pts = field["f"], field["rays"], field["lat"], field["pts"]
    flax = field["flax"]
    evals = {"flax": ([torch.from_numpy(np.array(x[0])) for x in flax["levels"]],
                      [torch.from_numpy(np.concatenate([np.asarray(a) for a in x], -1)) for x in flax["raws"]])}
    with torch.no_grad():
        for name, (sums, rounding) in rule.FORMS.items():
            lv, raws, _ = bf.Form(sums, rounding).field(f, _t(r), True, 2.0, 6.0, _t(lat), samples=pts)
            evals[name] = ([x[0] for x in lv], [torch.cat(x, -1) for x in raws])
    evals["port bf16"] = port_eval(port_field(f, field["ld"]), r, lat, pts)
    evals["port fp32"] = port_eval(port_field(f, field["ld"], torch.float32), r, lat, pts)
    verdicts = rule.e2e_verdicts(evals, field["comps64"], LEGIT)
    assert rule.passes(verdicts["port bf16"]), verdicts["port bf16"]
    assert not rule.passes(verdicts["port fp32"]), verdicts["port fp32"]


def test_layer_rule(field):
    # Every product of the coarse MLP from the same bf16 input as the fp64
    # form's: the port's bf16 Dense (models.mlp.linear) and latent Dense
    # (latent_linear) within 1 ulp of it, off it no more often than 4x flax.
    f, r, lat = field["f"], field["rays"], field["lat"]
    form = bf.Form("fp64", "flax")
    form.record = []
    with torch.no_grad():
        form.mlp(f.coarse_mlp, field["pts"][0], form.pos_enc(torch.from_numpy(r["viewdirs"]), 0, 4), _t(lat))
    assert len(form.record) == 20
    for name, x, ref in form.record:
        layer = getattr(f.coarse_mlp, name)
        with torch.no_grad():
            if isinstance(x, tuple):
                got = latent_linear(layer, x[0], x[1], x[0].shape[0], BF16)
                want = bf16_flax.latent_dense_eval(layer.weight.numpy().T.copy(), layer.bias.numpy(),
                                                   x[0].float().numpy(), [v.float().numpy() for v in x[1]],
                                                   x[0].shape[0])
            else:
                got = linear(layer, x, BF16)
                want = bf16_flax.dense_eval(layer.weight.numpy().T.copy(), layer.bias.numpy(), x.float().numpy())
        assert got.dtype == BF16, name
        scale = bf.term_scale(layer, x)
        flax_share = bf.layer_errors(torch.from_numpy(want), ref, scale)[1]
        errs = bf.layer_errors(got, ref, scale)
        assert bf.layer_passes(errs, flax_share, ref.numel()), (name, errs, flax_share)


def test_bridged_flax_params_drive_both_dtypes(field):
    # flax's bf16 field keeps fp32 parameters (param_dtype), so the bridge
    # carries them unchanged into the port in either mode; both modes run
    # from the same state dict and render finite fp32 outputs
    f = field["f"]
    tree = {"params": jax.device_get(JaxArticulatedNeRF(
        num_coarse_samples=rule.SC, num_fine_samples=rule.NF, latent_dense=field["ld"],
        compute_dtype=jnp.bfloat16).init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in field["rays"].items()},
                                         False, True, 2.0, 6.0, {k: jnp.asarray(v) for k, v in field["lat"].items()})
        ["params"])}
    assert all(np.asarray(leaf).dtype == np.float32 for leaf in jax.tree_util.tree_leaves(tree))
    state = module_state_dict_from_flax(tree)
    for dtype in (torch.float32, BF16):
        model = port_field(f, field["ld"], dtype)
        model.load_state_dict(state)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert module_flax_tree(model)["params"].keys() == tree["params"].keys()
        comps, _ = port_eval(model, field["rays"], field["lat"], field["pts"])
        assert all(c.dtype == torch.float32 and torch.isfinite(c).all() for c in comps)


def test_linear_adds_the_bias_after_rounding():
    # ties of the product's rounding that the bias would break: rounding the
    # product first, as flax does, keeps them at the even neighbour
    layer = torch.nn.Linear(2, 1)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor([[1.0, 2.0**-8]]))
        layer.bias.copy_(torch.tensor([2.0**-12]))
    x = torch.tensor([[1.0, 1.0]])  # product 1 + 2^-8: a tie between 1 and 1 + 2^-7
    got = linear(layer, x, BF16)
    assert got.dtype == BF16 and got.item() == 1.0  # F.linear with the bias: 1 + 2^-7
    assert torch.nn.functional.linear(x.to(BF16), layer.weight.to(BF16), layer.bias.to(BF16)).item() == 1.0 + 2**-7
    assert torch.equal(linear(layer, x), layer(x))  # fp32: the layer itself


def test_latent_products_are_rounded_once_from_their_exact_sums():
    # a latent's product reaches every row of its view, so the port sums it
    # exactly and rounds once (models.mlp.round_exact): with x_var zero a
    # bf16 latent Dense is the bf16 bias plus the fp64 product of the bf16
    # operands rounded to bf16, each view's on its rows; its gradient passes
    # through as a cast's
    layer = torch.nn.Linear(3 + 128, 64)
    lat = torch.randn((2, 128), generator=torch.Generator().manual_seed(4), requires_grad=True)
    got = latent_linear(layer, torch.zeros((6, 3), dtype=BF16), [lat], 6, BF16)
    exact = lat.detach().to(BF16).double() @ layer.weight.detach()[:, 3:].to(BF16).double().t()
    want = layer.bias.detach().to(BF16) + bf.round_bf16(exact).to(BF16).repeat_interleave(3, dim=0)
    assert got.dtype == BF16 and torch.equal(got, want)
    (g_lat,) = torch.autograd.grad(got.float().sum(), [lat])
    assert g_lat.dtype == torch.float32 and torch.isfinite(g_lat).all() and g_lat.abs().sum() > 0


def test_pos_enc_in_bf16_matches_jax():
    # scales in bf16, + pi/2 with pi/2 rounded to bf16, sin rounded: the
    # port's pos_enc on bf16 input gives JAX's bits on 30000 points
    from aonerf.ops import encoding

    x = np.random.default_rng(0).uniform(-1.6, 1.6, (10000, 3)).astype(np.float32)
    xb = torch.from_numpy(x).to(BF16)
    got = pos_enc(xb, 0, 10)
    want = np.asarray(encoding.pos_enc(jnp.asarray(xb.float().numpy(), jnp.bfloat16), 0, 10).astype(jnp.float32))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)
