"""The bf16 rule of the articulated models (``compute_dtype=bf16`` of the
auto-decoder's field and the auto-encoder), stated before the port's bf16
modules are held to it, with the evaluations it must accept and the
controls it must turn away. The form it holds to is
``aonerf_torch.models.bf16_form``; PERF.md section 2 states the rule.

1. Per layer, each product from the same bf16 input (no cascade): every
   output within 1 bf16 ulp of Form('fp64', 'flax') (the fp64-summed value
   rounded at flax's points), and the share of outputs off it at most
   4x flax's own share on that layer (never less than 4 outputs' worth).
2. End to end, for the field (both schedules, both levels) and for the
   auto-encoder (codes, predicted state, both levels): the share of rows
   whose raw outputs differ from flax's by more than 3e-3 of the level's
   largest output, and the rms of comp_rgb (codes, state) against the fp64
   evaluation, each at most 2x the farthest of the legitimate evaluations.

Legitimate evaluations: flax under XLA's default flags, flax with
``--xla_allow_excess_precision=false`` in a fresh interpreter, and the form
summed in fp64, in fp32 and in fp32 over K reversed. Controls: the fp32
module, operands rounded with products and bias adds in fp32 (the vanilla
``dot_bf16`` form) and the bias added before the product's rounding (what
``F.linear`` with a bias does). The field's biases are drawn at random here
(the seed's are zero, which would hide the last control).
"""

import numpy as np
import pytest
import torch

from aonerf_torch.models import bf16_form as bf
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.articulated import ArticulatedNeRF
from aonerf_torch.utils.bridge import module_flax_tree
from tests import bf16_flax

torch.set_num_threads(2)

R, SC, NF, V = 128, 16, 16, 2  # rays, samples, source views (rays grouped by view)
AE_SC, AE_NF = 8, 8
FORMS = {"form fp64": ("fp64", "flax"), "form fp32": ("fp32", "flax"), "form fp32 reversed": ("fp32_reversed", "flax")}
CONTROLS = {"fp32 module": ("fp32", "none"), "operands only": ("fp32", "operands"),
            "bias before rounding": ("fp32", "bias_first")}


def rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "viewdirs": d}


def random_biases(module, seed, std=0.05):
    """Every Linear's bias drawn from N(0, std^2): a trained field's biases
    are not zero, and the bias-first control differs only through them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(std * torch.randn(m.bias.shape, generator=g))
    return module


def field_setup(latent_dense, seed=3):
    f = random_biases(ArticulatedNeRF(num_coarse_samples=SC, num_fine_samples=NF, latent_dense=latent_dense,
                                      generator=torch.Generator().manual_seed(seed), device="cpu"), seed)
    rng = np.random.default_rng(seed)
    lat = {k: (0.3 * rng.standard_normal((V, c))).astype(np.float32)
           for k, c in (("density", 128), ("color", 128), ("articulation", 32))}
    return f, module_flax_tree(f), rays(R, seed), lat


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def field_evals(f, tree, r, lat, latent_dense, fresh):
    """{name: (comps per level, raws per level as (rows, 4))} of every
    legitimate evaluation and control, the raws at the fp64 evaluation's
    points; and the fp64 evaluation's comps."""
    with torch.no_grad():
        levels64, _, pts = bf.Form("fp64", "none").field(f, _t(r), True, 2.0, 6.0, _t(lat))
        pts = [p.float() for p in pts]
        out = {}
        for name, (sums, rounding) in {**FORMS, **CONTROLS}.items():
            lv, raws, _ = bf.Form(sums, rounding).field(f, _t(r), True, 2.0, 6.0, _t(lat), samples=pts)
            out[name] = ([x[0] for x in lv], [torch.cat(x, -1) for x in raws])
    for name, res in (("flax", bf16_flax.field_eval(tree, r, lat, [p.numpy() for p in pts], latent_dense, SC, NF)),
                      ("flax no excess precision", fresh)):
        out[name] = ([torch.from_numpy(np.asarray(x[0])) for x in res["levels"]],
                     [torch.from_numpy(np.concatenate([np.asarray(a) for a in x], -1)) for x in res["raws"]])
    return out, [x[0] for x in levels64], [p.numpy() for p in pts]


def e2e_verdicts(evals, comps64, legit):
    """{name: [(share, rms, share limit, rms limit) per level]} against flax's
    raw outputs and the fp64 comps, the limits from the ``legit`` names."""
    ref = evals["flax"][1]
    stats = {n: [(bf.row_share(raws[i], ref[i]), bf.rms(comps[i], comps64[i])) for i in range(len(ref))]
             for n, (comps, raws) in evals.items()}
    out = {}
    for n, levels in stats.items():
        out[n] = []
        for i, (share, r) in enumerate(levels):
            limits = bf.e2e_limits([stats[m][i][0] for m in legit], [stats[m][i][1] for m in legit],
                                   ref[i].reshape(-1, ref[i].shape[-1]).shape[0])
            out[n].append((share, r) + limits)
    return out


def passes(levels):
    return all(s <= ls and r <= lr for s, r, ls, lr in levels)


LEGIT = ["flax", "flax no excess precision", *FORMS]


@pytest.fixture(scope="module")
def setups():
    """Both schedules' fields and the auto-encoder, with flax's evaluations
    without excess precision from one fresh interpreter."""
    fields = {ld: field_setup(ld) for ld in (False, True)}
    pts = {}
    with torch.no_grad():
        for ld, (f, _, r, lat) in fields.items():
            pts[ld] = [p.float().numpy() for p in bf.Form("fp64", "none").field(f, _t(r), True, 2.0, 6.0, _t(lat))[2]]
    ae = ae_setup()
    jobs = [("field", (tree, r, lat, pts[ld], ld, SC, NF), {}) for ld, (_, tree, r, lat) in fields.items()]
    jobs.append(("ae", (ae["tree"], ae["rays"], ae["src"], ae["deg"], True, AE_SC, AE_NF), {}))
    jobs += layer_jobs(fields, ae)
    fresh = bf16_flax.run_fresh(jobs)
    return {"fields": fields, "fresh_fields": fresh[:2], "ae": ae, "fresh_ae": fresh[2], "fresh_layers": fresh[3:]}


@pytest.mark.parametrize("latent_dense", [False, True], ids=["concat", "latent_dense"])
def test_field_e2e_rule(setups, latent_dense):
    f, tree, r, lat = setups["fields"][latent_dense]
    evals, comps64, _ = field_evals(f, tree, r, lat, latent_dense, setups["fresh_fields"][int(latent_dense)])
    verdicts = e2e_verdicts(evals, comps64, LEGIT)
    for name in LEGIT:
        assert passes(verdicts[name]), (name, verdicts[name])
    # every control turns away, each by the share of its raw outputs
    for name in CONTROLS:
        assert not passes(verdicts[name]), (name, verdicts[name])
        assert any(s > ls for s, _, ls, _ in verdicts[name]), (name, verdicts[name])
    # the two flax evaluations agree here, so the forms set the limits
    assert all(s == 0 for s, *_ in verdicts["flax no excess precision"])


# --------------------------------------------------------------- per layer


def ae_setup(seed=4):
    ae = AutoEncoderArticulatedNeRF(num_coarse_samples=AE_SC, num_fine_samples=AE_NF, latent_dense=True,
                                    generator=torch.Generator().manual_seed(seed), device="cpu")
    random_biases(ae.field, seed)
    random_biases(ae.joint_state_decoder, seed + 1)
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (V, 3, *bf16_flax.SRC_HW)).astype(np.float32)
    deg = np.deg2rad([20.0, 61.0]).astype(np.float32)
    return {"model": ae, "tree": module_flax_tree(ae), "rays": rays(64, seed), "src": src, "deg": deg}


def layer_records(fields, ae):
    """(kind, module, input, fp64-form output) of every product of the
    coarse MLP in both schedules (at the fp64 evaluation's coarse points),
    five convolutions of the encoder and the joint-state decoder."""
    out = []
    with torch.no_grad():
        for ld, (f, _, r, lat) in fields.items():
            form = bf.Form("fp64", "flax")
            _, _, pts = bf.Form("fp64", "none").field(f, _t(r), True, 2.0, 6.0, _t(lat))
            venc = form.pos_enc(torch.from_numpy(r["viewdirs"]), 0, 4)
            form.record = []
            form.mlp(f.coarse_mlp, pts[0].float(), venc, _t(lat))
            out += [("mlp", getattr(f.coarse_mlp, n), x, y) for n, x, y in form.record]
        form = bf.Form("fp64", "flax")
        form.record = []
        codes = form.encoder(ae["model"].encoder, torch.from_numpy(ae["src"]))
        enc = ae["model"].encoder
        wanted = [enc.conv1, enc.layer1.block0.conv1, enc.layer2.block0.conv1, enc.layer2.block0.downsample,
                  enc.color_layer4.block0.conv2]
        out += [("conv", c, x, y) for c, x, y in form.record if any(c is w for w in wanted)]
        form.record = []  # the decoder on 512 codes of the encoder's scale: a few rows would hide any share
        g = torch.Generator().manual_seed(5)
        form.joint_state(ae["model"].joint_state_decoder,
                         codes["articulation"].std() * torch.randn((512, 32), generator=g, dtype=torch.float64))
        out += [("mlp", getattr(ae["model"].joint_state_decoder, n), x, y) for n, x, y in form.record]
    return out


def _flax_job(kind, layer, x):
    if kind == "conv":
        return ("conv", (layer.weight.detach().numpy().transpose(2, 3, 1, 0), x.float().numpy(), layer.stride[0],
                         layer.padding[0]), {})
    kernel, bias = layer.weight.detach().numpy().T.copy(), layer.bias.detach().numpy()
    if isinstance(x, tuple):
        x_var, lats = x
        return ("latent_dense", (kernel, bias, x_var.float().numpy(), [l.float().numpy() for l in lats],
                                 x_var.shape[0]), {})
    return ("dense", (kernel, bias, x.float().numpy()), {})


_RECORDS = {}


def records(fields, ae):
    key = (id(fields), id(ae))
    if key not in _RECORDS:
        _RECORDS[key] = layer_records(fields, ae)
    return _RECORDS[key]


def layer_jobs(fields, ae):
    return [_flax_job(kind, layer, x) for kind, layer, x, _ in records(fields, ae)]


def form_layer(form, kind, layer, x):
    with torch.no_grad():
        if kind == "conv":
            return form.conv(layer, x.to(form.act))
        if isinstance(x, tuple):
            x_var, lats = x
            return form.latent_dense(layer, x_var.to(form.act), lats, x_var.shape[0])
        return form.dense(layer, x.to(form.act))


def layer_table(setups):
    """[(layer, n, flax share, {name: (ulps, share)})] of every recorded
    product: flax in this process and fresh, the legitimate forms and the
    controls, each against the fp64 form."""
    fields, ae = setups["fields"], setups["ae"]
    table = []
    for (kind, layer, x, ref), fresh in zip(records(fields, ae), setups["fresh_layers"]):
        scale = bf.term_scale(layer, x)
        here = bf16_flax.run_jobs([_flax_job(kind, layer, x)])[0]
        errs = {"flax": bf.layer_errors(torch.from_numpy(here), ref, scale),
                "flax no excess precision": bf.layer_errors(torch.from_numpy(fresh), ref, scale)}
        for name, (sums, rounding) in {**FORMS, **CONTROLS}.items():
            errs[name] = bf.layer_errors(form_layer(bf.Form(sums, rounding), kind, layer, x), ref, scale)
        table.append((layer, ref.numel(), errs["flax"][1], errs))
    return table


def test_layer_rule(setups):
    table = layer_table(setups)
    assert len(table) == 2 * 20 + 5 + 3  # both schedules' 20 products, 5 convolutions, the decoder's 3
    turned_away = {name: 0 for name in CONTROLS}
    for layer, n, flax_share, errs in table:
        for name in LEGIT:
            assert bf.layer_passes(errs[name], flax_share, n), (layer, name, errs[name], flax_share)
        for name in CONTROLS:
            turned_away[name] += not bf.layer_passes(errs[name], flax_share, n)
    # the fp32 module and the unrounded products miss every layer; the bias
    # first every layer that has a bias (not the convolutions)
    assert turned_away == {"fp32 module": len(table), "operands only": len(table),
                           "bias before rounding": len(table) - 5}, turned_away


def test_rounding_helpers():
    x = torch.tensor([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 + 2**-8 + 2**-30, -(1.0 + 2**-8), 3.0e-3, 0.0],
                     dtype=torch.float64)
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-6, 1.0 + 2**-7, -1.0, 3.0e-3], dtype=torch.float64)
    got = bf.round_bf16(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == 0
    assert got[5] == torch.tensor(3.0e-3).to(torch.bfloat16).double()  # one rounding agrees with torch's here
    assert torch.equal(bf.bf16_ulp(torch.tensor([1.0, 1.99, 2.0, -0.75], dtype=torch.float64)),
                       torch.tensor([2**-7, 2**-7, 2**-6, 2**-8], dtype=torch.float64))


# ------------------------------------------------------------ auto-encoder


def ae_evals(setups):
    ae = setups["ae"]
    model = ae["model"]
    r, src, deg = _t(ae["rays"]), torch.from_numpy(ae["src"]), torch.from_numpy(ae["deg"])

    def rows(levels, codes, state):
        """comps per level, and 'raws' per part: each code head and the state
        as (entries, 1) rows."""
        parts = [codes[k].reshape(-1, 1) for k in sorted(codes)] + [state.reshape(-1, 1)]
        return [x[0] for x in levels], parts

    out = {}
    with torch.no_grad():
        lv64, codes64, state64 = bf.Form("fp64", "none").autoencoder(model, r, src, deg, True, 2.0, 6.0)
        for name, (sums, rounding) in {**FORMS, **CONTROLS}.items():
            out[name] = rows(*bf.Form(sums, rounding).autoencoder(model, r, src, deg, True, 2.0, 6.0))
    for name, res in (("flax", bf16_flax.ae_eval(ae["tree"], ae["rays"], ae["src"], ae["deg"], True, AE_SC, AE_NF)),
                      ("flax no excess precision", setups["fresh_ae"])):
        levels = [[torch.from_numpy(np.asarray(a)) for a in x] for x in res["levels"]]
        codes = {k: torch.from_numpy(np.asarray(v)) for k, v in res["codes"].items() if k != "articulation_deg"}
        out[name] = rows(levels, codes, torch.from_numpy(np.asarray(res["state"])))
    ref64 = rows(lv64, codes64, state64)
    return out, ref64


def test_ae_e2e_rule(setups):
    # The codes and the state entry by entry: the share off flax's beyond
    # 3e-3 of the largest and their rms against fp64; each level's comp_rgb
    # by its rms against fp64. From a random encoder at 64x48 every bf16
    # evaluation lands its codes ~7e-2 rms from fp64 and 85-98% of their
    # entries off flax's (instance norm over layer4's 2x2 maps amplifies one
    # rounding), as far as the fp32 module is from flax: here the rule
    # accepts the legitimate evaluations, and the layer rule turns the
    # controls away.
    evals, (comps64, parts64) = ae_evals(setups)
    ref = evals["flax"][1]
    stats = {name: ([(bf.row_share(p, q), bf.rms(p, q64)) for p, q, q64 in zip(parts, ref, parts64)],
                    [bf.rms(c, c64) for c, c64 in zip(comps, comps64)]) for name, (comps, parts) in evals.items()}
    part_limits = [bf.e2e_limits([stats[m][0][i][0] for m in LEGIT], [stats[m][0][i][1] for m in LEGIT],
                                 q.shape[0]) for i, q in enumerate(ref)]
    comp_limits = [bf.E2E_FACTOR * max(stats[m][1][i] for m in LEGIT) for i in range(len(comps64))]
    for name in LEGIT:
        parts, comps = stats[name]
        assert all(s <= ls and r <= lr for (s, r), (ls, lr) in zip(parts, part_limits)), (name, parts, part_limits)
        assert all(r <= lr for r, lr in zip(comps, comp_limits)), (name, comps, comp_limits)
    # the fp32 module is orders of magnitude nearer fp64 than any bf16 evaluation
    assert max(r for _, r in stats["fp32 module"][0]) < 1e-2 * min(r for m in LEGIT for _, r in stats[m][0])
