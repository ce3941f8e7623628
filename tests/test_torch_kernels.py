"""Port parity: the fused level (K1) of aonerf_torch against the Pallas
kernel of aonerf, run in interpret mode on the CPU as tests/test_kernels.py
runs it. The CUDA kernel itself is held against its plain version in
tests/test_torch_gpu.py, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aonerf.models import NeRFMLP as JaxNeRFMLP
from aonerf.ops import encoding as jenc
from aonerf.ops import sampling as jsamp
from aonerf.ops.kernels import fused_render_level as jax_fused_render_level
from aonerf.ops.kernels import mlp_params_from_flax
from aonerf_torch.models.mlp import NeRFMLP
from aonerf_torch.ops.kernels import fused_render as fr
from aonerf_torch.utils.bridge import mlp_state_dict_from_flax

torch.set_num_threads(1)


def _setup(R=8, S=9, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-4.0 * d).astype(np.float32)
    t_vals, coords = jsamp.sample_along_rays(jnp.asarray(o), jnp.asarray(d), S - 1, 2.0, 6.0, False, False)
    xenc = jenc.pos_enc(coords, 0, 10)
    venc = jenc.pos_enc(jnp.asarray(d), 0, 4)
    params = JaxNeRFMLP().init(jax.random.PRNGKey(seed), xenc, venc)
    return params, np.array(t_vals), o, d, np.array(venc), np.array(xenc)


def _torch_mlp(params):
    mlp = NeRFMLP(device="cpu")
    mlp.load_state_dict(mlp_state_dict_from_flax(jax.device_get(params)))
    return mlp


@pytest.mark.parametrize("S", [9, 65])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_ref_matches_pallas_interpret(S, white_bkgd):
    params, t, o, d, venc, xenc = _setup(R=8, S=S, seed=S)
    want = jax_fused_render_level(
        mlp_params_from_flax(params), jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(venc), jnp.asarray(xenc), white_bkgd, ray_tile=4, interpret=True,
    )
    with torch.no_grad():  # the serving forward; kernel_params carries grads otherwise
        kp = fr.kernel_params(_torch_mlp(params))
        got = fr.fused_render_level(
            kp, torch.from_numpy(t), torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(venc), torch.from_numpy(xenc), white_bkgd, ray_tile=4,
        )
    names = ("comp", "acc", "depth", "weights")
    tols = {"comp": 2e-6, "acc": 2e-6, "weights": 2e-6, "depth": 2e-5}
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tols[name], rtol=0, err_msg=name)


def test_kernel_params_match_flax_split():
    params, *_ = _setup()
    with torch.no_grad():
        kp = fr.kernel_params(_torch_mlp(params))
    want = mlp_params_from_flax(params)
    assert tuple(kp) == fr.WEIGHT_NAMES
    for name in fr.WEIGHT_NAMES:
        np.testing.assert_array_equal(kp[name].numpy(), np.asarray(want[name]), err_msg=name)
        assert kp[name].is_contiguous() and not kp[name].requires_grad
    assert kp["w5x"].shape == (256, 256)
    assert kp["w5i"].shape == (63, 256)
    assert kp["wva"].shape == (256, 128)
    assert kp["wvb"].shape == (27, 128)
    assert kp["b0"].shape == (1, 256)
    assert kp["wd"].shape == (256, 1)
    assert kp["wr"].shape == (128, 3)


def test_rejects_nondivisible_tile():
    params, t, o, d, venc, xenc = _setup(R=8)
    kp = fr.kernel_params(_torch_mlp(params))
    args = [torch.from_numpy(a) for a in (t, o, d, venc, xenc)]
    with pytest.raises(ValueError, match="ray_tile"):
        fr.fused_render_level(kp, *args, True, ray_tile=3)


def test_cpu_call_does_not_count_a_launch():
    params, t, o, d, venc, xenc = _setup(R=8)
    kp = fr.kernel_params(_torch_mlp(params))
    before = fr.launches
    fr.fused_render_level(kp, *[torch.from_numpy(a) for a in (t, o, d, venc, xenc)], True, ray_tile=4)
    assert fr.launches == before


def test_library_name_covers_source_and_shared_headers(tmp_path, monkeypatch):
    """An edited .cu or shared header gives a new library name (so it is
    rebuilt); another kernel's source does not. Reads names only: no nvcc."""
    import shutil

    from aonerf_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = build.all_sources()
    assert {"fused_render", "fused_train"} <= set(names)
    before = {n: build._lib_path(n).name for n in names}
    (csrc / "nerf_level.cuh").write_text((csrc / "nerf_level.cuh").read_text() + "\n// edited\n")
    after_header = {n: build._lib_path(n).name for n in names}
    assert all(after_header[n] != before[n] for n in names)
    (csrc / "fused_train.cu").write_text((csrc / "fused_train.cu").read_text() + "\n// edited\n")
    assert build._lib_path("fused_train").name != after_header["fused_train"]
    assert build._lib_path("fused_render").name == after_header["fused_render"]


def test_kernel_params_carry_gradients_with_grad_enabled():
    params, *_ = _setup()
    mlp = _torch_mlp(params)
    kp = fr.kernel_params(mlp)
    assert all(v.requires_grad for v in kp.values())
    sum(v.sum() * (i + 1) for i, v in enumerate(kp.values())).backward()
    # w5x and w5i are the two halves of pts_5's kernel (transposed)
    np.testing.assert_array_equal(mlp.pts_5.weight.grad[:, :256].numpy(), np.full((256, 256), 11.0))
    np.testing.assert_array_equal(mlp.pts_5.weight.grad[:, 256:].numpy(), np.full((256, 63), 12.0))
    np.testing.assert_array_equal(mlp.rgb.bias.grad.numpy(), np.full(3, 26.0))
