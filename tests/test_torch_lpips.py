"""Port parity: LPIPS (``aonerf_torch.eval.lpips``, ``metrics.lpips_image``)
against ``aonerf.eval.lpips.lpips_from_npz`` on synthetic weights files in
the exporter's layout (tests/test_lpips_export.py): narrow widths and
VGG16's own, on 64x48 and 32x24 image pairs.

No exported LPIPS file ships with the repository and none can be
downloaded, so the weights are random from a seed
(``write_random_weights``); the real VGG16 weights run the same code.
"""

import numpy as np
import pytest
import torch

from aonerf.eval.lpips import lpips_from_npz as jax_lpips_from_npz
from aonerf.eval.metrics import lpips_image as jax_lpips_image
from aonerf_torch.eval import lpips
from aonerf_torch.eval.metrics import lpips_image
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WIDTHS = {"narrow": (4,) * 13, "vgg16": lpips.VGG16_WIDTHS}


def _pair(hw, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(*hw, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0.0, 1.0).astype(np.float32)
    return a, b


# fp32 on both sides, each summing the convolutions in its own order: at
# these inputs each side is within 4.7e-7 of the port's fp64 evaluation
# of the same weights and images, and the two within 5.6e-7 of each other.
RTOL = 2e-6


@pytest.mark.parametrize("hw", [(48, 64), (24, 32)], ids=["64x48", "32x24"])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_lpips_matches_jax(widths, hw, tmp_path):
    path = str(tmp_path / "lpips.npz")
    lpips.write_random_weights(path, seed=0, widths=WIDTHS[widths])
    a, b = _pair(hw, 1)
    want = float(jax_lpips_from_npz(path, a, b))
    weights = lpips.load_weights(path, "cpu")
    got = lpips.lpips_distance(weights, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ()
    exact = lpips.lpips_distance({k: v.double() for k, v in weights.items()}, torch.from_numpy(a).double(),
                                 torch.from_numpy(b).double())
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    np.testing.assert_allclose(float(got), float(exact), rtol=RTOL)
    # the path form reads the file itself, as JAX's does
    assert float(lpips.lpips_from_npz(path, torch.from_numpy(a), torch.from_numpy(b))) == float(got)


def test_load_weights_transposes_once_to_oihw(tmp_path):
    path = str(tmp_path / "lpips.npz")
    lpips.write_random_weights(path, seed=2)
    data = np.load(path)
    assert sorted(data.files) == sorted(
        [f"features_{i}_{k}" for i in lpips.CONV_IDXS for k in ("kernel", "bias")]
        + [f"lin_{j}_kernel" for j in range(5)])
    assert data["features_0_kernel"].shape == (3, 3, 3, 64) and data["features_28_kernel"].shape == (3, 3, 512, 512)
    assert [data[f"lin_{j}_kernel"].shape for j in range(5)] == [(64,), (128,), (256,), (512,), (512,)]
    weights = lpips.load_weights(path, "cpu")
    for i in lpips.CONV_IDXS:
        k = weights[f"features_{i}_kernel"]
        assert k.is_contiguous() and k.dtype == torch.float32
        np.testing.assert_array_equal(k.numpy(), data[f"features_{i}_kernel"].transpose(3, 2, 0, 1))
    if not torch.cuda.is_available():  # on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            lpips.load_weights(path)


def test_lpips_image_matches_jax_and_is_nan_without_weights(tmp_path):
    path = str(tmp_path / "lpips.npz")
    lpips.write_random_weights(path, seed=3, widths=WIDTHS["narrow"])
    a, b = _pair((48, 64), 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.isnan(lpips_image(ta, tb)) and np.isnan(jax_lpips_image(a, b))
    got = lpips_image(ta, tb, path)
    assert got == lpips_image(ta, tb, lpips.load_weights(path, "cpu"))
    np.testing.assert_allclose(got, jax_lpips_image(a, b, path), rtol=RTOL)
    assert lpips_image(ta, ta, path) == 0.0
