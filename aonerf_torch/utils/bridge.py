"""Carry weights from the JAX package's flax parameter trees to the port.

The trees come as nested dicts of numpy arrays (``jax.device_get`` of the
flax params); nothing here imports JAX. A flax ``Dense`` kernel is (in, out)
and a torch ``Linear`` weight is (out, in), so kernels are transposed.
"""

from typing import Dict, Mapping

import numpy as np
import torch

MLP_LAYERS = tuple(f"pts_{i}" for i in range(8)) + ("density", "bottleneck", "views_0", "rgb")


def mlp_state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``NeRFMLP`` state_dict from one flax ``NeRFMLP`` tree
    ({layer: {kernel, bias}}, optionally under 'params')."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for layer in MLP_LAYERS:
        kernel = np.asarray(p[layer]["kernel"], dtype=np.float32)
        bias = np.asarray(p[layer]["bias"], dtype=np.float32)
        out[f"{layer}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        out[f"{layer}.bias"] = torch.from_numpy(np.array(bias))
    return out


def nerf_state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``NeRF`` state_dict from the flax ``NeRF`` tree
    (params/{coarse_mlp,fine_mlp}/<layer>/{kernel,bias})."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for mlp in ("coarse_mlp", "fine_mlp"):
        for k, v in mlp_state_dict_from_flax(p[mlp]).items():
            out[f"{mlp}.{k}"] = v
    return out
