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


def _mlp_to_flax(mlp, grads: bool) -> Dict[str, Dict[str, np.ndarray]]:
    out = {}
    for layer in MLP_LAYERS:
        lin = getattr(mlp, layer)
        w, b = (lin.weight.grad, lin.bias.grad) if grads else (lin.weight, lin.bias)
        if w is None or b is None:
            raise ValueError(f"{layer}: no gradient")
        out[layer] = {
            "kernel": w.detach().cpu().numpy().T.copy(),
            "bias": b.detach().cpu().numpy().copy(),
        }
    return out


def nerf_flax_tree(nerf, grads: bool = False) -> Dict[str, Dict]:
    """The flax ``NeRF`` tree (params/{coarse_mlp,fine_mlp}/<layer>/{kernel,
    bias}) of a port ``NeRF``'s parameters, or with ``grads`` of their
    ``.grad``, as numpy arrays."""
    return {"params": {m: _mlp_to_flax(getattr(nerf, m), grads) for m in ("coarse_mlp", "fine_mlp")}}
