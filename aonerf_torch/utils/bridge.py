"""Carry weights between the JAX package's flax parameter trees and the port.

The trees come as nested dicts of numpy arrays (``jax.device_get`` of the
flax params); nothing here imports JAX. A flax ``Dense`` kernel is (in, out)
and a torch ``Linear`` weight is (out, in), so kernels are transposed; a flax
``Embed`` table and a torch ``Embedding`` weight are both (num, features).
An MLP tree is {layer: {kernel, bias}} with the port module's layer names,
the vanilla ``NeRFMLP``'s or the ``ArticulatedNeRFMLP``'s at any widths; a
two-level field's tree holds one under 'coarse_mlp' and one under
'fine_mlp'. The auto-decoder's trees are {'model': ArticulatedNeRF tree,
'codes': CodeLibraryArticulated tree}, one bridge function for each.
"""

from typing import Dict, Mapping

import numpy as np
import torch

# the vanilla NeRFMLP's layers
MLP_LAYERS = tuple(f"pts_{i}" for i in range(8)) + ("density", "bottleneck", "views_0", "rgb")
LEVELS = ("coarse_mlp", "fine_mlp")


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def mlp_state_dict_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """An MLP's state_dict from its flax tree (optionally under 'params'),
    each key led by ``prefix``."""
    out = {}
    for layer, leaves in _params(tree).items():
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        out[f"{prefix}{layer}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        out[f"{prefix}{layer}.bias"] = torch.from_numpy(np.array(leaves["bias"], dtype=np.float32))
    return out


def nerf_state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A two-level field's state_dict (``NeRF`` or ``ArticulatedNeRF``) from
    its flax tree (params/{coarse_mlp,fine_mlp}/<layer>/{kernel,bias})."""
    p = _params(tree)
    out = {}
    for mlp in LEVELS:
        out.update(mlp_state_dict_from_flax(p[mlp], prefix=f"{mlp}."))
    return out


articulated_state_dict_from_flax = nerf_state_dict_from_flax  # the same layout


def codes_state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``CodeLibraryArticulated`` state_dict from the flax tree
    (params/<table>/embedding)."""
    return {f"{name}.weight": torch.from_numpy(np.array(t["embedding"], dtype=np.float32))
            for name, t in _params(tree).items()}


def _leaf(t: torch.Tensor, grads: bool, name: str) -> np.ndarray:
    t = t.grad if grads else t
    if t is None:
        raise ValueError(f"{name}: no gradient")
    return t.detach().cpu().numpy()


def mlp_flax_tree(mlp, grads: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {kernel, bias}} of a port MLP's parameters, or with ``grads``
    of their ``.grad``, as numpy arrays."""
    return {name: {"kernel": _leaf(lin.weight, grads, name).T.copy(), "bias": _leaf(lin.bias, grads, name).copy()}
            for name, lin in mlp.named_children()}


def nerf_flax_tree(nerf, grads: bool = False) -> Dict[str, Dict]:
    """The flax tree (params/{coarse_mlp,fine_mlp}/<layer>/{kernel,bias}) of
    a port two-level field's parameters, or with ``grads`` of their
    ``.grad``."""
    return {"params": {m: mlp_flax_tree(getattr(nerf, m), grads) for m in LEVELS}}


articulated_flax_tree = nerf_flax_tree  # the same layout


def codes_flax_tree(codes, grads: bool = False) -> Dict[str, Dict]:
    """The flax ``CodeLibraryArticulated`` tree of a port code library."""
    return {"params": {name: {"embedding": _leaf(t.weight, grads, name).copy()} for name, t in codes.named_children()}}
