"""Carry weights between the JAX package's flax parameter trees and the port.

The trees come as nested dicts of numpy arrays (``jax.device_get`` of the
flax params); nothing here imports JAX. Every port module keeps its flax
counterpart's parameter names, so one pair of functions carries any of them
(``module_state_dict_from_flax``, ``module_flax_tree``), leaf by leaf:

  flax                                 torch
  conv kernel (H, W, I, O)             ``Conv2d`` weight (O, I, H, W)
  ``Dense`` kernel (in, out)           ``Linear`` weight (out, in)
  ``Embed`` embedding (num, features)  ``Embedding`` weight, unchanged
  ``_Norm_k/GroupNorm_0/scale|bias``   ``norm{k}.weight|bias``
  bias                                 bias

An MLP tree is {layer: {kernel, bias}} (the vanilla ``NeRFMLP``'s or the
``ArticulatedNeRFMLP``'s layers at any widths); a two-level field's tree holds
one under 'coarse_mlp' and one under 'fine_mlp'; the auto-decoder's trees are
{'model': field tree, 'codes': CodeLibraryArticulated tree}; the
auto-encoder's is {'encoder', 'field', 'joint_state_decoder',
'deg_embedding'}. The names below the generic pair are the ones earlier
callers use.

``opt_state_from_optax`` carries an optax optimizer state (as numpy, from
``jax.device_get``) into the port's ``OptState``: the moments (mu, nu),
SGD's momentum trace, the lookahead's slow weights, each converted like the
parameters, and the count that every optax count shares.
"""

from typing import Callable, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from aonerf_torch.train.optim import OptState

# the vanilla NeRFMLP's layers
MLP_LAYERS = tuple(f"pts_{i}" for i in range(8)) + ("density", "bottleneck", "views_0", "rgb")

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def flax_leaves(tree: Mapping, path=()):
    """(path tuple, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def module_state_dict_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict of a port module from its flax tree (optionally under
    'params'), each key led by ``prefix``."""
    out = {}
    for path, leaf in flax_leaves(_params(tree)):
        parts = []
        for k in path[:-1]:
            if k.startswith("_Norm_"):
                parts.append("norm" + k[len("_Norm_"):])
            elif k != "GroupNorm_0":
                parts.append(k)
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[prefix + ".".join(parts + [_LEAF_TO_TORCH[path[-1]]])] = torch.from_numpy(np.array(a, order="C"))
    return out


def _leaf(t: torch.Tensor, grads: bool, name: str) -> np.ndarray:
    t = t.grad if grads else t
    if t is None:
        raise ValueError(f"{name}: no gradient")
    return t.detach().cpu().numpy()


def module_flax_tree(module: nn.Module, grads: bool = False) -> Dict[str, Dict]:
    """The flax tree ({'params': ...}) of a port module's parameters, or
    with ``grads`` of their ``.grad``, as numpy arrays."""
    owners = dict(module.named_modules())
    root: Dict = {}
    for name, p in module.named_parameters():
        *path, attr = name.split(".")
        owner = owners[".".join(path)]
        a = _leaf(p, grads, name)
        node = root
        for k in path:
            if k.startswith("norm") and k[len("norm"):].isdigit():
                node = node.setdefault("_Norm_" + k[len("norm"):], {}).setdefault("GroupNorm_0", {})
            else:
                node = node.setdefault(k, {})
        if attr == "bias":
            node["bias"] = a.copy()
        elif isinstance(owner, nn.Conv2d):
            node["kernel"] = a.transpose(2, 3, 1, 0).copy()
        elif isinstance(owner, nn.Linear):
            node["kernel"] = a.T.copy()
        elif isinstance(owner, nn.Embedding):
            node["embedding"] = a.copy()
        else:  # a norm's scale
            node["scale"] = a.copy()
    return {"params": root}


def mlp_flax_tree(mlp, grads: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {kernel, bias}} of a port MLP (no 'params' level)."""
    return module_flax_tree(mlp, grads)["params"]


# the MLPs, the two-level fields and the code library
mlp_state_dict_from_flax = nerf_state_dict_from_flax = articulated_state_dict_from_flax = module_state_dict_from_flax
codes_state_dict_from_flax = module_state_dict_from_flax
nerf_flax_tree = articulated_flax_tree = codes_flax_tree = module_flax_tree


# optax state fields that hold one entry per parameter: the port's slot names
_OPTAX_SLOTS = ("mu", "nu", "trace", "slow")


def _array_leaves_only(tree):
    """``tree`` without the leaves that are not arrays (optax's MaskedNode
    where a multi_transform side does not own a parameter)."""
    if isinstance(tree, Mapping):
        out = {k: _array_leaves_only(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    return tree if hasattr(tree, "shape") else None


def opt_state_from_optax(state, names: List[str], to_port: Callable = module_state_dict_from_flax):
    """The port's ``OptState`` of an optax state: each per-parameter field
    (mu, nu, trace, slow) through ``to_port`` (flax tree -> {port name:
    tensor}) into a list in ``names``' order, None for a parameter the field
    does not cover; the count, which every count of the state must equal."""
    slots: Dict[str, Dict[str, torch.Tensor]] = {}
    counts = set()

    def visit(node):
        if hasattr(node, "_fields"):  # an optax NamedTuple state
            for field, value in zip(node._fields, node):
                if field == "count":
                    counts.add(int(np.asarray(value)))
                elif field in _OPTAX_SLOTS and isinstance(value, Mapping):
                    slots.setdefault(field, {}).update(to_port(_array_leaves_only(value)))
                else:
                    visit(value)
        elif isinstance(node, Mapping):
            for value in node.values():
                visit(value)
        elif isinstance(node, (tuple, list)):
            for value in node:
                visit(value)

    visit(state)
    if len(counts) != 1:
        raise ValueError(f"optax counts {sorted(counts)}: expected one shared count")
    return OptState(count=counts.pop(), slots={k: [v.get(n) for n in names] for k, v in slots.items()})
