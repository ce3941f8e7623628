"""Checkpoints of a train state: step, params, optimizer state
(counterpart of ``aonerf.utils.ckpt``).

Each checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``; the
directory's ``metrics.json`` keeps each step's val PSNR. Retention is the
JAX manager's (orbax's ``BestN`` with ``keep_checkpoints_without_metrics``):
while more than ``keep`` checkpoints exist, the ``keep`` with the best val
PSNR (of equal ones, the later) and every checkpoint saved without a PSNR
stay, and the rest go, the latest too; ``keep=None`` keeps every checkpoint.
``best_step`` is the kept step of the highest PSNR, and a run resumes from
``latest_step``, the latest step kept.

The surgery helpers work on parameters by state-dict name (the port's
``TrainState.params``, a checkpoint's ``params``): ``load_partial`` copies
what fits, ``load_params_subtree`` grafts one subtree. Their paths and
prefixes are given as the JAX package gives them, flax paths ('codes',
'model/coarse_mlp/pts_0'), and mapped to state-dict names by
``utils.bridge``'s rules.
"""

import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: Optional[int] = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._metrics_path = os.path.join(self.directory, "metrics.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def _metrics(self) -> Dict[int, Optional[float]]:
        if not os.path.exists(self._metrics_path):
            return {}
        with open(self._metrics_path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def steps(self) -> list:
        return sorted(
            int(n[5:-3]) for n in os.listdir(self.directory) if n.startswith("ckpt_") and n.endswith(".pt")
        )

    def save(self, step: int, state: Dict[str, Any], val_psnr: Optional[float] = None) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        metrics = self._metrics()
        metrics[int(step)] = None if val_psnr is None else float(val_psnr)
        steps = self.steps()
        if self.keep is not None and len(steps) > self.keep:
            # ascending by PSNR, ties in step order (a stable sort, as orbax's)
            scored = sorted((s for s in steps if metrics.get(s) is not None), key=lambda s: metrics[s])
            kept = set()
            if self.keep > 0:
                kept = set(scored[-self.keep:]) | {s for s in steps if metrics.get(s) is None}
            for s in steps:
                if s not in kept:
                    os.remove(self._path(s))
                    metrics.pop(s, None)
        with open(self._metrics_path, "w") as f:
            json.dump({str(k): v for k, v in sorted(metrics.items())}, f)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The kept step with the highest val PSNR (of equal ones, the
        latest); None when no kept checkpoint has one (orbax's best_step with
        best_mode 'max')."""
        metrics = self._metrics()
        scored = [(metrics[s], s) for s in self.steps() if metrics.get(s) is not None]
        return max(scored)[1] if scored else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The saved dict of ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)


def state_dict_prefix(flax_prefix: str) -> str:
    """A flax path prefix ('model/params/coarse_mlp', 'encoder/_Norm_1') as
    the prefix of the state-dict names under it ('model.coarse_mlp',
    'encoder.norm1'): ``utils.bridge``'s renaming, component by component,
    flax's 'params' collection dropped."""
    parts = []
    for k in flax_prefix.split("/"):
        if k == "params":
            continue
        if k.startswith("_Norm_"):
            parts.append("norm" + k[len("_Norm_"):])
        elif k in ("kernel", "scale", "embedding"):
            parts.append("weight")
        elif k != "GroupNorm_0":
            parts.append(k)
    return ".".join(parts)


def load_partial(
    params: Mapping[str, torch.Tensor],
    restored_params: Mapping[str, torch.Tensor],
    prefixes_to_ignore: Sequence[str] = (),
) -> Dict[str, torch.Tensor]:
    """Non-strict checkpoint surgery (counterpart of
    ``aonerf.utils.ckpt.load_partial``): every restored tensor whose name is
    in ``params`` with the same shape, and not under one of
    ``prefixes_to_ignore`` (flax path prefixes), replaces the one there;
    everything else is left as it is. Returns a new dict; ``params`` is not
    modified."""
    ignore = [state_dict_prefix(p) for p in prefixes_to_ignore]
    out = dict(params)
    for name, leaf in restored_params.items():
        if any(name.startswith(p) for p in ignore):
            continue
        if name in params and tuple(params[name].shape) == tuple(leaf.shape):
            out[name] = leaf
    return out


def load_params_subtree(state, restored, subtree: str):
    """Checkpoint surgery: graft one parameter subtree (e.g. 'codes', the
    reference's latent-code load) from ``restored`` (a train state, or a
    checkpoint's dict with 'params') into ``state``'s parameters, in place;
    returns ``state`` (counterpart of ``aonerf.utils.ckpt.load_params_subtree``).
    Raises KeyError when ``restored`` has no such subtree, ValueError when a
    shape differs."""
    source = restored["params"] if isinstance(restored, Mapping) else restored.params
    prefix = state_dict_prefix(subtree) + "."
    names = [n for n in state.params if n.startswith(prefix)]
    missing = [n for n in names if n not in source]
    if not names or missing:
        raise KeyError(f"subtree {subtree!r}: not in the restored params ({missing or prefix})")
    with torch.no_grad():
        for n in names:
            p = state.params[n]
            if tuple(p.shape) != tuple(source[n].shape):
                raise ValueError(f"{n}: shape {tuple(source[n].shape)}, expected {tuple(p.shape)}")
            p.copy_(source[n])
    return state
