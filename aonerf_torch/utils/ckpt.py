"""Checkpoints of a train state: step, params, optimizer state
(counterpart of ``aonerf.utils.ckpt``).

Each checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``; the
directory's ``metrics.json`` keeps each step's val PSNR. Retention follows
the JAX manager's options: the ``keep`` checkpoints with the best val PSNR,
every checkpoint saved without a PSNR, and always the latest.
"""

import json
import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
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
        scored = sorted((s for s in steps if metrics.get(s) is not None), key=lambda s: -metrics[s])
        for s in scored[self.keep :]:
            if s != steps[-1]:
                os.remove(self._path(s))
                metrics.pop(s, None)
        with open(self._metrics_path, "w") as f:
            json.dump({str(k): v for k, v in sorted(metrics.items())}, f)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The saved dict of ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)
