"""Metric logging to ``{run_dir}/metrics.jsonl`` (counterpart of
``aonerf.utils.logging``; the optional wandb stream is not ported)."""

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self._path, "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float], prefix: Optional[str] = None) -> None:
        flat = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": int(step), "t": time.time(), **flat}) + "\n")

    def close(self) -> None:
        self._f.close()
