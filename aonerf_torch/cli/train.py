"""CLI launcher: ``python -m aonerf_torch.cli.train --config cfg.json
[--max_steps N] [--<field> <value> ...]`` (counterpart of
``aonerf.cli.train``; fit only: ``--run_eval`` is not ported yet).

Any Config field can be overridden as --<name> <value>; values are read as
JSON where they parse. Runs on the CUDA card unless ``--platform cpu``.
"""

import argparse
import dataclasses
import json
from typing import Dict

from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils.config import Config, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--max_steps", type=int, default=None)
    for f in dataclasses.fields(Config):
        if f.name == "extras":
            continue
        p.add_argument(f"--{f.name}", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    overrides = {}
    for k, v in vars(args).items():
        if k in ("config", "max_steps") or v is None:
            continue
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    cfg = load_config(args.config, overrides)
    trainer = Trainer(cfg)
    try:
        metrics = trainer.fit(max_steps=args.max_steps)
    finally:
        trainer.close()
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
