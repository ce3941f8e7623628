"""CLI launcher: ``python -m aonerf_torch.cli.train --config cfg.json
[--run_eval | --run_optimize] [--max_steps N] [--<field> <value> ...]``
(counterpart of ``aonerf.cli.train``).

By default it trains (``Trainer.fit``) and prints the last metrics. With
``--run_eval`` it restores the latest checkpoint (or ``--ckpt_path`` /
``--weight_path``), renders and scores the test views (``Trainer.test``)
and prints the stats. With ``--run_optimize`` (auto-decoder) it restores the
same way, fits fresh codes for ``optimize_instance`` with the field frozen
(``Trainer.optimize_instance_codes``) and prints {"psnr1": [...]}. Any Config field can be overridden as --<name>
<value>, or by the reference's flag name (e.g. --save_path for
--render_name); values are read as JSON where they parse. Runs on the CUDA
card unless ``--platform cpu``.

Data parallel on N cards of one host, with no flag of its own:

    torchrun --standalone --nproc_per_node N -m aonerf_torch.cli.train --config cfg.json

(rank r on cuda:r under NCCL; ``--platform cpu`` runs the ranks on the CPU
under gloo, ``--platform cuda:0`` puts them all on that card under gloo).
Rank 0 prints the result.
"""

import argparse
import dataclasses
import json
from typing import Dict

from aonerf_torch.parallel import distributed
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils.config import ALIASES, Config, load_config


def add_config_fields(p: argparse.ArgumentParser, skip=("extras",)) -> None:
    """One --<name> option (and its reference aliases) for each Config field."""
    for f in dataclasses.fields(Config):
        if f.name in skip:
            continue
        aliases = [f"--{a}" for a, name in ALIASES.items() if name == f.name]
        p.add_argument(f"--{f.name}", *aliases, dest=f.name, type=str, default=None)


def config_overrides(args: argparse.Namespace) -> Dict:
    """The Config fields given on the command line, read as JSON where they
    parse."""
    names = {f.name for f in dataclasses.fields(Config)}
    overrides = {}
    for k, v in vars(args).items():
        if k not in names or v is None:
            continue
        try:
            overrides[k] = json.loads(v) if isinstance(v, str) else v
        except json.JSONDecodeError:
            overrides[k] = v
    return overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--run_eval", action="store_true", default=None)
    p.add_argument("--run_optimize", action="store_true", default=None,
                   help="test-time code optimization for one instance (auto-decoder)")
    p.add_argument("--max_steps", type=int, default=None)
    add_config_fields(p, skip=("run_eval", "extras"))
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = load_config(args.config, config_overrides(args))
    trainer = Trainer(cfg)
    try:
        if args.run_optimize:
            out = {"psnr1": trainer.optimize_instance_codes()[1]["psnr1"]}
        elif cfg.run_eval:
            out = trainer.test()
        else:
            out = trainer.fit(max_steps=args.max_steps)
    finally:
        trainer.close()
    if distributed.is_main_process():
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
