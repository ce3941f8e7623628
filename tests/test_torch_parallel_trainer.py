"""The port's Trainer data parallel, on gloo ranks on the CPU
(``tests/torch_ddp_worker.py``: one launch of 2 ranks running every case in
order, one launch of 1 rank), against itself on one device.

  - a 2-rank vanilla ``fit``: the parameters identical on both ranks after
    every step; one set of checkpoints, val grids and metric rows, written
    by rank 0 (the names and row count of a one-device run's)
  - ``test()`` of that run's checkpoint on 2 ranks: the gathered images and
    the stats equal, bit for bit, a one-device ``test()`` of the same
    checkpoint (each view is rendered by the same code from the same
    parameters; the ranks render 2 and 1 of the 3 views)
  - a 2-rank run stopped at step 3 and resumed to 6: the parameters and the
    optimizer count of the unbroken 2-rank run, bit for bit
  - one rank under a process group: the plain one-device Trainer's
    parameters bit for bit
  - the auto-decoder with view-sharded buffers (3 views over 2 ranks: each
    holds 2 of them) and the auto-encoder on a ragged dataset (the
    host-batched step, each rank its rows of one batch): parameters
    identical on both ranks after every step
  - ``aonerf_torch.entry.dryrun_multichip(2)`` on the CPU prints its ok line,
    and the train CLI under ``torchrun`` runs with no flag of its own.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from aonerf_torch.data import synthetic
from aonerf_torch.entry import dryrun_multichip
from aonerf_torch.train.loop import Trainer
from aonerf_torch.utils.config import load_config
from tests.torch_ddp_worker import flat_params, run_ranks
from tests.torch_release import release_after_module, release_after_test  # noqa: F401 (autouse: frees files, heap)

torch.set_num_threads(2)

WH = (16, 12)
STEPS = 6
N_TEST = 3


def _vanilla(root, out, name):
    return {"root_dir": root, "output_path": out, "exp_name": name, "img_wh": list(WH), "platform": "cpu",
            "num_coarse_samples": 4, "num_fine_samples": 8, "batch_size": 32, "chunk": 64, "inner_steps": 1,
            "val_every_steps": 3, "ckpt_every_steps": 3, "limit_val_batches": 1, "lr_init": 1e-3,
            "lr_delay_steps": 0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_trainer")
    scene = synthetic.generate_single_scene(str(tmp / "scene"), img_wh=WH, n_train=2, n_val=1, n_test=N_TEST)
    multi = synthetic.generate_multi_scene(str(tmp / "multi"), img_wh=WH, n_instances=2, degrees=(0, 10, 20),
                                           n_images=3)
    ragged = synthetic.generate_multi_scene(str(tmp / "ragged"), img_wh=(64, 48), n_instances=2,
                                            degrees=(0, 10, 20), n_images=2)
    shutil.rmtree(os.path.join(ragged, sorted(os.listdir(ragged))[1], "train", "20_degree"))
    out = str(tmp / "out")
    ad = {"exp_type": "vanilla_autodecoder", "dataset_name": "sapien_multi", "root_dir": multi, "output_path": out,
          "exp_name": "ad", "img_wh": list(WH), "platform": "cpu", "num_coarse_samples": 4, "num_fine_samples": 4,
          "batch_size": 16, "chunk": 64, "inner_steps": 1, "val_every_steps": 2, "ckpt_every_steps": 4,
          "limit_val_batches": 1, "latent_dense": True, "lr_delay_steps": 0}
    ae = {"exp_type": "vanilla_ae_art", "dataset_name": "sapien_multi", "root_dir": ragged, "output_path": out,
          "exp_name": "ae", "img_wh": [64, 48], "platform": "cpu", "num_coarse_samples": 4, "num_fine_samples": 4,
          "batch_size": 16, "chunk": 1024, "inner_steps": 1, "val_every_steps": 100, "ckpt_every_steps": 100,
          "limit_val_batches": 1, "latent_dense": True, "lr_delay_steps": 0}
    two = run_ranks([
        ("fit", "trainer_fit", {"overrides": _vanilla(scene, out, "two"), "max_steps": STEPS}),
        ("test", "trainer_test", {"overrides": _vanilla(scene, out, "two")}),
        ("stop", "trainer_fit", {"overrides": _vanilla(scene, out, "resumed"), "max_steps": STEPS // 2}),
        ("resume", "trainer_fit", {"overrides": _vanilla(scene, out, "resumed"), "max_steps": STEPS}),
        ("ad", "trainer_fit", {"overrides": ad, "max_steps": 4}),
        ("ad_bytes", "buffer_bytes", {"overrides": ad}),
        ("ae", "trainer_fit", {"overrides": ae, "max_steps": 2}),
    ], 2)
    one = run_ranks([("fit", "trainer_fit", {"overrides": _vanilla(scene, out, "one_rank"), "max_steps": STEPS})],
                    1)
    plain = Trainer(load_config(None, _vanilla(scene, out, "plain")))
    try:
        plain_last = plain.fit(max_steps=STEPS)
    finally:
        plain.close()
    return {"two": two, "one": one[0], "plain": plain, "plain_last": plain_last, "out": out, "scene": scene,
            "ad": ad}


def test_two_ranks_hold_the_same_parameters_after_every_step(runs):
    for case, steps in (("fit", STEPS), ("stop", STEPS // 2), ("resume", STEPS // 2), ("ad", 4), ("ae", 2)):
        a, b = (r[case] for r in runs["two"])
        assert a["checked"] == b["checked"] == steps, case  # every step call held equal across the ranks
        assert np.array_equal(a["params"], b["params"]) and a["step"] == b["step"], case
        assert np.isfinite(a["params"]).all() and np.isfinite(a["last"]["loss"]), case


def test_rank_zero_writes_one_set_of_outputs(runs):
    out = runs["out"]

    def files(name):
        run = os.path.join(out, name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return sorted(os.listdir(os.path.join(run, "ckpts"))), sorted(os.listdir(os.path.join(run, "val_vis"))), \
            [sorted(r) for r in rows], [r["step"] for r in rows]

    assert files("two") == files("plain")
    assert set(runs["two"][0]["fit"]["last"]) == set(runs["plain_last"])  # the same metrics, val ones too


def test_gathered_test_images_equal_one_device(runs):
    got = runs["two"][0]["test"]
    trainer = Trainer(load_config(None, {**_vanilla(runs["scene"], runs["out"], "two"), "run_eval": True}))
    try:
        rgbs, depths, accs, _, _ = trainer.render_test_views()
        stats = trainer.test()
    finally:
        trainer.close()
    assert rgbs.shape == (N_TEST, WH[1], WH[0], 3)
    for k, want in (("rgb", rgbs), ("depth", depths), ("acc", accs)):
        for r in runs["two"]:  # every rank holds every view
            np.testing.assert_array_equal(r["test"][k], want, err_msg=k)
    assert json.dumps(got["stats"]) == json.dumps(stats)
    with open(os.path.join(runs["out"], "two", "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(stats))


def test_resume_matches_the_unbroken_run(runs):
    a, b = runs["two"][0]["fit"], runs["two"][0]["resume"]
    assert b["step"] == a["step"] == STEPS and b["count"] == a["count"] == STEPS
    np.testing.assert_array_equal(b["params"], a["params"])


def test_one_rank_is_the_one_device_trainer(runs):
    plain = runs["plain"]
    np.testing.assert_array_equal(runs["one"]["fit"]["params"], flat_params(plain.state.params.values()))
    assert runs["one"]["fit"]["count"] == plain.state.opt_state.count == STEPS


def test_sharded_scene_buffers_hold_the_rank_view_slice(runs):
    # 3 views over 2 ranks: padded cyclically to 4, each rank holds 2
    trainer = Trainer(load_config(None, runs["ad"]))
    try:
        whole = {k: v.numel() * v.element_size() for k, v in trainer.train_buffers().items()}
    finally:
        trainer.close()
    for r in runs["two"]:
        got = r["ad_bytes"]
        for k in ("rgb", "mask", "c2w"):
            assert got[k] * 3 == whole[k] * 2, k
        assert got["directions"] == whole["directions"] and got["deg"] == whole["deg"]


def test_dryrun_multichip_prints_ok(capfd):
    line = dryrun_multichip(2, platform="cpu")
    assert line.startswith("dryrun_multichip ok: mesh=(2x1)")
    assert "dryrun_multichip ok" in capfd.readouterr().out


def test_cli_under_torchrun(runs, tmp_path):
    # the train CLI under torchrun with no flag of its own: 2 gloo ranks on
    # the CPU, one JSON line printed (rank 0's), one set of outputs
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [f"--{k}={json.dumps(v) if not isinstance(v, str) else v}"
            for k, v in _vanilla(runs["scene"], str(tmp_path), "cli").items()]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "aonerf_torch.cli.train", *args, "--max_steps", "3"],
                          cwd=root, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(printed) == 1 and np.isfinite(printed[0]["loss"]) and "val_psnr" in printed[0]
    assert sorted(os.listdir(os.path.join(tmp_path, "cli", "ckpts"))) == ["ckpt_00000003.pt", "metrics.json"]
