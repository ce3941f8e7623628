"""Cases for the port's data-parallel tests, run on gloo ranks on the CPU.
Imports no JAX: the tests compute the JAX side in the pytest process.

``run_ranks(cases, world)`` runs every case [(name, kind, args)] in order
on ``world`` ranks spawned by ``aonerf_torch.entry.spawn_ranks`` (each with
torchrun's environment, joined through
``aonerf_torch.parallel.distributed.initialize('cpu')``), each as
``CASES[kind](**args)``, and returns each rank's {case name: result}, in
rank order.
"""

import numpy as np
import torch

from chip_smoke import CaptureTx, flat_params


def _run_cases(cases, threads: int) -> dict:
    torch.set_num_threads(threads)
    return {name: CASES[kind](**args) for name, kind, args in cases}


def run_ranks(cases, world: int, threads: int = 2, timeout: float = 600.0) -> list:
    """Each rank's {case name: result} of ``cases`` on ``world`` ranks."""
    from aonerf_torch.entry import spawn_ranks

    return spawn_ranks(_run_cases, world, "cpu", (cases, threads), timeout)


class QueueDraws:
    """Draws that hand out given arrays in order, each checked against the
    shape asked for (JAX's numbers, drawn in the pytest process)."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a))

    def randint(self, high, shape):
        a = self._next(shape)
        assert (a < high).all()
        return a.to(torch.int64)

    def uniform(self, shape):
        return self._next(shape)

    def exponential(self, shape):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)


def _f64(x):
    """Float arrays (alone, in a list or a dict) as float64; others as they are."""
    if isinstance(x, dict):
        return {k: _f64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_f64(v) for v in x]
    return x.astype(np.float64) if np.issubdtype(np.asarray(x).dtype, np.floating) else x


def _result(state, tx, metrics):
    names = list(state.params)
    return {"grads": {n: None if g is None else g.numpy() for n, g in zip(names, tx.grads)},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def bounds_and_gather(rows):
    """local_shard_bounds(n) and gather_images of each rank's rows [start,
    stop) of each array of ``rows`` (n = its length)."""
    from aonerf_torch.parallel import distributed

    out = []
    for a in rows:
        start, stop = distributed.local_shard_bounds(len(a))
        out.append(((start, stop), distributed.gather_images(a[start:stop], len(a))))
    return out


def vanilla_step(state_dict, sc, nf, buffers, batch_size, draws, double=False):
    """One vanilla step of the whole batch's ``draws`` (idx, u, e) over the
    ranks; the all-reduced gradients and the metrics. ``double``: the model,
    buffers and draws in float64 (an oracle; the caller supplies a level
    that runs in it)."""
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep

    nerf = NeRF(num_coarse_samples=sc, num_fine_samples=nf, device="cpu")
    nerf.load_state_dict(state_dict)
    if double:
        nerf, buffers, draws = nerf.double(), _f64(buffers), _f64(draws)
    tx = CaptureTx()
    step = tstep.make_vanilla_train_step(nerf, tx, True, 2.0, 6.0, batch_size=batch_size, mesh=make_mesh())
    state, metrics = step(tstep.create_train_state(nerf, tx), {k: torch.from_numpy(v) for k, v in buffers.items()},
                          0, draws=QueueDraws(draws))
    return _result(state, tx, metrics)


def _rank_buffers(buffers, sharded):
    from aonerf_torch.parallel.mesh import make_mesh, shard_multi_buffers

    if sharded:
        buffers = shard_multi_buffers(make_mesh(), buffers)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in buffers.items()}


def autodecoder_step(state_dict, sc, nf, buffers, batch_size, draws, sharded, double=False):
    """One auto-decoder device step, each rank on its own ``draws[rank]``
    (replicated or view-sharded buffers); the averaged gradients and the
    metrics."""
    from torch import nn

    from aonerf_torch.models.articulated import ArticulatedNeRF
    from aonerf_torch.models.codes import CodeLibraryArticulated
    from aonerf_torch.parallel import distributed
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep

    model = ArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=True, device="cpu")
    lib = CodeLibraryArticulated(device="cpu")
    trained = nn.ModuleDict({"model": model, "codes": lib})
    trained.load_state_dict(state_dict)
    if double:
        trained, buffers, draws = trained.double(), _f64(buffers), _f64(draws)
    tx = CaptureTx()
    step = tstep.make_autodecoder_device_train_step(model, lib, tx, True, 2.0, 6.0, batch_size=batch_size,
                                                    mesh=make_mesh(), sharded_views=sharded)
    state, metrics = step(tstep.create_train_state(trained, tx), _rank_buffers(buffers, sharded), 0,
                          draws=QueueDraws(draws[distributed.rank()]))
    return _result(state, tx, metrics)


def autodecoder_host_step(state_dict, sc, nf, batch, draws, double=False):
    """One host-batched auto-decoder step: every rank is given the whole
    ``batch`` and the whole batch's render ``draws``; the summed gradients
    and the metrics (one rank: the one-device step)."""
    from torch import nn

    from aonerf_torch.models.articulated import ArticulatedNeRF
    from aonerf_torch.models.codes import CodeLibraryArticulated
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep

    model = ArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=True, device="cpu")
    lib = CodeLibraryArticulated(device="cpu")
    trained = nn.ModuleDict({"model": model, "codes": lib})
    trained.load_state_dict(state_dict)
    if double:
        trained, batch, draws = trained.double(), _f64(batch), _f64(draws)
    tx = CaptureTx()
    mesh = make_mesh()
    step = tstep.make_autodecoder_train_step(model, lib, tx, True, 2.0, 6.0, mesh=mesh if mesh.n_data > 1 else None)
    state, metrics = step(tstep.create_train_state(trained, tx), {k: torch.from_numpy(np.array(v)) for k, v in
                                                                  batch.items()}, 0, draws=QueueDraws(draws))
    return _result(state, tx, metrics)


def _ae_model(sc, nf):
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF

    return AutoEncoderArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=True,
                                      generator=torch.Generator().manual_seed(0), device="cpu")


def ae_step(sc, nf, buffers, img_wh, batch_size, draws, sharded, views_per_step=1, double=False):
    """One auto-encoder device step (the port's AE from seed 0), each rank
    on its own ``draws[rank]``; the averaged gradients and the metrics."""
    from aonerf_torch.parallel import distributed
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep
    from aonerf_torch.train.step_ae import make_ae_device_train_step

    model = _ae_model(sc, nf)
    if double:
        model, buffers, draws = model.double(), _f64(buffers), _f64(draws)
    tx = CaptureTx()
    step = make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=img_wh, batch_size=batch_size,
                                     mesh=make_mesh(), sharded_views=sharded, views_per_step=views_per_step)
    state, metrics = step(tstep.create_train_state(model, tx), _rank_buffers(buffers, sharded), 0,
                          draws=QueueDraws(draws[distributed.rank()]))
    return _result(state, tx, metrics)


def ae_reuse_steps(sc, nf, buffers, img_wh, batch_size, draws, sharded):
    """One encode-reuse group of 2 steps, each rank on its own draws a step
    (``draws[rank][step]``): a full step, then a field-only step on its
    detached latents; the last (field-only, averaged) gradients, None for
    the frozen parameters, and the group's metrics."""
    from aonerf_torch.parallel import distributed
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep
    from aonerf_torch.train.step_ae import make_ae_device_train_step

    model = _ae_model(sc, nf)
    tx = CaptureTx()
    step = make_ae_device_train_step(model, tx, True, 2.0, 6.0, img_wh=img_wh, batch_size=batch_size, inner_steps=2,
                                     encode_reuse=2, mesh=make_mesh(), sharded_views=sharded)
    mine = draws[distributed.rank()]
    state, metrics = step(tstep.create_train_state(model, tx), _rank_buffers(buffers, sharded), 0,
                          draws_for=lambda s: QueueDraws(mine[s]))
    return _result(state, tx, metrics)


def ae_host_step(sc, nf, batch, draws, photometric, double=False):
    """One host-batched auto-encoder step: every rank is given the whole
    ``batch`` and the whole batch's render ``draws``; the summed gradients
    and the metrics (one rank: the one-device step)."""
    from aonerf_torch.parallel.mesh import make_mesh
    from aonerf_torch.train import step as tstep
    from aonerf_torch.train.step_ae import make_ae_train_step

    model = _ae_model(sc, nf)
    if double:
        model, batch, draws = model.double(), _f64(batch), _f64(draws)
    tx = CaptureTx()
    mesh = make_mesh()
    step = make_ae_train_step(model, tx, True, 2.0, 6.0, photometric=photometric,
                              mesh=mesh if mesh.n_data > 1 else None)
    state, metrics = step(tstep.create_train_state(model, tx), {k: torch.from_numpy(np.array(v)) for k, v in
                                                                batch.items()}, 0, draws=QueueDraws(draws))
    return _result(state, tx, metrics)


def trainer_fit(overrides, max_steps, check_every_step=True):
    """Trainer.fit to ``max_steps``; after every step call the parameters
    are held equal on every rank. Returns the flat parameters, the
    optimizer count and the number of steps checked."""
    from unittest import mock

    from aonerf_torch.parallel import distributed
    from aonerf_torch.train import loop
    from aonerf_torch.utils.config import load_config

    checked = [0]

    def checking(step_fn):  # the step, then the parameters held equal on every rank
        def checked_step(state, *args):
            state, metrics = step_fn(state, *args)
            if check_every_step:
                flat = flat_params(state.params.values())
                for r, other in enumerate(distributed.all_gather_host(flat)):
                    assert np.array_equal(other, flat), f"rank {r}'s parameters differ after step {state.step}"
                checked[0] += 1
            return state, metrics

        return checked_step

    trainer = loop.Trainer(load_config(None, overrides))
    trainer.step_fn = checking(trainer.step_fn)
    host_step = loop.make_ae_train_step  # a ragged dataset's step, made in fit
    try:
        with mock.patch.object(loop, "make_ae_train_step", lambda *a, **k: checking(host_step(*a, **k))):
            last = trainer.fit(max_steps=max_steps)
    finally:
        trainer.close()
    return {"params": flat_params(trainer.state.params.values()), "count": trainer.state.opt_state.count,
            "step": trainer.state.step, "checked": checked[0], "last": last}


def trainer_test(overrides):
    """Trainer.test of the run's latest checkpoint: the gathered images and
    the stats."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    trainer = Trainer(load_config(None, {**overrides, "run_eval": True}))
    try:
        rgbs, depths, accs, _, _ = trainer.render_test_views()
        stats = trainer.test()
    finally:
        trainer.close()
    return {"rgb": rgbs, "depth": depths, "acc": accs, "stats": stats}


def buffer_bytes(overrides):
    """The bytes of the train buffers this rank holds, by name."""
    from aonerf_torch.train.loop import Trainer
    from aonerf_torch.utils.config import load_config

    trainer = Trainer(load_config(None, overrides))
    try:
        return {k: v.numel() * v.element_size() for k, v in trainer.train_buffers().items()}
    finally:
        trainer.close()


CASES = {f.__name__: f for f in (bounds_and_gather, vanilla_step, autodecoder_step, autodecoder_host_step, ae_step,
                                  ae_reuse_steps, ae_host_step, trainer_fit, trainer_test, buffer_bytes)}
