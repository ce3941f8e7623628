"""Entry points (counterpart of ``__graft_entry__``): the full-size forward
and a multi-rank dry run of the three experiment types.

    python -c "from aonerf_torch.entry import dryrun_multichip as d; d(2, platform='cpu')"

``dryrun_multichip(n)`` spawns ``n`` ranks (spawn, never fork: the caller
may hold a CUDA context), each on ``cuda:rank`` under NCCL by default, on
the CPU under gloo with ``platform='cpu'``, or on one shared card under
gloo with ``platform='cuda:0'``.
"""

import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from aonerf_torch import DeviceLike, default_device


def _rays(n: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d).to(device)
    return {"rays_o": -4.0 * d, "rays_d": d, "viewdirs": d}


def entry(device: DeviceLike = None) -> Tuple:
    """(fn, example_args): the forward of the full-size hierarchical vanilla
    NeRF (64 coarse + 128 fine samples, the 8x256 field, weights from seed
    0), fn(rays) -> the fine level's rgb, on 256 example rays."""
    from aonerf_torch.models.nerf import NeRF

    dev = default_device(device)
    model = NeRF(generator=torch.Generator().manual_seed(0), device=dev).eval()

    @torch.no_grad()
    def fn(rays):
        return model(rays, False, True, 2.0, 6.0)[1][0]

    return fn, (_rays(256, dev),)


def _multi_buffers(h=12, w=16, n_i=2, n_d=2, n_v=2, seed=3):
    """Tiny rectangular multi-scene buffers in the
    ``SapienMultiDataset.device_buffers()`` layout."""
    rng = np.random.default_rng(seed)
    hw = h * w
    c2w = np.tile(np.eye(3, 4, dtype=np.float32), (n_i, n_d, n_v, 1, 1))
    c2w[..., 2, 3] = 4.0
    dirs = rng.standard_normal((hw, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.5
    return {
        "rgb": rng.integers(0, 255, (n_i, n_d, n_v, hw, 3), dtype=np.uint8),
        "mask": rng.integers(0, 2, (n_i, n_d, n_v, hw)).astype(np.uint8),
        "c2w": c2w,
        "directions": dirs,
        "deg": np.deg2rad(np.arange(n_d) * 45.0).astype(np.float32),
    }


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> None:
    """The environment torchrun gives rank ``rank`` of ``world`` on one host."""
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})


def _rank_main(rank: int, world: int, port: int, platform: Optional[str], fn, args, queue) -> None:
    """Rank ``rank`` of ``spawn_ranks``: torchrun's environment, the group,
    fn(*args); puts (rank, result, None) or (rank, None, traceback)."""
    import traceback

    from aonerf_torch.parallel import distributed

    rank_env(rank, world, port)
    try:
        distributed.initialize(platform)
        queue.put((rank, fn(*args), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        distributed.shutdown()


def spawn_ranks(fn, world: int, platform: Optional[str] = None, args=(), timeout: float = 600.0) -> list:
    """fn(*args) on each of ``world`` spawned ranks of one process group
    (spawn, never fork: the caller may hold a CUDA context), each joined
    through ``parallel.distributed.initialize(platform)``; their results in
    rank order. ``fn`` is a module-level function. Raises RuntimeError with
    a failing rank's traceback; every rank started is stopped."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, platform, fn, args, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:  # drain the queue before joining
            if not queue.empty():
                r, res, error = queue.get()
                if error is not None:
                    raise RuntimeError(f"rank {r} of {world} failed:\n{error}")
                results[r] = res
            elif time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(f"ranks of {world} ended or timed out: exit codes {[p.exitcode for p in procs]}")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _dryrun_rank(n: int) -> Optional[str]:
    """One rank of ``dryrun_multichip``; rank 0 returns its ok line."""
    from aonerf_torch.eval.render import make_image_renderer
    from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
    from aonerf_torch.models.articulated import ArticulatedNeRF
    from aonerf_torch.models.codes import CodeLibraryArticulated
    from aonerf_torch.models.nerf import NeRF
    from aonerf_torch.parallel import distributed
    from aonerf_torch.parallel.mesh import make_mesh, shard_multi_buffers
    from aonerf_torch.train import step as step_mod
    from aonerf_torch.train.step_ae import make_ae_device_train_step

    dev, rank = distributed.initialize(), distributed.rank()
    if dev.type == "cpu":  # the host's cores shared between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh = make_mesh()
    losses, modules = {}, {}

    # vanilla: the whole batch's rays over the ranks, 16 rows (one ray tile) each
    model = NeRF(num_coarse_samples=8, num_fine_samples=16, generator=torch.Generator().manual_seed(0),
                 device=dev)
    batch_size = 16 * n
    buffers = _rays(4 * batch_size, dev, seed=1)
    buffers["target"] = torch.from_numpy(
        np.random.default_rng(1).uniform(size=(4 * batch_size, 3)).astype(np.float32)).to(dev)
    tx = step_mod.make_adam()
    step = step_mod.make_vanilla_train_step(model, tx, True, 2.0, 6.0, batch_size=batch_size, mesh=mesh)
    _, m = step(step_mod.create_train_state(model, tx), buffers, 0)
    losses["vanilla"], modules["vanilla"] = float(m["loss"]), model

    # the articulated types: per-rank sampling from view-sharded buffers
    host = _multi_buffers(n_v=max(2, n))
    local = shard_multi_buffers(mesh, host) if n > 1 else host
    mbuf = {k: torch.from_numpy(v).to(dev) for k, v in local.items()}
    ddp_batch = 16
    g = torch.Generator().manual_seed(1)
    ad = ArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True, generator=g, device=dev)
    lib = CodeLibraryArticulated(n_max_objs=2, generator=g, device=dev)
    trained = torch.nn.ModuleDict({"model": ad, "codes": lib})
    ad_step = step_mod.make_autodecoder_device_train_step(
        ad, lib, tx, True, 2.0, 6.0, batch_size=ddp_batch, mesh=mesh, sharded_views=n > 1)
    _, m = ad_step(step_mod.create_train_state(trained, tx), mbuf, 2)
    losses["vanilla_autodecoder"], modules["vanilla_autodecoder"] = float(m["loss"]), trained

    h, w = 12, 16
    ae = AutoEncoderArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, latent_dense=True,
                                    generator=torch.Generator().manual_seed(2), device=dev)
    ae_step = make_ae_device_train_step(ae, tx, True, 2.0, 6.0, img_wh=(w, h), batch_size=ddp_batch,
                                        mesh=mesh, sharded_views=n > 1)
    _, m = ae_step(step_mod.create_train_state(ae, tx), mbuf, 4)
    losses["vanilla_ae_art"], modules["vanilla_ae_art"] = float(m["loss"]), ae
    for name, loss in losses.items():
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} in {name} multichip dryrun")

    # every rank ends each step with the same parameters
    for name, module in modules.items():
        flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()]).cpu().numpy()
        for r, other in enumerate(distributed.all_gather_host(flat)):
            if not np.array_equal(other, flat):
                raise AssertionError(f"{name}: rank {r}'s parameters differ from rank {rank}'s")

    # the test path: each rank renders its rows of one view, gathered
    rays = _rays(96, dev, seed=5)
    with torch.no_grad():
        latents = {k: torch.atleast_2d(v) for k, v in lib(0, 0).items()}
    render = make_image_renderer(ad, True, 2.0, 6.0, chunk=8)
    start, stop = distributed.local_shard_bounds(96)
    mine = render({k: v[start:stop] for k, v in rays.items()}, latents)[0].cpu().numpy()
    gathered = distributed.gather_images(mine, 96)
    whole = render(rays, latents)[0].cpu().numpy()
    np.testing.assert_allclose(gathered, whole, rtol=1e-5, atol=1e-5)

    if rank == 0:
        return (f"dryrun_multichip ok: mesh=({mesh.n_data}x{mesh.n_model}) on {dev} "
                + " ".join(f"{k}_loss={v:.4f}" for k, v in losses.items())
                + f" | autodecoder and ae buffers view-sharded over {n} ranks; parameters identical on every "
                "rank; gathered render == one-rank render | n_model=1: the port has no tensor parallelism "
                "(ROADMAP Queue 1 item 12)")
    return None


def dryrun_multichip(n_devices: int, platform: Optional[str] = None) -> str:
    """One train step of each experiment type (vanilla with the batch's
    rays split over the ranks; the auto-decoder and the auto-encoder
    sampling per rank from view-sharded buffers, each rank encoding its own
    views) on ``n_devices`` spawned ranks, then one view rendered in parts
    and gathered against the whole render; asserts the parameters are
    identical on every rank and prints (and returns) the line with 'ok'."""
    line = spawn_ranks(_dryrun_rank, n_devices, platform, (n_devices,))[0]
    print(line, flush=True)
    return line
