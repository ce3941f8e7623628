"""Process-group set-up and cross-process collection (counterpart of
``aonerf.parallel.distributed``).

The reference's multi-GPU story is single-node DDP over NCCL: rank-0 gating
and an all-gather for eval collation. Here:

  initialize()          -> joins the process group torchrun describes
                           (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
                           MASTER_PORT); without them a no-op, and the
                           one-device Trainer runs as before
  is_main_process()     -> rank 0 (the reference's rank-0 gate)
  local_shard_bounds(n) -> this rank's contiguous [start, stop) of n items
  gather_images()       -> each rank's rendered rows -> all rows on every
                           rank (the reference's alter_gather_cat)

The device and backend rule, printed by ``initialize``:
  - by default rank r runs on ``cuda:LOCAL_RANK`` under NCCL, and raises
    when the host has fewer cards than local ranks;
  - ``platform="cpu"`` runs on the CPU under gloo;
  - one explicit card for every rank (``platform="cuda:0"``, several ranks
    sharing it) runs gloo: NCCL refuses two ranks on one device.

Gloo takes CUDA tensors for all_reduce and broadcast only and has no
``ReduceOp.AVG``, so means are a SUM then a division; host rows (images,
counters) are gathered as CPU tensors through a gloo group (the default
group under gloo, a second group under NCCL).
"""

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from aonerf_torch import default_device

_device: Optional[torch.device] = None
_host_group = None
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a rank that fails stops the others at their next collective within this
# (torch's default is 10 or 30 minutes)
TIMEOUT = datetime.timedelta(seconds=600)


def launched() -> bool:
    """True when the environment describes a process group (torchrun's)."""
    return all(k in os.environ for k in _ENV)


def initialize(platform: Optional[str] = None) -> torch.device:
    """Join the process group the environment describes, once, and return
    this rank's device; without one, ``default_device(platform)``.

    ``platform`` None: ``cuda:LOCAL_RANK`` under NCCL; ``"cpu"``: gloo;
    an explicit card (``"cuda:0"``): that card under gloo."""
    global _device, _host_group
    if _device is not None:
        return _device
    if not launched():
        return default_device(platform)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if platform is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards < local_world:
            raise RuntimeError(
                f"{local_world} local ranks need as many CUDA cards, this host has {n_cards}; pass "
                "platform='cuda:0' to share one card under gloo, or platform='cpu'"
            )
        device, backend = torch.device("cuda", local_rank), "nccl"
    else:
        device = default_device(platform)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        backend = "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT, **kwargs)
    _host_group = dist.new_group(backend="gloo", timeout=TIMEOUT) if backend == "nccl" else dist.group.WORLD
    _device = device
    print(f"aonerf_torch.parallel: rank {rank} of {world} (local {local_rank} of {local_world}) on {device} "
          f"under {backend}", flush=True)
    return device


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _device, _host_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device = _host_group = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """The reference's rank-0 gate."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_host_group)


def local_shard_bounds(n: int) -> tuple:
    """[start, stop) of this rank's contiguous shard of n items (empty, with
    stop < start as JAX's, for a rank past the last item)."""
    per = -(-n // world_size())
    start = rank() * per
    return start, min(start + per, n)


def all_gather_host(rows: np.ndarray) -> List[np.ndarray]:
    """Every rank's ``rows`` (one shape and dtype on every rank), in rank
    order, through the host group."""
    if world_size() == 1:
        return [np.asarray(rows)]
    local = torch.from_numpy(np.ascontiguousarray(rows))
    out = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(out, local, group=_host_group)
    return [t.numpy() for t in out]


def gather_images(local_rows: np.ndarray, total_rows: int) -> np.ndarray:
    """All-gather each rank's rendered rows and trim the padding:
    ``local_rows`` are rows [start, stop) of ``local_shard_bounds(total_rows)``;
    a ragged last shard is zero-padded to the common count before the
    gather, and the rows in rank order are trimmed to ``total_rows``.
    Identity (plus trim) on one process."""
    local_rows = np.asarray(local_rows)
    if world_size() == 1:
        return local_rows[:total_rows]
    per = -(-total_rows // world_size())
    if local_rows.shape[0] < per:
        pad = np.zeros((per - local_rows.shape[0], *local_rows.shape[1:]), local_rows.dtype)
        local_rows = np.concatenate([local_rows, pad], axis=0)
    return np.concatenate(all_gather_host(local_rows), axis=0)[:total_rows]


def all_reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, in one collective of their
    flat concatenation (fp32 tensors on one device)."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in one collective."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
