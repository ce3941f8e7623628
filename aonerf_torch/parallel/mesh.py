"""The ranks' (data, model) grid and the data-parallel splits (counterpart of
``aonerf.parallel.mesh``).

JAX places arrays on a device mesh and lets XLA emit the gradient
all-reduce; here each rank is one process of a ``torch.distributed`` group
and holds its own share of the data, and the train steps all-reduce the
gradients themselves (``train.step``). ``make_mesh`` gives the grid and
this rank's place on it; ``shard_batch`` and ``shard_multi_buffers`` cut
this rank's share out of a host batch or the articulated scene buffers as
JAX's shardings lay it on device ``data_index``.

The ``model`` axis (tensor parallelism) is described (``tp_param_spec``)
but not run: the Trainer refuses ``n_model_shards`` > 1.
"""

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from aonerf_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks and this rank's coordinates on it;
    ranks are laid out data-major, as JAX's mesh lays out devices."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    def rows(self, n: int, tile: int = 1) -> Tuple[int, int]:
        """[start, stop) of this rank's contiguous share of ``n`` rows over
        the data axis, in whole ``tile``s of rows split as evenly as they
        go (the first ranks one tile more, as ``numpy.array_split``; the
        last tile may be short)."""
        q, rem = divmod(-(-n // tile), self.n_data)
        first = self.data_index * q + min(self.data_index, rem)
        count = q + (self.data_index < rem)
        return min(first * tile, n), min((first + count) * tile, n)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The grid of the process group's ranks (one rank and a 1x1 grid
    without one): all of them on ``data`` by default; ``rank`` and
    ``world_size`` default to the group's."""
    world = distributed.world_size() if world_size is None else world_size
    rank = distributed.rank() if rank is None else rank
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, the group has {world}")
    return Mesh(n_data=n_data, n_model=n_model, data_index=rank // n_model, model_index=rank % n_model)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's share of a batch dict: arrays whose leading axis divides
    by the data axis (and is at least as long) keep their contiguous
    shard, the rest (scalars, ids) stay whole."""
    n = mesh.n_data

    def place(x):
        shape = getattr(x, "shape", ())
        if len(shape) >= 1 and shape[0] >= n and shape[0] % n == 0:
            per = shape[0] // n
            return x[mesh.data_index * per : (mesh.data_index + 1) * per]
        return x

    return {k: place(v) for k, v in batch.items()}


# SapienMultiDataset.device_buffers() arrays with a view axis (instances,
# articulations, VIEWS, ...): these split over 'data' by view
_VIEW_SHARDED_KEYS = ("rgb", "mask", "c2w")
VIEW_AXIS = 2


def multi_buffer_specs(sharded: bool) -> Optional[Dict[str, Optional[int]]]:
    """The axis each articulated scene buffer splits on over 'data' (None:
    whole), or None for every buffer whole; JAX's ``PartitionSpec`` pytree
    of the same name, with an axis for P(None, None, 'data') and None for
    P()."""
    if not sharded:
        return None
    return {"rgb": VIEW_AXIS, "mask": VIEW_AXIS, "c2w": VIEW_AXIS, "deg": None, "directions": None}


def view_slice(mesh: Mesh, n_views: int) -> np.ndarray:
    """The view indices this rank holds of ``n_views``: the view axis padded
    cyclically to a multiple of the data axis (view v again as v % n_views,
    which oversamples the first ``pad`` views by one slot), then this
    rank's contiguous share."""
    pad = (-n_views) % mesh.n_data
    idx = np.arange(n_views + pad) % n_views
    local = (n_views + pad) // mesh.n_data
    return idx[mesh.data_index * local : (mesh.data_index + 1) * local]


def shard_multi_buffers(mesh: Mesh, buffers: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's share of ``SapienMultiDataset.device_buffers()``: the
    view axis of rgb, mask and c2w cut to ``view_slice`` (the slice JAX's
    view sharding puts on device ``data_index``), deg and directions whole.
    Each rank then holds, and samples from, n_views / n_data views."""
    out = {}
    for k, v in buffers.items():
        if k in _VIEW_SHARDED_KEYS:
            idx = view_slice(mesh, v.shape[VIEW_AXIS])
            if isinstance(v, np.ndarray):
                out[k] = np.ascontiguousarray(v[:, :, idx])
            else:
                out[k] = v[:, :, idx].contiguous()
        else:
            out[k] = v
    return out


def tp_param_spec(params: Mapping[str, Any], n_model: int, min_width: int = 128) -> Dict[str, tuple]:
    """The tensor-parallel split of each parameter, by name, in the port's
    layout: a Linear weight (out, in) whose output width is at least
    ``min_width`` and divides by ``n_model`` splits its output axis,
    ('model', None); everything else (biases, code and degree embedding
    tables, convolutions) stays whole, (). JAX's spec of the same layer's
    kernel (in, out) is P(None, 'model'), the transpose."""

    def spec(name, p):
        shape = tuple(p.shape)
        dense = name.endswith("weight") and "embedding" not in name and len(shape) == 2
        if dense and shape[0] >= min_width and shape[0] % n_model == 0:
            return ("model", None)
        return ()

    return {name: spec(name, p) for name, p in params.items()}
