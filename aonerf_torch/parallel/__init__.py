"""Data parallelism on torch.distributed (counterpart of ``aonerf.parallel``)."""

from aonerf_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    multi_buffer_specs,
    shard_batch,
    shard_multi_buffers,
    tp_param_spec,
)
