"""Port parity: aonerf_torch.parallel against aonerf.parallel.

``local_shard_bounds`` and ``gather_images`` on 1-3 gloo ranks (one launch
of ``tests/torch_ddp_worker.py``'s ranks per world size) against JAX's functions
with the process count and index set and the all-gather stacking every
process's padded rows; each rank's view slice of the articulated scene
buffers against the device shards of ``shard_multi_buffers`` on a JAX mesh
of 2 and 3 of conftest's host devices, at view counts that divide and that
do not; ``shard_batch``'s split against JAX's layouts; ``tp_param_spec``
against JAX's PartitionSpecs. Every comparison is exact."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from aonerf.parallel import distributed as jdist
from aonerf.parallel import mesh as jmesh
from aonerf_torch.entry import _multi_buffers
from aonerf_torch.models.ae import AutoEncoderArticulatedNeRF
from aonerf_torch.models.nerf import NeRF
from aonerf_torch.parallel import mesh as tmesh
from aonerf_torch.utils.bridge import module_flax_tree
from tests.torch_ddp_worker import run_ranks

LENGTHS = (1, 2, 5, 7)  # items to split: fewer than, as many as and more than the ranks, ragged


def _rows(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3, 2)).astype(np.float32)


def _jax_gather(arrays_by_rank, total, world):
    """JAX's gather_images on each of ``world`` processes: every process's
    padded rows, stacked as process_allgather stacks them."""
    padded = []

    def keep(x):  # the first pass records each process's padded rows
        padded.append(np.asarray(x))
        return np.zeros((world, *np.asarray(x).shape), np.asarray(x).dtype)

    def stack(x):
        return np.stack(padded)

    from jax.experimental import multihost_utils

    out = []
    for fake in (keep, stack):
        for r in range(world):
            with mock.patch.object(jax, "process_count", lambda: world), \
                    mock.patch.object(jax, "process_index", lambda r=r: r), \
                    mock.patch.object(multihost_utils, "process_allgather", fake):
                got = jdist.gather_images(arrays_by_rank[r], total)
            if fake is stack:
                out.append(got)
    return out


@pytest.fixture(scope="module")
def ranks():
    """{world: each rank's results} of bounds_and_gather at 1, 2 and 3 ranks."""
    rows = [_rows(n, seed=n) for n in LENGTHS]
    return rows, {world: run_ranks([("bg", "bounds_and_gather", {"rows": rows})], world, threads=1)
                  for world in (1, 2, 3)}


@pytest.mark.parametrize("world", [1, 2, 3])
def test_local_shard_bounds_match_jax(ranks, world):
    rows, results = ranks
    for i, a in enumerate(rows):
        for r in range(world):
            with mock.patch.object(jax, "process_count", lambda: world), \
                    mock.patch.object(jax, "process_index", lambda r=r: r):
                want = jdist.local_shard_bounds(len(a))
            assert tuple(results[world][r]["bg"][i][0]) == tuple(want), (world, r, len(a))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_gather_images_matches_jax(ranks, world):
    rows, results = ranks
    for i, a in enumerate(rows):
        local = [a[slice(*results[world][r]["bg"][i][0])] for r in range(world)]
        want = _jax_gather(local, len(a), world) if world > 1 else [jdist.gather_images(local[0], len(a))]
        for r in range(world):
            got = results[world][r]["bg"][i][1]
            np.testing.assert_array_equal(got, want[r])
            np.testing.assert_array_equal(got, a)  # every rank holds every row, in order


@pytest.mark.parametrize("world,n_v", [(2, 4), (2, 3), (3, 4), (3, 2)])
def test_view_slices_match_jax_device_shards(devices, world, n_v):
    # the cyclic pad when the view count does not divide: view v again as v % n_v
    buffers = _multi_buffers(n_v=n_v)
    placed = jmesh.shard_multi_buffers(jmesh.make_mesh(n_data=world, devices=devices[:world]), buffers)
    for r in range(world):
        local = tmesh.shard_multi_buffers(tmesh.make_mesh(rank=r, world_size=world), buffers)
        for k, v in placed.items():
            shard = [s for s in v.addressable_shards if s.device == devices[r]][0]
            np.testing.assert_array_equal(local[k], np.asarray(shard.data), err_msg=f"{k} rank {r}")
        # torch tensors are cut the same way
        t = tmesh.shard_multi_buffers(tmesh.make_mesh(rank=r, world_size=world),
                                      {k: torch.from_numpy(v) for k, v in buffers.items()})
        for k in local:
            np.testing.assert_array_equal(t[k].numpy(), local[k])


def test_multi_buffer_specs_match_jax():
    assert tmesh.multi_buffer_specs(False) is None and jmesh.multi_buffer_specs(False) == P()
    want = jmesh.multi_buffer_specs(True)
    got = tmesh.multi_buffer_specs(True)
    assert set(got) == set(want)
    for k, axis in got.items():
        assert want[k] == (P() if axis is None else P(*([None] * axis), "data")), k


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_matches_jax_layout(devices, world):
    mesh = jmesh.make_mesh(n_data=world, devices=devices[:world])
    batch = {"rays_o": np.arange(24 * 3, dtype=np.float32).reshape(24, 3),
             "target": np.arange(6 * 3, dtype=np.float32).reshape(6, 3),
             "instance_id": np.int32(1), "src_imgs": np.ones((3, 4, 5), np.float32)}
    placed = jmesh.shard_batch(mesh, batch)
    for r in range(world):
        got = tmesh.shard_batch(tmesh.make_mesh(rank=r, world_size=world), batch)
        for k, v in placed.items():
            shard = [s for s in v.addressable_shards if s.device == devices[r]][0]
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(shard.data), err_msg=f"{k} rank {r}")


def test_make_mesh_coordinates():
    assert tmesh.make_mesh().shape == {"data": 1, "model": 1}  # no process group: one rank
    m = tmesh.make_mesh(n_model=2, rank=3, world_size=4)
    assert m.shape == {"data": 2, "model": 2} and (m.data_index, m.model_index) == (1, 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh(n_data=4, n_model=2, world_size=4)
    # rows of a batch: contiguous, as even as whole tiles allow
    rows = [tmesh.make_mesh(rank=r, world_size=3).rows(10) for r in range(3)]
    assert rows == [(0, 4), (4, 7), (7, 10)] == [(a[0], a[-1] + 1) for a in np.array_split(np.arange(10), 3)]
    assert [tmesh.make_mesh(rank=r, world_size=3).rows(64, tile=16) for r in range(3)] == [(0, 32), (32, 48),
                                                                                          (48, 64)]
    assert [tmesh.make_mesh(rank=r, world_size=4).rows(40, tile=16) for r in range(4)] == [(0, 16), (16, 32),
                                                                                          (32, 40), (40, 40)]


def _flax_path_spec(spec_tree, name):
    """JAX's spec of the vanilla field's leaf a port parameter name comes
    from, and whether the leaf is a Dense kernel (whose port layout is its
    transpose)."""
    node = spec_tree["params"]
    *path, leaf = name.split(".")
    for k in path:
        node = node[k]
    key = {"weight": "kernel", "bias": "bias"}[leaf]
    return node[key], key == "kernel"


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_param_spec_matches_jax(n_model):
    # the vanilla NeRF (every trunk layer 256 wide, the heads 1, 3 and 128)
    nerf = NeRF(num_coarse_samples=4, num_fine_samples=4, device="cpu")
    tree = module_flax_tree(nerf)
    want_tree = jmesh.tp_param_spec(tree, n_model)
    got = tmesh.tp_param_spec(dict(nerf.named_parameters()), n_model)
    assert set(got) == {n for n, _ in nerf.named_parameters()}
    n_split = 0
    for name, spec in got.items():
        want, is_kernel = _flax_path_spec(want_tree, name)
        assert spec == (tuple(reversed(tuple(want))) if is_kernel else tuple(want)), (name, spec, want)
        n_split += spec == ("model", None)
    assert n_split == 2 * (8 + 2)  # per level: the 8 trunk layers, the bottleneck and the view layer
    # embedding tables and convolutions stay whole, as JAX's Embed and Conv leaves
    ae = AutoEncoderArticulatedNeRF(num_coarse_samples=4, num_fine_samples=4, device="cpu")
    specs = tmesh.tp_param_spec(dict(ae.named_parameters()), n_model)
    jspecs = jax.tree_util.tree_leaves(jmesh.tp_param_spec(module_flax_tree(ae), n_model),
                                       is_leaf=lambda x: isinstance(x, P))
    assert sum(s == ("model", None) for s in specs.values()) == sum(s == P(None, "model") for s in jspecs)
    assert all(specs[n] == () for n in specs if "embedding" in n or n.endswith("conv1.weight"))


def test_entry_matches_the_jax_entry():
    # the port's entry() against __graft_entry__.entry(): the same example
    # rays, and the same function (the full-size NeRF's deterministic fine
    # rgb) on the port's weights bridged into JAX's parameter tree, within
    # tests/test_torch_models.py's comp tolerance
    import __graft_entry__ as graft
    from aonerf_torch.entry import entry

    fn, (rays,) = entry("cpu")
    jfn, (_, jrays) = graft.entry()
    for k in ("rays_o", "rays_d", "viewdirs"):
        np.testing.assert_array_equal(rays[k].numpy(), np.asarray(jrays[k]), err_msg=k)
    port = NeRF(generator=torch.Generator().manual_seed(0), device="cpu")  # entry()'s weights
    got = fn(rays).numpy()
    want = np.asarray(jfn(module_flax_tree(port), jrays))
    assert got.shape == want.shape == (256, 3)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
