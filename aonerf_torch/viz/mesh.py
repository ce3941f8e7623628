"""Isosurface meshes of field-density grids by marching tetrahedra
(counterpart of ``aonerf.viz.mesh``).

Kuhn's 6-tetrahedron cube decomposition: every cube face is split along the
same global diagonal as its neighbour's, so the mesh is watertight across
cells; the per-tetrahedron case table is derived, not tabulated; triangles
are wound so their normals point out of the dense region. The surface walk
is branchy, table-driven work and runs on the host in NumPy over the grid
that viz/voxelgrid.py::density_grid evaluated on the device, in float64 as
the JAX package's does, so both give the same vertices and faces for the
same grid.
"""

from typing import Callable, Tuple

import numpy as np

from aonerf_torch import DeviceLike
from aonerf_torch.viz.pointcloud import write_ply
from aonerf_torch.viz.voxelgrid import density_grid

# Kuhn decomposition: one tet per monotone corner path 0 -> 7 (corner bit
# code: bit0 = +x, bit1 = +y, bit2 = +z).  Each cube face's induced diagonal
# joins the face's lowest to highest corner in GLOBAL coordinates, so
# adjacent cubes split their shared face identically (watertightness).
TETS = (
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
)


def _case_triangles(mask: int):
    """Triangles (as triples of local tet-edge pairs) cut by the isosurface
    for a 4-bit inside mask.  Derived, not tabulated: 1 or 3 vertices on one
    side -> one triangle on the three edges from the lone vertex; 2-2 -> a
    quad whose cyclic order follows the tet faces (each consecutive pair of
    cut edges shares a tet face, so the quad cannot bow-tie)."""
    inside = [i for i in range(4) if mask >> i & 1]
    outside = [i for i in range(4) if not mask >> i & 1]
    if len(inside) in (0, 4):
        return []
    if len(inside) == 1:
        a, (o1, o2, o3) = inside[0], outside
        return [[(a, o1), (a, o2), (a, o3)]]
    if len(inside) == 3:
        a, (o1, o2, o3) = outside[0], inside
        return [[(a, o1), (a, o2), (a, o3)]]
    (a, b), (c, d) = inside, outside
    e1, e2, e3, e4 = (a, c), (a, d), (b, d), (b, c)
    return [[e1, e2, e3], [e1, e3, e4]]


_CASES = {m: _case_triangles(m) for m in range(16)}


def marching_tetrahedra(
    grid: np.ndarray,
    level: float,
    bbox_min=(-1.5, -1.5, -1.5),
    bbox_max=(1.5, 1.5, 1.5),
) -> Tuple[np.ndarray, np.ndarray]:
    """(V, 3) vertices and (F, 3) faces of the ``grid > level`` isosurface.

    ``grid`` is an (R, R, R) scalar field sampled at the voxel centers of
    the bbox (the viz/voxelgrid.density_grid convention).  Vertices are
    welded exactly (keyed by the global grid edge they cut, interpolated
    once in a canonical corner order), and faces are wound so normals point
    OUT of the dense region."""
    grid = np.asarray(grid, dtype=np.float64)
    R = grid.shape[0]
    lo = np.asarray(bbox_min, dtype=np.float64)
    hi = np.asarray(bbox_max, dtype=np.float64)

    def gid_pos(gid):
        idx = np.stack([gid // (R * R), (gid // R) % R, gid % R], axis=-1)
        return lo + (hi - lo) * (idx + 0.5) / R

    vals = grid.ravel()  # C order: grid[ix, iy, iz] at ix*R*R + iy*R + iz
    ix, iy, iz = np.meshgrid(*(np.arange(R - 1),) * 3, indexing="ij")
    base = (ix * R * R + iy * R + iz).ravel()
    # corner[k] follows bit code k: bit0 = +x, bit1 = +y, bit2 = +z
    corner = [
        base + (k & 1) * R * R + ((k >> 1) & 1) * R + ((k >> 2) & 1)
        for k in range(8)
    ]

    edges_a, edges_b, inside_pts = [], [], []
    for tet in TETS:
        gids = np.stack([corner[c] for c in tet], axis=1)  # (N, 4)
        v = vals[gids]
        mask = ((v > level) << np.arange(4)).sum(axis=1)
        for m in range(1, 15):
            tris = _CASES[m]
            if not tris:
                continue
            sel = np.nonzero(mask == m)[0]
            if not len(sel):
                continue
            g = gids[sel]
            ins = [i for i in range(4) if m >> i & 1]
            ctr = gid_pos(g[:, ins]).mean(axis=1)  # inside-vertex centroid
            for tri in tris:
                edges_a.append(np.stack([g[:, i] for i, _ in tri], axis=1))
                edges_b.append(np.stack([g[:, j] for _, j in tri], axis=1))
                inside_pts.append(ctr)

    if not edges_a:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    ea = np.concatenate(edges_a, axis=0)  # (M, 3) cut-edge endpoints
    eb = np.concatenate(edges_b, axis=0)
    inside_pts = np.concatenate(inside_pts, axis=0)  # (M, 3)

    # Weld: one vertex per cut GRID edge, interpolated in canonical order.
    g_lo, g_hi = np.minimum(ea, eb), np.maximum(ea, eb)
    key = g_lo.astype(np.int64) * (R * R * R) + g_hi
    uniq, inv = np.unique(key, return_inverse=True)
    ua, ub = uniq // (R * R * R), uniq % (R * R * R)
    va, vb = vals[ua], vals[ub]
    t = ((level - va) / (vb - va))[:, None]
    verts = gid_pos(ua) + t * (gid_pos(ub) - gid_pos(ua))
    faces = inv.reshape(-1, 3)

    # Outward winding: flip faces whose normal points toward the inside.
    p = verts[faces]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    to_inside = inside_pts - p.mean(axis=1)
    flip = np.einsum("ij,ij->i", n, to_inside) > 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    """ASCII PLY triangle mesh (opens in meshlab/blender/open3d), through the
    shared writer (viz/pointcloud.py::write_ply)."""
    return write_ply(path, np.asarray(verts, dtype=np.float64), faces=faces)


def extract_mesh(
    density_fn: Callable,
    level: float = 10.0,
    bbox_min=(-1.5, -1.5, -1.5),
    bbox_max=(1.5, 1.5, 1.5),
    resolution: int = 128,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """density_fn -> (verts, faces): the grid on ``device``
    (viz/voxelgrid.density_grid), then marching tetrahedra on the host."""
    grid = density_grid(density_fn, bbox_min, bbox_max, resolution, device=device)
    return marching_tetrahedra(grid, level, bbox_min, bbox_max)
