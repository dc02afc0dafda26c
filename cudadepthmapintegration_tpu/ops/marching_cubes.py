"""Marching-cubes isosurface extraction (JAX, two-phase compaction).

Replaces the VTK pipeline ``vtkCellDataToPointData`` -> ``vtkContourFilter``
-> ``vtkTransformFilter`` (``Reconstruction/main.cxx:150-189``). Design notes
for XLA:

* **Phase 1 (dense, on device):** compute the 8-bit cube configuration for
  every cell of the point-scalar volume — pure elementwise compares/shifts,
  fused by XLA; output is one small int per cell.
* **Compaction (host):** active cells (config not 0/255) are found with
  ``np.nonzero``; surface cells are O(N^(2/3)) of the volume, so everything
  downstream works on a compact, padded list — the XLA-friendly answer to
  marching cubes' variable-output-size hostility.
* **Phase 2 (compact, on device):** for each active cell, emit up to 5
  triangles (fixed capacity, masked) with vertices interpolated along cube
  edges; each vertex also carries the *global canonical edge id* of the edge
  it lies on, so duplicate vertices across cells are welded exactly by
  integer key (no float tolerance), matching vtkContourFilter's merged points.

The isovalue convention matches VTK: vertices interpolate where the scalar
crosses ``iso``; cells entirely >= or < iso produce nothing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import VoxelGrid
from ..io.polydata import PolyData
from .cell_to_point import cell_to_point
from .mc_tables import CORNER_OFFSETS, EDGE_CANONICAL, EDGE_CORNERS, TRI_TABLE

__all__ = ["marching_cubes", "extract_isosurface"]


@jax.jit
def _cube_config(points: jax.Array, iso: jax.Array) -> jax.Array:
    """(nz, ny, nx) point scalars -> (nz-1, ny-1, nx-1) uint8 configs.

    Bit i set when corner value < iso (Bourke convention)."""
    below = (points < iso).astype(jnp.uint8)
    cfg = jnp.zeros(
        (points.shape[0] - 1, points.shape[1] - 1, points.shape[2] - 1), jnp.uint8
    )
    nz, ny, nx = cfg.shape
    for bit, (dx, dy, dz) in enumerate(np.asarray(CORNER_OFFSETS)):
        piece = jax.lax.dynamic_slice(below, (dz, dy, dx), (nz, ny, nx))
        cfg = cfg | (piece << np.uint8(bit))
    return cfg


@partial(jax.jit, static_argnames=("nx", "ny", "nz"))
def _active_cell_triangles(
    points_flat: jax.Array,  # (nz*ny*nx,) point scalars
    iso: jax.Array,
    cell_idx: jax.Array,  # (A, 3) int32 (k, j, i) of active cells (padded)
    cfg: jax.Array,  # (A,) int32 configs of active cells
    xs: jax.Array,  # (nx,) point x coords (grid frame)
    ys: jax.Array,
    zs: jax.Array,
    nx: int,
    ny: int,
    nz: int,
):
    """Emit (A, 5, 3) vertex positions x3 coords + edge keys + validity.

    Returns:
      verts: (A, 15, 3) float — interpolated vertex positions (grid frame).
      keys:  (A, 15) int64 — canonical global edge ids for welding.
      valid: (A, 15) bool — triangle-slot validity mask.
    """
    tri_table = jnp.asarray(TRI_TABLE)  # (256, 16)
    edge_corners = jnp.asarray(EDGE_CORNERS)  # (12, 2)
    corner_off = jnp.asarray(CORNER_OFFSETS)  # (8, 3)
    edge_canon = jnp.asarray(EDGE_CANONICAL)  # (12, 4)

    k, j, i = cell_idx[:, 0], cell_idx[:, 1], cell_idx[:, 2]

    # Corner point values for the 8 corners of each active cell: (A, 8)
    def corner_value(c):
        dz, dy, dx = int(CORNER_OFFSETS[c, 2]), int(CORNER_OFFSETS[c, 1]), int(CORNER_OFFSETS[c, 0])
        flat = ((k + dz) * ny + (j + dy)) * nx + (i + dx)
        return jnp.take(points_flat, flat)

    corner_vals = jnp.stack([corner_value(c) for c in range(8)], axis=1)  # (A, 8)

    # Up to 15 vertex slots; slot s uses edge id tri_table[cfg, s].
    edges = jnp.take(tri_table, cfg, axis=0)[:, :15]  # (A, 15)
    valid = edges >= 0
    e = jnp.where(valid, edges, 0)

    ca = jnp.take(edge_corners[:, 0], e)  # (A, 15) corner index a
    cb = jnp.take(edge_corners[:, 1], e)
    va = jnp.take_along_axis(corner_vals, ca, axis=1)
    vb = jnp.take_along_axis(corner_vals, cb, axis=1)
    denom = vb - va
    t = jnp.where(denom != 0, (iso - va) / jnp.where(denom == 0, 1, denom), 0.5)
    # vtkMarchingCubes clamps nothing; crossings guarantee t in [0,1] except
    # exact-equality corner cases — clamp for safety.
    t = jnp.clip(t, 0.0, 1.0)

    # Positions of the two corners along each axis.
    off_a = jnp.take(corner_off, ca, axis=0)  # (A, 15, 3) x,y,z offsets
    off_b = jnp.take(corner_off, cb, axis=0)
    ijk = jnp.stack([i, j, k], axis=1)[:, None, :]  # (A, 1, 3)
    ia = ijk + off_a  # (A, 15, 3) point indices
    ib = ijk + off_b

    def coords(idx3):
        px = jnp.take(xs, idx3[..., 0])
        py = jnp.take(ys, idx3[..., 1])
        pz = jnp.take(zs, idx3[..., 2])
        return jnp.stack([px, py, pz], axis=-1)

    pa = coords(ia)
    pb = coords(ib)
    verts = pa + t[..., None] * (pb - pa)  # (A, 15, 3)

    # Canonical global edge key: axis * (nz*ny*nx) + flat index of the edge's
    # canonical origin point.
    axis = jnp.take(edge_canon[:, 0], e)
    ox = jnp.take(edge_canon[:, 1], e)
    oy = jnp.take(edge_canon[:, 2], e)
    oz = jnp.take(edge_canon[:, 3], e)
    flat_origin = (
        ((k[:, None] + oz) * ny + (j[:, None] + oy)) * nx + (i[:, None] + ox)
    ).astype(jnp.int64)
    keys = axis.astype(jnp.int64) * (nx * ny * nz) + flat_origin
    keys = jnp.where(valid, keys, -1)

    return verts, keys, valid


# Active cells per _active_cell_triangles call (see the chunked emission
# in marching_cubes); module-level so tests can force multi-chunk runs.
CELL_CHUNK = 1 << 18


def _pad_to(n: int, minimum: int = 512) -> int:
    """Next power of two (>= minimum): bounds the number of jit variants."""
    return max(minimum, 1 << (n - 1).bit_length())


@partial(jax.jit, static_argnames=("pad3",))
def _weld_kernel(verts, keys, n_soup, pad3):
    """Device welding core: sort keys, detect uniques, build the inverse
    map and triangle validity. Padding slots (index >= n_soup) get a
    sentinel key that sorts last and is excluded from the unique count.
    Selection is bit-identical to np.unique-based host welding: uniques
    ascending, duplicate vertices carry identical bits by construction."""
    m = keys.shape[0]
    big = jnp.iinfo(keys.dtype).max
    keysw = jnp.where(jnp.arange(m) < n_soup, keys, big)
    order = jnp.argsort(keysw)
    sk = jnp.take(keysw, order)
    sv = jnp.take(verts, order, axis=0)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    is_new = first & (sk != big)
    inv_sorted = jnp.cumsum(is_new) - 1
    # Host welding scatters duplicates in ORIGINAL order, so the LAST
    # original occurrence of each key wins — duplicates can differ by one
    # ulp (two cells interpolate the shared edge with opposite corner
    # order). argsort is stable, so within a duplicate run the last
    # element has the highest original index: select it, not the first.
    is_last = jnp.concatenate(
        [sk[1:] != sk[:-1], jnp.ones((1,), bool)]
    ) & (sk != big)
    uidx = jnp.nonzero(is_last, size=pad3, fill_value=0)[0]
    uniq_keys = jnp.take(sk, uidx)
    points = jnp.take(sv, uidx, axis=0)
    inverse = jnp.zeros((m,), inv_sorted.dtype).at[order].set(inv_sorted)
    # Padding makes m a power of two; only complete triples are real
    # triangles (n_soup is a multiple of 3 by construction).
    tri = inverse[: (m // 3) * 3].reshape(-1, 3)
    tri_ok = (
        (jnp.arange(tri.shape[0]) * 3 < n_soup)
        & (tri[:, 0] != tri[:, 1])
        & (tri[:, 1] != tri[:, 2])
        & (tri[:, 0] != tri[:, 2])
    )
    return points, uniq_keys, tri, tri_ok, is_new.sum(), tri_ok.sum()


@partial(jax.jit, static_argnames=("pad4",))
def _tri_compact(tri, tri_ok, pad4):
    tidx = jnp.nonzero(tri_ok, size=pad4, fill_value=0)[0]
    return jnp.take(tri, tidx, axis=0)


def weld_soup_device(verts_dev, keys_dev, n_soup):
    """Weld a DEVICE-resident compacted triangle soup on device (round 5):
    only the final mesh (unique points, triangle indices, unique keys)
    crosses to the host — ~3x less transfer than downloading the soup,
    and the only host work left is the float64 grid-matrix transform.
    Returns (points f32 (V,3), triangles int (T,3), uniq_keys (V,)),
    bit-identical to ``_weld_triangle_soup`` without a matrix."""
    pad3 = _pad_to(n_soup)
    points, uniq_keys, tri, tri_ok, n_uniq, n_tris = _weld_kernel(
        verts_dev, keys_dev, n_soup, pad3
    )
    n_uniq, n_tris = int(n_uniq), int(n_tris)
    tris = _tri_compact(tri, tri_ok, _pad_to(max(n_tris, 1)))
    return (
        np.asarray(points)[:n_uniq],
        np.asarray(tris)[:n_tris].astype(np.int64),
        np.asarray(uniq_keys)[:n_uniq],
    )


def _weld_triangle_soup(
    used_verts: np.ndarray,  # (M, 3) vertex positions, 3 per triangle
    used_keys: np.ndarray,  # (M,) canonical edge ids
    matrix: np.ndarray | None,
    return_keys: bool = False,
) -> PolyData:
    """Merge duplicate vertices by exact integer edge identity (each MC
    vertex lies on one grid edge), then drop degenerate triangles — matching
    vtkContourFilter's merged-points output without float tolerances.
    ``return_keys=True`` additionally returns the per-point canonical edge
    keys (same order as ``points``) for gradient-normal computation."""
    uniq, inverse = np.unique(used_keys, return_inverse=True)
    points = np.zeros((uniq.shape[0], 3), dtype=used_verts.dtype)
    # Last write wins per key. Duplicates agree to 1 ulp (two cells
    # interpolate the shared edge with opposite corner order), so the
    # deterministic pick matters only for bit-level reproducibility —
    # weld_soup_device selects the same occurrence.
    points[inverse] = used_verts
    triangles = inverse.reshape(-1, 3).astype(np.int64)
    ok = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    triangles = triangles[ok]
    if matrix is not None:
        m = np.asarray(matrix, dtype=np.float64)
        points = points @ m[:3, :3].T + m[:3, 3]
    mesh = PolyData(points, triangles)
    return (mesh, uniq) if return_keys else mesh


def marching_cubes(
    point_volume: np.ndarray | jax.Array,
    iso: float,
    xs: np.ndarray,
    ys: np.ndarray,
    zs: np.ndarray,
    matrix: np.ndarray | None = None,
    backend: str = "auto",
    compute_normals: bool = False,
    _return_soup: bool = False,
    weld_backend: str = "host",
) -> PolyData:
    """Extract the `iso` isosurface of a (nz, ny, nx) point-scalar volume.

    ``xs/ys/zs`` are the per-axis point coordinates (grid frame); ``matrix``
    (4x4) is applied to the output vertices, mirroring the transform filter at
    ``Reconstruction/main.cxx:176-189``. ``backend``: 'native' (C++ table
    walker — the fast host path), 'jax' (two-phase device extraction), or
    'auto' (native when the library is built, else jax). Meshing runs once
    per reconstruction, on host-resident data; the C++ walker avoids both a
    device round-trip and an XLA gather-bound compact pass.

    ``compute_normals=True`` attaches a ``"Normals"`` point array
    (gradient normals, ``ops/normals.py`` — vtkContourFilter's
    ComputeNormals default, see ``Reconstruction/main.cxx:169-173``),
    transformed by ``matrix`` like the points.

    ``_return_soup=True`` skips welding and returns the raw
    ``(verts (M, 3), keys (M,))`` triangle soup with volume-local edge keys
    — for callers (sparse per-block / sharded slab extraction) that
    translate keys to a global domain and weld once at the end.

    ``weld_backend`` ('jax' backend only): 'host' downloads the compacted
    soup and welds with np.unique; 'device' welds on device
    (:func:`weld_soup_device`) so only the final mesh crosses to the host
    — bit-identical output (the float64 matrix transform stays on host).
    """
    if backend == "auto":
        from .. import native

        backend = "native" if native.available() else "jax"

    def finish(flat_verts, flat_keys, pv_for_normals):
        if not compute_normals:
            return _weld_triangle_soup(flat_verts, flat_keys, matrix)
        mesh, uniq = _weld_triangle_soup(
            flat_verts, flat_keys, matrix, return_keys=True
        )
        from .normals import normals_for_edge_keys, transform_normals

        normals = normals_for_edge_keys(
            np.asarray(pv_for_normals), xs, ys, zs, uniq, iso
        )
        if matrix is not None:
            normals = transform_normals(normals, matrix)
        mesh.point_data["Normals"] = normals
        return mesh

    if backend == "native":
        from .. import native

        pv_np = np.asarray(point_volume, np.float64)
        verts, keys = native.marching_cubes_f64(pv_np, iso, xs, ys, zs)
        if _return_soup:
            return verts.reshape(-1, 3), keys.reshape(-1)
        return finish(verts.reshape(-1, 3), keys.reshape(-1), pv_np)
    pv = jnp.asarray(point_volume)
    nz, ny, nx = pv.shape
    # Phase 1 (DEVICE compaction): both compaction steps run on device so
    # only two scalars (the active-cell and triangle-slot counts) and the
    # compacted soup cross to the host, not the full (nz-1)^3 config
    # volume and the padded (A, 15, 3) vertex block (133 MB + ~90 MB at
    # 512^3). jnp.nonzero(size=...) keeps C-order, so cell and triangle
    # order — and therefore the welded mesh — are unchanged bit for bit.
    cfg_dev = _cube_config(pv, jnp.asarray(iso, pv.dtype))
    active = ((cfg_dev != 0) & (cfg_dev != 255)).reshape(-1)
    n_active = int(active.sum())
    if n_active == 0:
        if _return_soup:
            return np.zeros((0, 3)), np.zeros((0,), np.int64)
        empty = PolyData(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        if compute_normals:
            # Keep the attribute set shape-stable: non-empty results carry
            # "Normals", so the no-crossing case must too (consumers index
            # point_data["Normals"] unconditionally).
            empty.point_data["Normals"] = np.zeros((0, 3), np.float32)
        return empty

    pad = _pad_to(n_active)
    flat_idx = jnp.nonzero(active, size=pad, fill_value=0)[0]
    ncx, ncy = nx - 1, ny - 1
    cell_idx = jnp.stack(
        [flat_idx // (ncy * ncx), (flat_idx // ncx) % ncy, flat_idx % ncx],
        axis=1,
    ).astype(jnp.int32)
    # Padding slots replay cell 0 but with cfg forced to 0 (no triangles).
    cfg_active = jnp.where(
        jnp.arange(pad) < n_active, jnp.take(cfg_dev.reshape(-1), flat_idx), 0
    ).astype(jnp.int32)

    # Emit triangles in fixed-size active-cell chunks: the un-fused temps
    # of one _active_cell_triangles call scale with the padded cell count,
    # and chunking bounds them. Concatenation preserves cell order, so the
    # soup — and the welded mesh — is bit-identical to the single-call
    # path. The chunk size has not been re-tuned for an 80 GB card.
    cell_chunk = CELL_CHUNK
    pvf = pv.reshape(-1)
    iso_d = jnp.asarray(iso, pv.dtype)
    xs_d = jnp.asarray(xs, pv.dtype)
    ys_d = jnp.asarray(ys, pv.dtype)
    zs_d = jnp.asarray(zs, pv.dtype)
    dims_kw = dict(nx=int(nx), ny=int(ny), nz=int(nz))
    if pad <= cell_chunk:
        verts, keys, valid = _active_cell_triangles(
            pvf, iso_d, cell_idx, cfg_active, xs_d, ys_d, zs_d, **dims_kw
        )
    else:
        parts = [
            _active_cell_triangles(
                pvf, iso_d, cell_idx[s : s + cell_chunk],
                cfg_active[s : s + cell_chunk], xs_d, ys_d, zs_d, **dims_kw
            )
            for s in range(0, pad, cell_chunk)
        ]
        verts = jnp.concatenate([p[0] for p in parts])
        keys = jnp.concatenate([p[1] for p in parts])
        valid = jnp.concatenate([p[2] for p in parts])
    # Phase 2 (device soup compaction): keep only emitted triangle slots.
    valid_flat = valid.reshape(-1)
    n_soup = int(valid_flat.sum())
    if n_soup and weld_backend == "device" and not _return_soup:
        pad2 = _pad_to(n_soup)
        soup_idx = jnp.nonzero(valid_flat, size=pad2, fill_value=0)[0]
        points, tris, uniq = weld_soup_device(
            jnp.take(verts.reshape(-1, 3), soup_idx, axis=0),
            jnp.take(keys.reshape(-1), soup_idx),
            n_soup,
        )
        pts64 = points
        if matrix is not None:
            m64 = np.asarray(matrix, np.float64)
            pts64 = points @ m64[:3, :3].T + m64[:3, 3]
        mesh = PolyData(pts64, tris)
        if compute_normals:
            from .normals import normals_for_edge_keys, transform_normals

            normals = normals_for_edge_keys(np.asarray(pv), xs, ys, zs,
                                            uniq, iso)
            if matrix is not None:
                normals = transform_normals(normals, matrix)
            mesh.point_data["Normals"] = normals
        return mesh
    if n_soup == 0:
        flat_verts = np.zeros((0, 3), np.asarray(verts).dtype)
        flat_keys = np.zeros((0,), np.asarray(keys).dtype)
    else:
        pad2 = _pad_to(n_soup)
        soup_idx = jnp.nonzero(valid_flat, size=pad2, fill_value=0)[0]
        flat_verts = np.asarray(
            jnp.take(verts.reshape(-1, 3), soup_idx, axis=0)
        )[:n_soup]
        flat_keys = np.asarray(jnp.take(keys.reshape(-1), soup_idx))[:n_soup]
    if _return_soup:
        return flat_verts, flat_keys
    # pv crosses to host inside finish() ONLY when normals are requested
    # (the one remaining host-side stage); with compute_normals=False the
    # volume never leaves the device.
    return finish(flat_verts, flat_keys, pv)


def extract_isosurface(
    grid: VoxelGrid,
    cell_volume: np.ndarray | jax.Array,
    iso: float,
    compute_normals: bool = True,
    backend: str = "auto",
    weld_backend: str = "host",
) -> PolyData:
    """Full reference pipeline: cell->point averaging, contour at `iso`
    (with gradient "Normals" — vtkContourFilter's ComputeNormals default),
    grid-matrix transform (``Reconstruction/main.cxx:150-189``).
    ``backend``/``weld_backend`` pass through to :func:`marching_cubes`
    ('auto' picks the native C++ walker when built — the fast HOST path;
    backend='jax' + weld_backend='device' keeps extraction on device so
    only the final mesh crosses the host link)."""
    pv = cell_to_point(jnp.asarray(cell_volume))
    xs, ys, zs = grid.point_axes(pv.dtype)
    mesh = marching_cubes(
        pv, iso, xs, ys, zs, matrix=grid.matrix,
        backend=backend,
        compute_normals=compute_normals,
        weld_backend=weld_backend,
    )
    # vtkContourFilter's ComputeScalars default is also ON: the output
    # carries the contoured scalars (== iso at every crossing) under the
    # input array's name, marked as the active scalars
    # (vtkCudaReconstructionFilter.cxx:129-135 names the array).
    mesh.point_data["reconstruction_scalar"] = np.full(
        mesh.num_points, iso, np.float64
    )
    mesh.active_scalars = "reconstruction_scalar"
    return mesh
