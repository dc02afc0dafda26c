"""Halo exchange + sharded cell->point conversion.

Marching cubes needs point-scalar values, and a grid point's value averages
the up-to-8 cells around it (``vtkCellDataToPointData`` semantics, used at
``Reconstruction/main.cxx:150-155``). Under z-slab sharding each shard needs
its z-neighbors' boundary cell plane — a classic 1-deep halo exchange,
implemented with ``jax.lax.ppermute`` over the ``z`` mesh axis (neighbor
traffic only: one (cy, cx) plane per shard per direction).
"""

from __future__ import annotations
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["sharded_cell_to_point", "exchange_z_halo"]


def exchange_z_halo(local: jax.Array, axis: str = "z"):
    """Inside shard_map: return (below_plane, above_plane) — the neighbor
    shards' boundary cell planes (zeros at the global ends)."""
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    # Send my TOP plane up (to idx+1): that shard sees it as its 'below'.
    below = jax.lax.ppermute(
        local[-1:], axis, [(i, i + 1) for i in range(n - 1)]
    )
    # Send my BOTTOM plane down (to idx-1): becomes that shard's 'above'.
    above = jax.lax.ppermute(
        local[:1], axis, [(i + 1, i) for i in range(n - 1)]
    )
    below = jnp.where(idx == 0, jnp.zeros_like(below), below)
    above = jnp.where(idx == n - 1, jnp.zeros_like(above), above)
    return below, above


def _local_cell_to_point_with_halo(cells, below, above, first, last):
    """cells (bz, cy, cx) + neighbor planes -> (bz+1, cy+1, cx+1) point block
    covering points [z0, z0+bz] of this shard (global point k = cell k's low
    corner). `first`/`last` mark global boundary shards (affect averaging
    counts)."""
    bz = cells.shape[0]
    ext = jnp.concatenate([below, cells, above], axis=0)  # (bz+2, cy, cx)
    v = jnp.pad(ext, ((0, 0), (1, 1), (1, 1)))
    ones = jnp.pad(jnp.ones_like(ext), ((0, 0), (1, 1), (1, 1)))
    # Mask the synthetic halo planes out of the COUNT at global boundaries.
    zmask = jnp.ones((bz + 2, 1, 1), cells.dtype)
    zmask = zmask.at[0, 0, 0].set(jnp.where(first, 0.0, 1.0))
    zmask = zmask.at[-1, 0, 0].set(jnp.where(last, 0.0, 1.0))
    v = v * zmask
    ones = ones * zmask
    pz, py, px = bz + 1, cells.shape[1] + 1, cells.shape[2] + 1
    total = jnp.zeros((pz, py, px), cells.dtype)
    count = jnp.zeros((pz, py, px), cells.dtype)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                total = total + jax.lax.dynamic_slice(
                    v, (dz, dy, dx), (pz, py, px)
                )
                count = count + jax.lax.dynamic_slice(
                    ones, (dz, dy, dx), (pz, py, px)
                )
    return total / jnp.maximum(count, 1e-30)


def sharded_cell_to_point(volume, mesh: Mesh) -> jax.Array:
    """(cz, cy, cx) z-sharded cell scalars -> (cz+1, cy+1, cx+1) point
    scalars, replicated-free: output stays z-sharded as overlapping blocks
    gathered into a standard array.

    Returns a global (cz+1, cy+1, cx+1) array (sharding: rows 0..cz z-sharded
    with the final plane on the last shard).
    """
    cz = volume.shape[0]
    nz = mesh.shape["z"]
    bz = cz // nz

    def body(cells):
        below, above = exchange_z_halo(cells)
        idx = jax.lax.axis_index("z")
        first = idx == 0
        last = idx == jax.lax.axis_size("z") - 1
        block = _local_cell_to_point_with_halo(
            cells, below, above, first, last
        )  # (bz+1, cy+1, cx+1): points z0..z0+bz
        # Non-overlapping output: every shard emits points [z0, z0+bz); the
        # last shard's final plane is emitted separately below.
        return block[:bz], block[bz:]

    f = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=P("z", None, None),
            out_specs=(P("z", None, None), P("z", None, None)),
        )
    )
    main, lasts = f(volume)
    # lasts is (nz, cy+1, cx+1): shard i's plane z0_i+bz; only the final
    # shard's plane is a *new* global point plane (the others duplicate the
    # next shard's first plane).
    return jnp.concatenate([main, lasts[-1:]], axis=0)
