"""Multi-device parallelism: mesh, sharded fusion, halo exchange, coloration."""

from . import distributed
from .halo import exchange_z_halo, sharded_cell_to_point
from .mesh import make_mesh
from .rig import (
    best_shard_grid_axis,
    grid_for_sharding,
    permute_grid_axes,
    permute_volume,
    unpermute_volume,
)
from .sharded_coloration import sharded_colorize_points
from .sharded_integrate import ShardedTSDFIntegrator
from .sharded_mesh import sharded_extract_isosurface

__all__ = [
    "ShardedTSDFIntegrator",
    "best_shard_grid_axis",
    "distributed",
    "exchange_z_halo",
    "grid_for_sharding",
    "make_mesh",
    "permute_grid_axes",
    "permute_volume",
    "sharded_cell_to_point",
    "sharded_colorize_points",
    "sharded_extract_isosurface",
    "unpermute_volume",
]
