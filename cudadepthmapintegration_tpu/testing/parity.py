"""Geometry cases for integrate parity against the float64 oracle.

Each case is ``(name, grid, views, params, threshold_best_cost)``. They
cover a rotated grid matrix, elevated cameras, an anisotropic grid, the
best-cost threshold and 600x456 maps (a width and height that are not
powers of two). A float32 integrator passes when at most ``FLIP_BUDGET`` of
its voxels differ from the oracle by more than ``FLIP_TOL``: float32
projection against the oracle's float64 can round a voxel that sits on a
pixel's half-way line to the neighbouring pixel.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import VoxelGrid, grid_matrix_from_axes
from ..core.ray_potential import RayPotential
from .synthetic import orbit_cameras, render_sphere_view, sphere_scene

__all__ = ["FLIP_BUDGET", "FLIP_TOL", "flip_fraction", "parity_cases"]

FLIP_BUDGET = 2e-4
FLIP_TOL = 1e-3


def flip_fraction(got: np.ndarray, expected: np.ndarray) -> float:
    """Fraction of voxels where |got - expected| exceeds ``FLIP_TOL``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(expected, np.float64))
    return float((err > FLIP_TOL).mean())


def parity_cases():
    """The six parity geometry cases."""
    params = RayPotential(thick=0.05, rho=0.8, eta=0.03, delta=0.2)
    views = sphere_scene(n_views=8, width=256, height=192, focal=150.0)

    grid = VoxelGrid(
        dims=(65, 65, 65), origin=(-1.63, -1.61, -1.59), spacing=(0.05,) * 3
    )
    m = grid_matrix_from_axes((0, 1, 0), (-1, 0, 0), (0, 0, 1))
    grid_r = VoxelGrid(
        dims=(65, 65, 65), origin=(-1.63, -1.61, -1.59),
        spacing=(0.05,) * 3, matrix=m,
    )
    cams = orbit_cameras(6, 3.5, height=2.0, focal=180.0,
                         width=256, image_height=192)
    views_e = [render_sphere_view(c, 256, 192) for c in cams]
    grid_a = VoxelGrid(
        dims=(129, 49, 97), origin=(-1.6, -0.9, -1.2),
        spacing=(0.025, 0.0375, 0.025),
    )
    views_o = sphere_scene(n_views=4, width=600, height=456, focal=350.0)
    return [
        ("64^3 x 8 orbit views", grid, views, params, None),
        ("64^3 rotated grid matrix", grid_r, views, params, None),
        ("64^3 elevated cameras", grid, views_e, params, None),
        ("anisotropic grid", grid_a, views, params, None),
        ("best-cost threshold", grid, views, params, 0.5),
        ("odd image dims 600x456", grid, views_o, params, None),
    ]
