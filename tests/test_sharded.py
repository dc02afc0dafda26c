"""Multi-device sharding tests on the 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8 — the standard JAX pattern for testing
pod logic without hardware)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from cudadepthmapintegration_tpu.ops.cell_to_point import cell_to_point
from cudadepthmapintegration_tpu.parallel import (
    ShardedTSDFIntegrator,
    make_mesh,
    sharded_cell_to_point,
    sharded_colorize_points,
)
from cudadepthmapintegration_tpu.ops.coloration import colorize_points
from cudadepthmapintegration_tpu.testing import sphere_scene

PARAMS = RayPotentials = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)


def grid16():
    # 16 z-cells: divides 2, 4, 8 shards.
    return VoxelGrid(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_spatial_sharded_matches_oracle():
    views = sphere_scene(n_views=4, width=64, height=48)
    mesh = make_mesh(n_z=8)
    integ = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    integ.reset().integrate(views)
    got = integ.result()
    exp = integrate_views_oracle(grid16(), views, PARAMS)
    np.testing.assert_allclose(got, exp, atol=1e-9)
    # Volume really is sharded over z.
    shard_shapes = {s.data.shape for s in integ.volume.addressable_shards}
    assert shard_shapes == {(2, 16, 16)}


def test_view_parallel_matches_spatial():
    views = sphere_scene(n_views=8, width=64, height=48)
    mesh = make_mesh(n_z=2, n_v=4)
    a = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    a.reset().integrate(views)
    b = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    b.reset().integrate_view_parallel(views)
    np.testing.assert_allclose(a.result(), b.result(), atol=1e-12)


def test_view_parallel_requires_divisibility():
    views = sphere_scene(n_views=3, width=64, height=48)
    mesh = make_mesh(n_z=2, n_v=4)
    integ = ShardedTSDFIntegrator(grid16(), PARAMS, mesh).reset()
    with pytest.raises(ValueError, match="multiple"):
        integ.integrate_view_parallel(views)


def test_sharded_cell_to_point_matches_single_device():
    rng = np.random.default_rng(3)
    cells = rng.normal(size=(16, 16, 16))
    mesh = make_mesh(n_z=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.device_put(cells, NamedSharding(mesh, P("z", None, None)))
    got = np.asarray(sharded_cell_to_point(sharded, mesh))
    exp = np.asarray(cell_to_point(jnp.asarray(cells)))
    np.testing.assert_allclose(got, exp, atol=1e-12)


def test_sharded_coloration_matches_single_device():
    views = sphere_scene(n_views=4, width=64, height=48)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(100, 3))
    mesh = make_mesh(n_z=4, n_v=2)
    mean_s, med_s, cnt_s = sharded_colorize_points(pts, views, mesh, dtype=np.float64)
    mean, med, cnt = colorize_points(pts, views, dtype=np.float64)
    np.testing.assert_array_equal(cnt_s, cnt)
    np.testing.assert_array_equal(mean_s, mean)
    np.testing.assert_array_equal(med_s, med)


def test_sharded_incremental_and_resume():
    views = sphere_scene(n_views=6, width=64, height=48)
    mesh = make_mesh(n_z=4)
    one = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    one.reset().integrate(views)
    two = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    two.reset().integrate(views[:3])
    ckpt = two.result()  # "checkpoint" host round-trip
    three = ShardedTSDFIntegrator(grid16(), PARAMS, mesh, dtype=np.float64)
    three.reset(initial=ckpt).integrate(views[3:])
    np.testing.assert_allclose(three.result(), one.result(), atol=1e-12)


@pytest.mark.parametrize("n_z", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slab_interleave_bitwise(n_z, dtype):
    """Round-robin slab assignment is an exact z-permutation: the XLA
    sharded path gives the same bits as contiguous slabs."""
    views = sphere_scene(n_views=4, width=96, height=64, focal=60.0)
    grid = VoxelGrid(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)
    mesh = make_mesh(n_z=n_z)
    a = ShardedTSDFIntegrator(grid, PARAMS, mesh, dtype=dtype)
    a.reset().integrate(views)
    b = ShardedTSDFIntegrator(grid, PARAMS, mesh, dtype=dtype,
                              slab_interleave=True)
    b.reset().integrate(views)
    np.testing.assert_array_equal(a.result(), b.result())
    # Resume seeding round-trips through the permutation too.
    c = ShardedTSDFIntegrator(grid, PARAMS, mesh, dtype=dtype,
                              slab_interleave=True)
    c.reset(a.result())
    np.testing.assert_array_equal(c.result(), a.result())
