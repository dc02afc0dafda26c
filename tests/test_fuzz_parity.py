"""Randomized-geometry parity fuzzing: random cameras, grids, and ray
parameters — every integrator must agree with the fp64 oracle."""

import numpy as np
import pytest

from cudadepthmapintegration_tpu import native
from cudadepthmapintegration_tpu.core import (
    Camera,
    DepthMapView,
    RayPotential,
    VoxelGrid,
)
from cudadepthmapintegration_tpu.io import read_vts, write_vts
from cudadepthmapintegration_tpu.ops import TSDFIntegrator, integrate_views_oracle


def random_scene(seed):
    rng = np.random.default_rng(seed)
    grid = VoxelGrid(
        dims=tuple(rng.integers(6, 14, 3)),
        origin=tuple(rng.uniform(-2, 0, 3)),
        spacing=tuple(rng.uniform(0.1, 0.4, 3)),
    )
    views = []
    h, w = int(rng.integers(16, 40)), int(rng.integers(130, 200))
    for _ in range(int(rng.integers(2, 5))):
        # Random rotation via QR; random placement around the grid.
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        rt = np.eye(4)
        rt[:3, :3] = q
        rt[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, rng.uniform(2, 5)]
        k = np.array(
            [
                [rng.uniform(30, 120), 0, w / 2 + rng.uniform(-5, 5)],
                [0, rng.uniform(30, 120), h / 2 + rng.uniform(-5, 5)],
                [0, 0, 1],
            ]
        )
        depth = rng.uniform(0.5, 6.0, (h, w))
        depth[rng.uniform(size=(h, w)) < 0.1] = -1.0  # invalid holes
        views.append(DepthMapView(depth=depth, camera=Camera(k=k, rt=rt)))
    params = RayPotential(
        thick=float(rng.uniform(0.02, 0.3)),
        rho=float(rng.uniform(0.2, 1.5)),
        eta=float(rng.uniform(0.0, 1.0)),
        delta=0.0,
    )
    params = RayPotential(
        thick=params.thick, rho=params.rho, eta=params.eta,
        delta=params.thick * float(rng.uniform(1.0, 4.0)),
    )
    return grid, views, params


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_xla_fp64_matches_oracle_fuzzed(seed):
    grid, views, params = random_scene(seed)
    got = (
        TSDFIntegrator(grid, params, dtype=np.float64)
        .reset()
        .integrate(views)
        .result()
    )
    exp = integrate_views_oracle(grid, views, params)
    np.testing.assert_allclose(got, exp, atol=1e-9)


@pytest.mark.parametrize("seed", range(11, 21))
def test_xla_fp32_matches_oracle_fuzzed(seed):
    grid, views, params = random_scene(seed)
    got = (
        TSDFIntegrator(grid, params, dtype=np.float32)
        .reset()
        .integrate(views)
        .result()
    )
    exp = integrate_views_oracle(grid, views, params)
    # fp32 rounding can flip a borderline pixel; allow a tiny fraction.
    mismatch = (np.abs(got - exp) > 1e-3).mean()
    assert mismatch < 5e-3


@pytest.mark.parametrize("seed", range(31, 41))
def test_kernel_matches_oracle_fuzzed(seed):
    """The GPU integrate kernel (Pallas interpreter) on random geometry."""
    import jax.numpy as jnp

    from cudadepthmapintegration_tpu.kernels.integrate_triton import (
        integrate_triton,
    )
    from cudadepthmapintegration_tpu.ops import projection_tables

    grid, views, params = random_scene(seed)
    t = projection_tables(grid, views, np.float32)
    d = np.stack([v.depth for v in views]).astype(np.float32)
    got = integrate_triton(
        jnp.zeros(grid.volume_shape, jnp.float32),
        *[jnp.asarray(a) for a in (t.tx, t.ty, t.tz, t.tc, d)],
        h=d.shape[1], w=d.shape[2], thick=params.thick, rho=params.rho,
        eta=params.eta, delta=params.delta, interpret=True,
    )
    exp = integrate_views_oracle(grid, views, params)
    mismatch = (np.abs(np.asarray(got) - exp) > 1e-3).mean()
    assert mismatch < 5e-3


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_native_matches_oracle_fuzzed(seed):
    grid, views, params = random_scene(seed)
    got = native.integrate_f64(grid, views, params)
    exp = integrate_views_oracle(grid, views, params)
    np.testing.assert_allclose(got, exp, atol=1e-12)


def test_vts_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 4, 5, 3))
    cells = rng.normal(size=(2 * 3 * 4)).astype(np.float64)
    p = str(tmp_path / "g.vts")
    write_vts(p, pts, cell_arrays={"reconstruction_scalar": cells})
    back_pts, point_arrays, cell_arrays = read_vts(p)
    np.testing.assert_allclose(back_pts, pts, atol=1e-6)
    np.testing.assert_array_equal(cell_arrays["reconstruction_scalar"], cells)
