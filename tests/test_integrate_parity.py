"""Integrator parity against the float64 oracle, per implementation.

``xla`` is TSDFIntegrator on the CPU (the ``_integrate_batched`` path);
``kernel`` is the GPU integrate kernel run by the Pallas interpreter. The
float32 cases allow the flip budget of ``testing/parity.py``; float64 XLA
must match the oracle exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cudadepthmapintegration_tpu.core import DepthMapView, VoxelGrid
from cudadepthmapintegration_tpu.core import RayPotential
from cudadepthmapintegration_tpu.kernels import integrate_triton as kernel_mod
from cudadepthmapintegration_tpu.kernels.integrate_triton import (
    fits_int32_offsets,
    integrate_triton,
)
from cudadepthmapintegration_tpu.ops import (
    TSDFIntegrator,
    integrate_views_oracle,
    projection_tables,
)
from cudadepthmapintegration_tpu.testing import (
    look_at_camera,
    orbit_cameras,
    render_sphere_view,
    sphere_scene,
)
from cudadepthmapintegration_tpu.testing.parity import (
    FLIP_BUDGET,
    flip_fraction,
    parity_cases,
)

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
CASES = parity_cases()
IMPLS = ("xla", "kernel")


def small_grid(dims=(17, 17, 17)):
    return VoxelGrid(dims=dims, origin=(-1.63, -1.61, -1.59),
                     spacing=(0.2, 0.2, 0.2))


def fuse(impl, grid, views, params, thr=None, calls=1, view_batch=8):
    """Fuse `views` in `calls` consecutive integrate calls."""
    chunks = [list(c) for c in np.array_split(np.arange(len(views)), calls)]
    if impl == "xla":
        integ = TSDFIntegrator(grid, params, dtype=np.float32,
                               view_batch=view_batch).reset()
        for c in chunks:
            integ.integrate([views[i] for i in c], thr)
        return integ.result()
    vol = jnp.zeros(grid.volume_shape, jnp.float32)
    for c in chunks:
        vs = [views[i] for i in c]
        if thr is not None:
            vs = [v.thresholded(thr) for v in vs]
        t = projection_tables(grid, vs, np.float32)
        d = np.stack([v.depth for v in vs]).astype(np.float32)
        h, w = d.shape[1:]
        vol = integrate_triton(
            vol, *[jnp.asarray(a) for a in (t.tx, t.ty, t.tz, t.tc, d)],
            h=int(h), w=int(w), thick=params.thick, rho=params.rho,
            eta=params.eta, delta=params.delta, interpret=True,
        )
    return np.asarray(vol)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_parity_case_fp32_within_flip_budget(case, impl):
    name, grid, views, params, thr = CASES[case]
    exp = integrate_views_oracle(grid, views, params, threshold_best_cost=thr)
    got = fuse(impl, grid, views, params, thr)
    assert flip_fraction(got, exp) <= FLIP_BUDGET
    assert np.abs(exp).max() > 0.5  # the scene reaches the grid


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_parity_case_xla_fp64_exact(case):
    name, grid, views, params, thr = CASES[case]
    exp = integrate_views_oracle(grid, views, params, threshold_best_cost=thr)
    got = (
        TSDFIntegrator(grid, params, dtype=np.float64)
        .reset()
        .integrate(views, thr)
        .result()
    )
    np.testing.assert_allclose(got, exp, atol=1e-9)


def _inside_out_views():
    w, h = 144, 64
    cams = [
        look_at_camera((0.2, 0.0, 0.1), (2.0, 0.3, 0.0), focal=40.0,
                       width=w, height=h),
        look_at_camera((-0.1, 0.2, 0.0), (-2.0, 0.0, 0.4), focal=40.0,
                       width=w, height=h),
    ]
    # A camera inside the sphere sees no surface: give it a wall at 1.5.
    return [DepthMapView(depth=np.full((h, w), 1.5), camera=c) for c in cams]


def _top_down_roll_views():
    w, h = 144, 64
    views = []
    for a in (0.0, 0.7, 2.1):
        cam = look_at_camera((0.3, -0.2, 4.0), (0.3, -0.2, 0.0),
                             up=(np.cos(a), np.sin(a), 0.0), focal=60.0,
                             width=w, height=h)
        views.append(render_sphere_view(cam, w, h))
    return views


def _hd_views():
    return sphere_scene(n_views=2, width=1920, height=1080, focal=1000.0)


def _behind_camera_views():
    # The grid lies behind this camera; a mirror projection must not count.
    w, h = 96, 64
    cam = look_at_camera((0.0, 0.0, 2.5), (0.0, 0.0, 6.0), focal=60.0,
                         width=w, height=h)
    return [DepthMapView(depth=np.full((h, w), 2.0), camera=cam)]


def _all_invalid_views():
    views = sphere_scene(n_views=3, width=96, height=64, focal=60.0)
    return [DepthMapView(depth=np.full_like(v.depth, -1.0), camera=v.camera)
            for v in views]


GEOMETRY = {
    "inside_out_rig": _inside_out_views,
    "top_down_roll": _top_down_roll_views,
    "hd_1920x1080_maps": _hd_views,
    "behind_camera": _behind_camera_views,
    "all_invalid": _all_invalid_views,
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", sorted(GEOMETRY))
def test_geometry_family_matches_oracle(family, impl):
    views = GEOMETRY[family]()
    grid = small_grid()
    exp = integrate_views_oracle(grid, views, PARAMS)
    got = fuse(impl, grid, views, PARAMS)
    assert flip_fraction(got, exp) <= FLIP_BUDGET
    if family in ("behind_camera", "all_invalid"):
        assert not got.any()


@pytest.mark.parametrize("impl", IMPLS)
def test_view_count_not_multiple_of_view_batch(impl):
    views = sphere_scene(n_views=5, width=96, height=64, focal=60.0)
    grid = small_grid()
    exp = integrate_views_oracle(grid, views, PARAMS)
    got = fuse(impl, grid, views, PARAMS, view_batch=2)
    assert flip_fraction(got, exp) <= FLIP_BUDGET


@pytest.mark.parametrize("impl", IMPLS)
def test_one_call_equals_streamed_calls(impl):
    # Same per-voxel add order either way (XLA: the same view_batch chunks;
    # kernel: one view at a time), so the volumes are bit-identical.
    cams = orbit_cameras(6, 3.5, height=1.0, focal=60.0, width=96,
                         image_height=64)
    views = [render_sphere_view(c, 96, 64) for c in cams]
    grid = small_grid()
    one = fuse(impl, grid, views, PARAMS, view_batch=2)
    streamed = fuse(impl, grid, views, PARAMS, calls=3, view_batch=2)
    np.testing.assert_array_equal(one, streamed)


@pytest.mark.parametrize(
    "dims", [(17, 17, 17), (70, 21, 6), (130, 40, 3)],
    ids=["inside_one_tile", "ragged_x_y", "two_x_tiles"],
)
def test_kernel_tiles_cover_ragged_grids(dims):
    """Grids whose axes are not multiples of the kernel tile: every voxel
    is fused once and nothing outside the grid is written."""
    views = sphere_scene(n_views=3, width=96, height=64, focal=60.0)
    grid = VoxelGrid(dims=dims, origin=(-1.63, -1.61, -0.31),
                     spacing=(3.2 / (dims[0] - 1), 3.2 / (dims[1] - 1), 0.2))
    exp = integrate_views_oracle(grid, views, PARAMS)
    got = fuse("kernel", grid, views, PARAMS)
    assert got.shape == grid.volume_shape
    assert flip_fraction(got, exp) <= FLIP_BUDGET
    assert np.abs(exp).max() > 0.5


def test_kernel_accumulates_into_initial_volume():
    views = sphere_scene(n_views=2, width=96, height=64, focal=60.0)
    grid = small_grid()
    t = projection_tables(grid, views, np.float32)
    d = np.stack([v.depth for v in views]).astype(np.float32)
    init = np.random.default_rng(0).normal(size=grid.volume_shape)
    got = integrate_triton(
        jnp.asarray(init, jnp.float32),
        *[jnp.asarray(a) for a in (t.tx, t.ty, t.tz, t.tc, d)],
        h=64, w=96, thick=PARAMS.thick, rho=PARAMS.rho, eta=PARAMS.eta,
        delta=PARAMS.delta, interpret=True,
    )
    exp = integrate_views_oracle(grid, views, PARAMS, initial=init)
    assert flip_fraction(np.asarray(got), exp) <= FLIP_BUDGET
    np.testing.assert_allclose(np.asarray(got), exp, atol=2e-3)


def test_kernel_refuses_cpu_without_interpreter():
    f32 = lambda *shape: jnp.zeros(shape, jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        integrate_triton(
            f32(2, 3, 4), f32(1, 4, 4), f32(1, 4, 3), f32(1, 4, 2),
            f32(1, 4), f32(1, 5, 6),
            h=5, w=6, thick=0.1, rho=0.8, eta=0.03, delta=0.3,
        )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_integrator_on_cpu_takes_xla_path(dtype):
    views = sphere_scene(n_views=5, width=96, height=64, focal=60.0)
    integ = TSDFIntegrator(small_grid(), PARAMS, dtype=dtype,
                           view_batch=2).reset()
    integ.integrate(views)
    assert not integ.use_kernel
    assert integ.volume_sweeps == 3  # ceil(5 / 2) XLA chunks
    assert integ.views_fused == 5


@pytest.mark.parametrize(
    "volume_size, n_views, h, w, fits",
    [
        (1290**3, 64, 512, 512, True),
        (1291**3, 64, 512, 512, False),
        (2**31 - 1, 1, 1080, 1920, True),
        (512**3, 1035, 1080, 1920, True),
        (512**3, 1036, 1080, 1920, False),
    ],
    ids=["grid_1290", "grid_1291", "grid_max", "views_1035_hd", "views_1036_hd"],
)
def test_kernel_int32_offset_limit(volume_size, n_views, h, w, fits):
    assert fits_int32_offsets(volume_size, n_views, h, w) is fits


def test_integrator_falls_back_to_xla_past_offset_limit(monkeypatch):
    """A call the kernel cannot index takes the XLA path, even where the
    kernel is selected (on a CPU the kernel call itself would raise)."""
    views = sphere_scene(n_views=5, width=96, height=64, focal=60.0)
    grid = small_grid()
    monkeypatch.setattr(kernel_mod, "MAX_OFFSET", grid.num_cells)
    integ = TSDFIntegrator(grid, PARAMS, view_batch=2).reset()
    integ.use_kernel = True
    got = integ.integrate(views).result()
    assert integ.volume_sweeps == 3  # ceil(5 / 2) XLA chunks
    exp = integrate_views_oracle(grid, views, PARAMS)
    assert flip_fraction(got, exp) <= FLIP_BUDGET


def test_integrator_kernel_request_on_cpu_raises():
    views = sphere_scene(n_views=2, width=96, height=64, focal=60.0)
    integ = TSDFIntegrator(small_grid(), PARAMS).reset()
    integ.use_kernel = True
    with pytest.raises(ValueError, match="interpret"):
        integ.integrate(views)
