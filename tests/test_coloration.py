"""Coloration parity vs a literal per-vertex NumPy re-statement of
Coloration/MeshColoration.cxx:98-199 (including its quirks: no z<0 rejection,
truncating uchar stores, even-count median averaging)."""

import numpy as np

from cudadepthmapintegration_tpu.core.camera import round_half_away
from cudadepthmapintegration_tpu.io.polydata import PolyData
from cudadepthmapintegration_tpu.ops.coloration import colorize_mesh, colorize_points
from cudadepthmapintegration_tpu.testing import sphere_scene


def coloration_oracle(points, views):
    """Scalar reimplementation of the reference loop (fp64)."""
    h, w = views[0].depth.shape
    n = points.shape[0]
    mean = np.zeros((n, 3), np.uint8)
    med = np.zeros((n, 3), np.uint8)
    count = np.zeros((n,), np.int32)
    for i, p in enumerate(points):
        samples = []
        for view in views:
            cam = view.camera.rt[:3, :3] @ p + view.camera.rt[:3, 3]
            hom = view.camera.k @ cam
            u = round_half_away(hom[0] / hom[2])
            v = round_half_away(hom[1] / hom[2])
            if u < 0 or v < 0 or u >= w or v >= h:
                continue
            samples.append(view.color[int(v), int(u)].astype(np.float64))
        if not samples:
            continue
        arr = np.stack(samples)
        count[i] = len(samples)
        mean[i] = (arr.sum(axis=0) / len(samples)).astype(np.uint8)  # truncate
        srt = np.sort(arr, axis=0)
        mid = len(samples) // 2
        if len(samples) % 2 == 0:
            m = (srt[mid] + srt[mid - 1]) / 2
        else:
            m = srt[mid]
        med[i] = m.astype(np.uint8)
    return mean, med, count


def test_colorize_matches_oracle_exactly_in_fp64():
    views = sphere_scene(n_views=5, width=64, height=48)
    rng = np.random.default_rng(7)
    # Points on and around the sphere (some will miss all views).
    pts = rng.normal(size=(200, 3))
    pts = np.vstack([pts / np.linalg.norm(pts, axis=1, keepdims=True), pts * 4.0])
    mean, med, count = colorize_points(pts, views, dtype=np.float64)
    emean, emed, ecount = coloration_oracle(pts, views)
    np.testing.assert_array_equal(count, ecount)
    np.testing.assert_array_equal(mean, emean)
    np.testing.assert_array_equal(med, emed)
    assert count.max() >= 2  # some point saw multiple views


def test_colorize_fp32_close_to_oracle():
    views = sphere_scene(n_views=5, width=64, height=48)
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(200, 3))
    mean, med, count = colorize_points(pts, views, dtype=np.float32)
    emean, emed, ecount = coloration_oracle(pts, views)
    # fp32 projection may flip boundary pixels: counts differ on a small
    # fraction, and flipped pixels sample a neighbor with near-identical
    # shading, so color error stays tiny.
    assert np.mean(count != ecount) < 0.05
    agree = count == ecount
    err = np.abs(mean[agree].astype(int) - emean[agree].astype(int))
    assert np.mean(err > 3) < 0.02
    assert np.median(err) == 0


def test_zero_hit_vertices_stay_zero():
    views = sphere_scene(n_views=2, width=32, height=24)
    pts = np.full((4, 3), 1e6)  # far outside every frustum
    mean, med, count = colorize_points(pts, views)
    np.testing.assert_array_equal(count, 0)
    np.testing.assert_array_equal(mean, 0)
    np.testing.assert_array_equal(med, 0)


def test_colorize_mesh_attaches_arrays():
    views = sphere_scene(n_views=3, width=48, height=36)
    pts = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    mesh = PolyData(pts, np.array([[0, 1, 2]]))
    out = colorize_mesh(mesh, views)
    assert out.point_data["MeanColoration"].shape == (3, 3)
    assert out.point_data["MedianColoration"].dtype == np.uint8
    assert out.point_data["NbProjectedDepthMap"].dtype == np.int32
    assert out.point_data["NbProjectedDepthMap"].sum() > 0
    # Input mesh untouched.
    assert "MeanColoration" not in mesh.point_data


def test_even_count_median_averages():
    # Craft 4 views all seeing the sphere center with distinct constant colors.
    views = sphere_scene(n_views=4, width=64, height=48)
    vals = [10, 20, 40, 80]
    for view, val in zip(views, vals):
        view.color[:] = val
    pts = np.array([[0.0, 0.0, 0.0]])  # scene center: visible in every view
    mean, med, count = colorize_points(pts, views)
    assert int(count[0]) == 4
    # median of [10, 20, 40, 80] -> (20 + 40) / 2 = 30; mean 150/4 -> 37 (trunc)
    np.testing.assert_array_equal(med[0], [30, 30, 30])
    np.testing.assert_array_equal(mean[0], [37, 37, 37])
    emean, emed, ecount = coloration_oracle(pts, views)
    np.testing.assert_array_equal(med, emed)
    np.testing.assert_array_equal(mean, emean)


def test_view_chunking_matches_single_batch():
    """Streamed view batches (with a padded last batch) must give results
    identical to one full batch, for every chunk boundary case."""
    views = sphere_scene(n_views=7, width=64, height=48)
    rng = np.random.default_rng(0)
    for view in views:
        view.color[:] = rng.integers(0, 256, view.color.shape, dtype=np.uint8)
    pts = (rng.random((37, 3)) - 0.5) * 2.2
    ref = colorize_points(pts, views, view_chunk=7)
    for vc in (1, 2, 3, 7, 64):
        out = colorize_points(pts, views, view_chunk=vc)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    # Vertex chunking too.
    out = colorize_points(pts, views, chunk=8, view_chunk=2)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_compat_int_mean_matches_float_mean_for_uchar():
    """The reference's int-accumulate numerator (MeshColoration.cxx:176-178)
    is lossless for uchar samples: the toggle must not change results."""
    views = sphere_scene(n_views=5, width=64, height=48)
    rng = np.random.default_rng(1)
    for view in views:
        view.color[:] = rng.integers(0, 256, view.color.shape, dtype=np.uint8)
    pts = (rng.random((21, 3)) - 0.5) * 2.0
    a = colorize_points(pts, views, compat_int_mean=False)
    b = colorize_points(pts, views, compat_int_mean=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_lazy_view_sequence_supported():
    """colorize_points must accept a lazily-indexed view sequence (the
    fuse_rgbd second-pass path) and never hold more than a batch."""
    views = sphere_scene(n_views=6, width=64, height=48)
    loads = []

    class Lazy:
        def __len__(self):
            return len(views)

        def __getitem__(self, i):
            loads.append(i)
            return views[i]

    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    out = colorize_points(pts, Lazy(), view_chunk=2)
    ref = colorize_points(pts, views)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert sorted(set(loads)) == list(range(6))


def _frontal_view(depth_value=2.0, w=32, h=24):
    """Camera at origin looking down +z: u = 10*x/z + 16, v = 10*y/z + 12."""
    from cudadepthmapintegration_tpu.core.camera import Camera
    from cudadepthmapintegration_tpu.core.view import DepthMapView

    k = np.array([[10.0, 0, 16.0], [0, 10.0, 12.0], [0, 0, 1.0]])
    depth = np.full((h, w), depth_value, np.float64)
    color = np.full((h, w, 3), 200, np.uint8)
    return DepthMapView(depth=depth, camera=Camera(k=k, rt=np.eye(4)),
                        color=color)


def test_occlusion_tol_rejects_hidden_and_invalid_samples():
    view = _frontal_view(depth_value=2.0)
    view.depth[0, :] = -1.0  # one invalid row (v=0 <- y large negative)
    pts = np.array([
        [0.0, 0.0, 2.0],    # on the surface -> visible
        [0.0, 0.0, 3.0],    # 1.0 behind the surface -> occluded
        [0.0, 0.0, 1.0],    # in front of the surface -> visible
        [0.0, -2.4, 2.0],   # projects to the invalid row -> no evidence
    ])
    # Reference behavior: everything in-bounds counts.
    _, _, base = colorize_points(pts, [view])
    np.testing.assert_array_equal(base, [1, 1, 1, 1])
    # Occlusion mode: hidden + invalid-depth samples rejected.
    mean, _, count = colorize_points(pts, [view], occlusion_tol=0.1)
    np.testing.assert_array_equal(count, [1, 0, 1, 0])
    np.testing.assert_array_equal(mean[0], [200, 200, 200])
    np.testing.assert_array_equal(mean[1], [0, 0, 0])
    # Tolerance admits samples within it.
    _, _, c2 = colorize_points(pts, [view], occlusion_tol=1.5)
    np.testing.assert_array_equal(c2, [1, 1, 1, 0])


def test_occlusion_tol_rejects_behind_camera_vertices():
    """A vertex BEHIND the camera mirror-projects in-bounds with z < 0,
    which trivially satisfies z <= d + tol — occlusion mode must reject
    it (no visibility evidence) even without the separate z_test opt-in,
    while the reference-parity default keeps counting it
    (MeshColoration.cxx:158-163 has no z sign test)."""
    view = _frontal_view(depth_value=2.0)
    pts = np.array([
        [0.0, 0.0, 2.0],     # in front, on the surface
        [0.0, 0.0, -2.0],    # behind the camera, mirror hits the center
    ])
    _, _, base = colorize_points(pts, [view])
    np.testing.assert_array_equal(base, [1, 1])  # reference quirk parity
    _, _, count = colorize_points(pts, [view], occlusion_tol=0.1)
    np.testing.assert_array_equal(count, [1, 0])

