"""TUM RGB-D reader: synthetic dataset round-trip + fusion smoke test."""

import os
import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image

from cudadepthmapintegration_tpu.core import RayPotential
from cudadepthmapintegration_tpu.io.tum import (
    TUMDataset,
    TUMIntrinsics,
    quaternion_to_rotation,
)
from cudadepthmapintegration_tpu.ops.sparse_grid import SparseTSDFGrid
from cudadepthmapintegration_tpu.testing import sphere_scene


def make_tum_dir(tmp_path, views, scale=5000.0):
    (tmp_path / "depth").mkdir()
    (tmp_path / "rgb").mkdir()
    depth_lines, rgb_lines, gt_lines = ["# depth"], ["# rgb"], ["# gt"]
    for i, v in enumerate(views):
        t = 100.0 + i * 0.1
        dpng = np.where(v.depth > 0, v.depth * scale, 0).astype(np.uint16)
        Image.fromarray(dpng).save(tmp_path / "depth" / f"{t:.6f}.png")
        Image.fromarray(v.color).save(tmp_path / "rgb" / f"{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        # Camera pose in world = inverse of the view's world->camera RT.
        rt = v.camera.rt
        r_cw = rt[:3, :3].T
        t_w = -r_cw @ rt[:3, 3]
        # Rotation -> quaternion.
        m = r_cw
        qw = np.sqrt(max(0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
        qx = (m[2, 1] - m[1, 2]) / (4 * qw)
        qy = (m[0, 2] - m[2, 0]) / (4 * qw)
        qz = (m[1, 0] - m[0, 1]) / (4 * qw)
        gt_lines.append(
            f"{t + 0.002:.6f} {t_w[0]} {t_w[1]} {t_w[2]} {qx} {qy} {qz} {qw}"
        )
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def test_quaternion_identity():
    np.testing.assert_allclose(quaternion_to_rotation(0, 0, 0, 1), np.eye(3))


def test_tum_roundtrip(tmp_path):
    views = sphere_scene(n_views=3, width=64, height=48, focal=60.0)
    intr = TUMIntrinsics(60.0, 60.0, 32.0, 24.0)
    make_tum_dir(tmp_path, views)
    ds = TUMDataset(str(tmp_path), intrinsics=intr)
    assert len(ds) == 3
    v0 = ds[0]
    # Depth round-trips through the 16-bit PNG (quantized to 1/5000 m).
    valid = views[0].depth > 0
    np.testing.assert_allclose(
        v0.depth[valid], views[0].depth[valid], atol=1.1 / 5000
    )
    np.testing.assert_array_equal(v0.depth[~valid], -1.0)
    np.testing.assert_array_equal(v0.color, views[0].color)
    # Pose recovered (world->camera RT) to float precision.
    np.testing.assert_allclose(v0.camera.rt, views[0].camera.rt, atol=1e-6)


def test_tum_sparse_fusion_smoke(tmp_path):
    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    intr = TUMIntrinsics(60.0, 60.0, 32.0, 24.0)
    make_tum_dir(tmp_path, views)
    ds = TUMDataset(str(tmp_path), intrinsics=intr)
    params = RayPotential(thick=0.06, rho=0.8, eta=0.03, delta=0.2)
    sparse = SparseTSDFGrid(voxel_size=0.1, params=params, pixel_stride=2)
    for frame in ds:
        sparse.integrate_frame(frame)
    mesh = sparse.extract_mesh(iso=1.0)
    radii = np.linalg.norm(mesh.points, axis=1)
    assert mesh.num_triangles > 50
    assert abs(np.median(radii) - 1.0) < 0.15


def test_fuse_rgbd_cli_end_to_end(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp

    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    make_tum_dir(tmp_path, views)
    out = str(tmp_path / "mesh.vtp")
    rc = fuse_rgbd.main([
        "--tum", str(tmp_path), "--voxelSize", "0.1",
        "--pixelStride", "2", "--contour", "1.0",
        "--intrinsics", "custom",
        "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24",
        "--output", out, "--colorize", "--verbose",
    ])
    assert rc == 0
    mesh = read_vtp(out)
    assert "MeanColoration" in mesh.point_data
    radii = np.linalg.norm(mesh.points, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.15  # real sphere recovered
    # custom without values -> clean error
    assert (
        fuse_rgbd.main(
            ["--tum", str(tmp_path), "--intrinsics", "custom",
             "--output", str(tmp_path / "x.vtp")]
        )
        == 1
    )


def test_fuse_rgbd_cli_validation(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd

    assert fuse_rgbd.main(["--output", "m.vtp"]) == 1  # no input given
    assert fuse_rgbd.main(["--tum", "x", "--vti", "y", "--output", "m.vtp"]) == 1
    assert fuse_rgbd.main(["--vti", "a.txt", "--output", "m.vtp"]) == 1  # no krtd
    assert fuse_rgbd.main(["--tum", str(tmp_path), "--output", "m.obj"]) == 1


def test_fuse_rgbd_cli_block_budget(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp

    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    make_tum_dir(tmp_path, views)
    out = str(tmp_path / "budget.vtp")
    rc = fuse_rgbd.main([
        "--tum", str(tmp_path), "--voxelSize", "0.1",
        "--pixelStride", "2", "--contour", "1.0",
        "--intrinsics", "custom",
        "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24",
        "--blockBudget", "64",
        "--output", out,
    ])
    assert rc == 0
    mesh = read_vtp(out)  # still a mesh, from the capped working set
    assert mesh.num_triangles > 20


def test_fuse_rgbd_cli_online_color(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp

    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    make_tum_dir(tmp_path, views)
    out = str(tmp_path / "online.vtp")
    rc = fuse_rgbd.main([
        "--tum", str(tmp_path), "--voxelSize", "0.1",
        "--pixelStride", "2", "--contour", "1.0",
        "--intrinsics", "custom",
        "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24",
        "--output", out, "--onlineColor",
    ])
    assert rc == 0
    mesh = read_vtp(out)
    assert "MeanColoration" in mesh.point_data
    assert "ColorWeight" in mesh.point_data
    assert (mesh.point_data["ColorWeight"] > 0).mean() > 0.9
    assert mesh.point_data["MeanColoration"].max() > 0
    # --colorize and --onlineColor are mutually exclusive.
    assert fuse_rgbd.main([
        "--tum", str(tmp_path), "--output", out,
        "--colorize", "--onlineColor",
    ]) == 1


def test_fuse_rgbd_cli_checkpoint_resume(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp
    from cudadepthmapintegration_tpu.ops.sparse_grid import SparseTSDFGrid

    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    make_tum_dir(tmp_path, views)
    base = [
        "--tum", str(tmp_path), "--voxelSize", "0.1",
        "--pixelStride", "2", "--contour", "1.0",
        "--intrinsics", "custom",
        "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24",
    ]
    # Reference: all 6 frames in one run.
    ref_out = str(tmp_path / "ref.vtp")
    assert fuse_rgbd.main(base + ["--output", ref_out]) == 0

    # Two-run resume: 3 frames, then the remaining 3 from the checkpoint.
    ck = str(tmp_path / "grid.ckpt.npz")
    out1 = str(tmp_path / "half.vtp")
    assert fuse_rgbd.main(
        base + ["--output", out1, "--checkpoint", ck,
                "--checkpointEvery", "2", "--maxFrames", "3"]
    ) == 0
    assert os.path.exists(ck)
    g, extra = SparseTSDFGrid.load(ck)
    assert g.frames_fused == 3 and extra["next_index"] == 3

    out2 = str(tmp_path / "resumed.vtp")
    assert fuse_rgbd.main(
        base + ["--output", out2, "--checkpoint", ck]
    ) == 0
    ref = read_vtp(ref_out)
    got = read_vtp(out2)
    assert got.num_points == ref.num_points
    np.testing.assert_allclose(got.points, ref.points, atol=1e-5)

    # Mismatched config is rejected cleanly.
    assert fuse_rgbd.main(
        base[:2] + ["--voxelSize", "0.2"] + base[4:]
        + ["--output", out2, "--checkpoint", ck]
    ) == 1


def test_sparse_grid_save_load_roundtrip(tmp_path):
    from cudadepthmapintegration_tpu.ops.sparse_grid import SparseTSDFGrid
    from cudadepthmapintegration_tpu.core.ray_potential import RayPotential

    views = sphere_scene(n_views=3, width=64, height=48, focal=60.0)
    params = RayPotential(thick=0.2, rho=0.8, eta=0.03, delta=0.8)
    g = SparseTSDFGrid(voxel_size=0.1, params=params, pixel_stride=2,
                       with_color=True)
    for v in views:
        g.integrate_frame(v)
    path = str(tmp_path / "g.npz")
    g.save(path, extra={"next_index": 7})
    g2, extra = SparseTSDFGrid.load(path)
    assert extra == {"next_index": 7}
    assert g2.block_map == g.block_map
    assert g2.frames_fused == g.frames_fused
    np.testing.assert_array_equal(np.asarray(g2.pool), np.asarray(g.pool))
    np.testing.assert_array_equal(
        np.asarray(g2.color_pool), np.asarray(g.color_pool)
    )
    # Fusing one more frame after load equals fusing it before save.
    g.integrate_frame(views[0])
    g2.integrate_frame(views[0])
    np.testing.assert_allclose(
        np.asarray(g2.pool), np.asarray(g.pool), atol=1e-6
    )


def test_fuse_rgbd_cli_occlusion_tol(tmp_path):
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp

    views = sphere_scene(n_views=6, width=64, height=48, focal=60.0)
    make_tum_dir(tmp_path, views)
    common = ["--tum", str(tmp_path), "--voxelSize", "0.1",
              "--pixelStride", "2", "--contour", "1.0",
              "--intrinsics", "custom",
              "--fx", "60", "--fy", "60", "--cx", "32", "--cy", "24",
              "--colorize"]
    out_a = str(tmp_path / "plain.vtp")
    out_b = str(tmp_path / "occ.vtp")
    assert fuse_rgbd.main(common + ["--output", out_a]) == 0
    assert fuse_rgbd.main(
        common + ["--output", out_b, "--occlusionTol", "0.2"]
    ) == 0
    a = read_vtp(out_a).point_data["NbProjectedDepthMap"]
    b = read_vtp(out_b).point_data["NbProjectedDepthMap"]
    # Occlusion rejection can only shrink counts, and must reject
    # something on a closed sphere (back-side views are occluded).
    assert (b <= a).all() and b.sum() < a.sum() and b.max() >= 1
