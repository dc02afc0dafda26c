"""Extended offline parity fuzz (CPU).

Runs many random scenes (tests/test_fuzz_parity.random_scene) through the
XLA integrator (fp64 and fp32), the native C++ oracle, both marching-cubes
implementations and occlusion-mode coloration, against the fp64 oracles,
and reports any violation. The pytest fuzz covers a handful of seeds,
this sweeps hundreds.

Usage: python scripts/fuzz_extended.py [n_seeds=100] [seed0=1000]
"""

import sys

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from cudadepthmapintegration_tpu import native
from cudadepthmapintegration_tpu.ops import (
    TSDFIntegrator,
    integrate_views_oracle,
)

from test_fuzz_parity import random_scene  # noqa: E402


def check(seed) -> list[str]:
    bad = []
    grid, views, params = random_scene(seed)
    exp = integrate_views_oracle(grid, views, params)

    got64 = (
        TSDFIntegrator(grid, params, dtype=np.float64)
        .reset().integrate(views).result()
    )
    if not np.allclose(got64, exp, atol=1e-9):
        bad.append("xla_fp64")

    if native.available():
        gotn = native.integrate_f64(grid, views, params)
        if not np.allclose(gotn, exp, atol=1e-12):
            bad.append("native")

    got32 = (
        TSDFIntegrator(grid, params, dtype=np.float32)
        .reset().integrate(views).result()
    )
    if (np.abs(got32 - exp) > 1e-3).mean() >= 5e-3:
        bad.append("xla_fp32_vs_oracle")
    return bad


def check_marching_cubes(seed) -> list[str]:
    """Random band-limited volumes: the JAX and native C++ marching-cubes
    implementations share the weld-key contract, so outputs must match
    EXACTLY (points to 1e-12, triangle indices bitwise)."""
    from cudadepthmapintegration_tpu.ops.marching_cubes import marching_cubes

    if not native.available():
        return []
    rng = np.random.default_rng(seed ^ 0x3C3C)
    n = int(rng.integers(6, 18))
    xs = np.linspace(-1.5, 1.5, n)
    # Smooth random field: few random Fourier-ish bumps + sphere bias.
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = 1.0 - np.sqrt(gx * gx + gy * gy + gz * gz)
    for _ in range(int(rng.integers(1, 4))):
        c = rng.uniform(-1, 1, 3)
        s = rng.uniform(0.3, 1.0)
        vol += rng.uniform(-0.8, 0.8) * np.exp(
            -(((gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2) / s**2)
        )
    vol = vol.transpose(2, 1, 0)  # (z, y, x)
    iso = float(rng.uniform(-0.3, 0.3))
    a = marching_cubes(vol, iso, xs, xs, xs, backend="jax",
                       compute_normals=True)
    b = marching_cubes(vol, iso, xs, xs, xs, backend="native",
                       compute_normals=True)
    bad = []
    if a.num_points != b.num_points or a.num_triangles != b.num_triangles:
        bad.append("mc_counts")
    elif a.num_points and not (
        np.allclose(a.points, b.points, atol=1e-12)
        and np.array_equal(a.triangles, b.triangles)
    ):
        bad.append("mc_values")
    elif a.num_points:
        na, nb = a.point_data["Normals"], b.point_data["Normals"]
        if not np.array_equal(na, nb):
            bad.append("mc_normals")  # same weld keys -> bitwise contract
        nrm = np.linalg.norm(na, axis=1)
        if not np.allclose(nrm[nrm > 0], 1.0, atol=1e-5):
            bad.append("mc_normal_length")
    return bad


def check_occlusion(seed) -> list[str]:
    """Occlusion-mode coloration (xla, fp64 projection) vs a direct numpy
    restatement of the predicate: in-bounds AND depth != -1 AND z > 0 AND
    z <= depth + tol."""
    from cudadepthmapintegration_tpu.core.camera import round_half_away
    from cudadepthmapintegration_tpu.ops.coloration import colorize_points

    bad = []
    _grid, views, _params = random_scene(seed)
    rng = np.random.default_rng(seed ^ 0x0CC1)
    for v in views:
        if v.color is None:
            v.color = np.zeros(v.depth.shape + (3,), np.uint8)
        v.color[:] = rng.integers(0, 256, v.color.shape, dtype=np.uint8)
    pts = (rng.random((int(rng.integers(50, 400)), 3)) - 0.5) * 6.0
    tol = float(rng.uniform(0.0, 0.5))
    _, _, counts = colorize_points(
        pts, views, dtype=np.float64, occlusion_tol=tol
    )
    h, w = views[0].depth.shape
    exp = np.zeros(len(pts), np.int32)
    for i, p in enumerate(pts):
        for v in views:
            cam = v.camera.rt[:3, :3] @ p + v.camera.rt[:3, 3]
            hom = v.camera.k @ cam
            u = round_half_away(hom[0] / hom[2])
            vv = round_half_away(hom[1] / hom[2])
            if u < 0 or vv < 0 or u >= w or vv >= h:
                continue
            d = np.float32(v.depth[int(vv), int(u)])
            if d != -1.0 and hom[2] > 0 and hom[2] <= d + tol:
                exp[i] += 1
    if not np.array_equal(counts, exp):
        bad.append("occlusion_counts")
    return bad


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    s0 = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    failures = 0
    for i in range(n):
        seed = s0 + i
        bad = (
            check(seed)
            + check_marching_cubes(seed)
            + check_occlusion(seed)
        )
        if bad:
            failures += 1
            print(f"seed {seed}: FAIL {bad}", flush=True)
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{n}] failures so far: {failures}", flush=True)
    print(f"done: {failures} failing seeds of {n}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
