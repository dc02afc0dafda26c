"""Smoke run of the fuse -> mesh -> colour path on an NVIDIA GPU.

Drives the package once through the entry points users call, in one
process, at the sizes users run:

  device       JAX devices, device kind, JAX version, XLA_FLAGS, the card's
               name and power limit, whether the native library built.
  oracle       every integrate implementation (the GPU kernel that
               TSDFIntegrator picks, and the XLA path) against the float64
               oracle on the six parity cases and on a 512x512x16-cell
               z-slab of the 512^3 grid with 64 views of 512x512; the kernel
               against XLA on the whole 512^3 grid with the same views.
  reconstruct  cli.reconstruct.main on a seeded .vti/.krtd folder: 512^3
               cells, 64 orbit views of 512x512 with colour and best cost
               (BASELINE config 3 with 64 of its 200 views).
  colorize     cli.colorize.main on that mesh and those views.
  rgbd         cli.fuse_rgbd.main on 60 seeded 640x480 frames (the TUM frame
               shape) at 1 cm voxels, with --colorize.

Every gate is printed and a failed gate or phase fails the run. The last
line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Where JAX finds no GPU the run prints "ok": false and exits 1.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # z-slab sharded path on four GPUs

``--four-cards`` runs only the sharded path users run on several cards
(``ReconstructionPipeline(mesh=...)``): z-slab fusion, halo cell->point and
sharded colouring at 512^3 x 64 views, each compared with the same work on
one card in the same process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Sizes of the run (tests shrink them). The grid has dims^3 points.
SIZE = dict(
    dims=513, views=64, image=(512, 512), slab_cells=16,
    rgbd_frames=60, rgbd_image=(640, 480), rgbd_voxel=0.01,
)
PLATFORM = "gpu"  # the only platform the smoke measures
RADIUS_TOL = 0.02  # mesh median radius vs the unit sphere
HIT_FRACTION = 0.95  # vertices that need at least one colour sample
NORMAL_TOL = 1e-3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def final_line(ok: bool, devices=None) -> str:
    rec: dict = {"ok": bool(ok)}
    if devices:
        d = devices[0]
        rec["device"] = {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devices),
        }
    return json.dumps(rec)


class Run:
    """Per-phase seconds, gates and failures of one smoke run."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.gates: dict[str, bool] = {}
        self.failed: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        print(f"[{name}] start", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED", flush=True)
        finally:
            self.seconds[name] = time.perf_counter() - t0
            print(f"[{name}] {self.seconds[name]:.3f} s", flush=True)

    def gate(self, name: str, ok: bool, detail: str) -> None:
        self.gates[name] = bool(ok)
        print(f"GATE {name}: {'PASS' if ok else 'FAIL'} ({detail})", flush=True)

    @property
    def ok(self) -> bool:
        return not self.failed and bool(self.gates) and all(self.gates.values())


# ---------------------------------------------------------------------------
# Seeded scenes and the dataset writer.
# ---------------------------------------------------------------------------


def orbit_views(n, width, height, seed, cam_radius=4.0, focal=300.0,
                cam_height=0.0):
    """Orbit views of the unit sphere with colour and a seeded best-cost
    map: matched pixels cost U(0, 0.2), 5% of them are bad matches at 0.9
    (dropped by a best-cost threshold of 0.5), misses cost 1."""
    from cudadepthmapintegration_tpu.testing import (
        orbit_cameras,
        render_sphere_view,
    )

    rng = np.random.default_rng(seed)
    cams = orbit_cameras(n, cam_radius, height=cam_height, focal=focal,
                         width=width, image_height=height)
    views = []
    for cam in cams:
        v = render_sphere_view(cam, width, height, radius=1.0,
                               background=-1.0)
        hit = v.depth > 0
        cost = np.where(hit, rng.uniform(0.0, 0.2, hit.shape), 1.0)
        cost[hit & (rng.random(hit.shape) < 0.05)] = 0.9
        views.append(dataclasses.replace(v, best_cost=cost))
    return views


def write_dataset(folder: str, views) -> tuple[str, str]:
    """Write views as .vti depth maps + .krtd cameras with the reference's
    list files; returns (vti_list, krtd_list)."""
    from cudadepthmapintegration_tpu.io import write_depth_map_vti, write_krtd

    os.makedirs(folder, exist_ok=True)
    names = [f"view{i:04d}" for i in range(len(views))]
    for name, v in zip(names, views):
        write_depth_map_vti(os.path.join(folder, name + ".vti"), v.depth,
                            v.color, v.best_cost)
        write_krtd(os.path.join(folder, name + ".krtd"), v.camera)
    vti_list = os.path.join(folder, "vtiList.txt")
    krtd_list = os.path.join(folder, "kList.txt")
    with open(vti_list, "w") as f:
        f.writelines(n + ".vti\n" for n in names)
    with open(krtd_list, "w") as f:
        f.writelines(n + ".krtd\n" for n in names)
    return vti_list, krtd_list


def sphere_grid(dims, cells_z=None):
    """The reconstruct grid (origin off the decimal lattice, 3.2 wide), or
    its `cells_z`-cell z-slab through the equator."""
    from cudadepthmapintegration_tpu.core import VoxelGrid

    sp = 3.2 / (dims - 1)
    origin = (-1.63, -1.61, -1.59)
    if cells_z is None:
        return VoxelGrid(dims=(dims,) * 3, origin=origin, spacing=(sp,) * 3)
    z0 = origin[2] + ((dims - 1 - cells_z) // 2) * sp
    return VoxelGrid(dims=(dims, dims, cells_z + 1),
                     origin=(origin[0], origin[1], z0), spacing=(sp,) * 3)


def ray_params(grid):
    from cudadepthmapintegration_tpu.core import RayPotential

    sp = grid.spacing[0]
    return RayPotential(thick=2 * sp, rho=0.8, eta=0.03, delta=8 * sp)


# ---------------------------------------------------------------------------
# Fusion through each implementation.
# ---------------------------------------------------------------------------


def fuse_integrator(grid, views, params, thr=None, stream_batch=32):
    """TSDFIntegrator as the pipeline streams it (the kernel on a GPU)."""
    from cudadepthmapintegration_tpu.ops import TSDFIntegrator

    integ = TSDFIntegrator(grid, params).reset()
    for s in range(0, len(views), stream_batch):
        integ.integrate(views[s:s + stream_batch], thr)
    return integ


def fuse_xla(grid, views, params, thr=None):
    """The XLA path (`_integrate_batched`) in float32, all views at once."""
    import jax.numpy as jnp

    from cudadepthmapintegration_tpu.ops import integrate as I

    if thr is not None:
        views = [v.thresholded(thr) for v in views]
    h, w = views[0].depth.shape
    t = I.projection_tables(grid, views, np.float32)
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    return I._integrate_batched(
        jnp.zeros(grid.volume_shape, jnp.float32),
        *[jnp.asarray(a) for a in (t.tx, t.ty, t.tz, t.tc, depths)],
        h=int(h), w=int(w), view_batch=8, thick=params.thick,
        rho=params.rho, eta=params.eta, delta=params.delta,
    )


def xla_kw(views, params):
    h, w = views[0].depth.shape
    return dict(h=int(h), w=int(w), view_batch=8, thick=params.thick,
                rho=params.rho, eta=params.eta, delta=params.delta)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_device(run: Run, devices) -> None:
    import jax

    from cudadepthmapintegration_tpu import native

    with run.phase("device"):
        print(f"jax {jax.__version__} devices {devices}", flush=True)
        print(f"device_kind {devices[0].device_kind}", flush=True)
        print(f"XLA_FLAGS {os.environ.get('XLA_FLAGS')!r}", flush=True)
        print(f"card {card_line()}", flush=True)
        print(f"native library built: {native.available()}", flush=True)


def phase_oracle(run: Run) -> None:
    import jax
    import jax.numpy as jnp

    from cudadepthmapintegration_tpu import native
    from cudadepthmapintegration_tpu.ops import integrate as I
    from cudadepthmapintegration_tpu.ops import integrate_views_oracle
    from cudadepthmapintegration_tpu.testing.parity import (
        FLIP_BUDGET,
        flip_fraction,
        parity_cases,
    )

    # Tolerance: float32 against float64, and voxels on a pixel's half-way
    # line that a rounding difference (FMA contraction, division) sends to
    # the neighbouring pixel. Budget: FLIP_BUDGET of voxels off by > 1e-3.
    with run.phase("oracle"):
        worst = {"kernel": 0.0, "xla": 0.0}
        used_kernel = True
        for name, grid, views, params, thr in parity_cases():
            exp = integrate_views_oracle(grid, views, params,
                                         threshold_best_cost=thr)
            integ = fuse_integrator(grid, views, params, thr)
            used_kernel &= integ.use_kernel
            fk = flip_fraction(integ.result(), exp)
            fx = flip_fraction(np.asarray(fuse_xla(grid, views, params, thr)),
                               exp)
            worst["kernel"] = max(worst["kernel"], fk)
            worst["xla"] = max(worst["xla"], fx)
            print(f"  {name}: kernel {fk:.3e} xla {fx:.3e}", flush=True)
        on_gpu = jax.devices()[0].platform == "gpu"
        run.gate("integrator_path", used_kernel == on_gpu,
                 f"TSDFIntegrator used the GPU kernel: {used_kernel}")
        for impl, f in worst.items():
            run.gate(f"parity_{impl}", f <= FLIP_BUDGET,
                     f"max flip fraction {f:.3e} <= {FLIP_BUDGET:.0e}")

        dims, nv = SIZE["dims"], SIZE["views"]
        w, h = SIZE["image"]
        views = orbit_views(nv, w, h, seed=0)
        slab = sphere_grid(dims, SIZE["slab_cells"])
        params = ray_params(slab)
        t0 = time.perf_counter()
        if native.available():
            exp = native.integrate_f64(slab, views, params)
            src = "native threaded fp64"
        else:
            exp = integrate_views_oracle(slab, views, params)
            src = "NumPy fp64"
        print(f"  slab oracle ({src}) {time.perf_counter() - t0:.3f} s",
              flush=True)
        fk = flip_fraction(fuse_integrator(slab, views, params).result(), exp)
        fx = flip_fraction(np.asarray(fuse_xla(slab, views, params)), exp)
        label = f"{slab.volume_shape} cells x {nv} views"
        run.gate("slab_kernel", fk <= FLIP_BUDGET,
                 f"{label}: flip fraction {fk:.3e} vs {src}")
        run.gate("slab_xla", fx <= FLIP_BUDGET,
                 f"{label}: flip fraction {fx:.3e} vs {src}")

        # No matrix product on the fusion path: TF32 cannot touch it.
        grid = sphere_grid(dims)
        params = ray_params(grid)
        t = I.projection_tables(grid, views[:8], np.float32)
        d = np.stack([v.depth for v in views[:8]]).astype(np.float32)
        args = [jax.ShapeDtypeStruct(a.shape, a.dtype)
                for a in (t.tx, t.ty, t.tz, t.tc, d)]
        vol = jax.ShapeDtypeStruct(grid.volume_shape, jnp.float32)
        hlo = I._integrate_batched.lower(
            vol, *args, **xla_kw(views, params)).compile().as_text()
        no_dot = " dot(" not in hlo and "convolution(" not in hlo
        run.gate("no_matmul_on_fusion_path", no_dot,
                 "no dot/convolution in the compiled XLA fusion HLO")

        # The kernel against XLA on the whole grid. Same tolerance: besides
        # half-pixel lines, voxels where |cam_z - depth| rounds across the
        # ray potential's jump at delta differ by up to rho; XLA sums 8
        # views before adding them to the volume, the kernel adds one view
        # at a time (<= ~1e-5 apart otherwise).
        vk = fuse_integrator(grid, views, params).volume
        vx = fuse_xla(grid, views, params)
        diff = np.asarray(jnp.abs(vk - vx))
        frac = float((diff > 1e-3).mean())
        run.gate("kernel_vs_xla", frac <= FLIP_BUDGET,
                 f"{grid.volume_shape} x {nv} views: {frac:.3e} of voxels "
                 f"differ by > 1e-3 (max {diff.max():.3e})")
        del vk, vx, diff


def phase_reconstruct(run: Run, work: str, state: dict) -> None:
    from cudadepthmapintegration_tpu.cli import reconstruct
    from cudadepthmapintegration_tpu.io import read_vtp

    with run.phase("reconstruct"):
        dims, nv = SIZE["dims"], SIZE["views"]
        w, h = SIZE["image"]
        data = os.path.join(work, "mvs")
        t0 = time.perf_counter()
        views = orbit_views(nv, w, h, seed=0)
        state["vti"], state["krtd"] = write_dataset(data, views)
        del views
        print(f"  dataset written in {time.perf_counter() - t0:.3f} s",
              flush=True)
        grid = sphere_grid(dims)
        params = ray_params(grid)
        end = [o + 3.2 for o in grid.origin]
        state["mesh"] = os.path.join(work, "mesh.vtp")
        metrics = os.path.join(work, "metrics.json")
        argv = [
            "--gridDims", str(dims),
            "--gridOrigin", *map(str, grid.origin),
            "--gridEnd", *map(str, end),
            "--rayThick", str(params.thick), "--rayRho", "0.8",
            "--rayEta", "0.03", "--rayDelta", str(params.delta),
            "--threshBestCost", "0.5", "--contour", "1.0",
            "--dataFolder", data,
            "--outputMeshFilename", state["mesh"],
            "--outputGridFilename", os.path.join(work, "grid.vts"),
            "--mhaPath", os.path.join(work, "volume.mha"),
            "--metrics", metrics, "--verbose",
        ]
        t0 = time.perf_counter()
        rc = reconstruct.main(argv)
        print(f"  cli.reconstruct rc {rc} in {time.perf_counter() - t0:.3f} s",
              flush=True)
        with open(metrics) as f:
            print(f"  metrics {f.read().strip()}", flush=True)
        mesh = read_vtp(state["mesh"])
        r = np.linalg.norm(mesh.points, axis=1)
        med = float(np.median(r)) if len(r) else float("nan")
        run.gate("reconstruct_rc", rc == 0, f"rc {rc}")
        run.gate("mesh_radius", abs(med - 1.0) <= RADIUS_TOL,
                 f"{mesh.num_triangles} triangles, median radius {med:.5f} "
                 f"within {RADIUS_TOL} of 1")


def phase_colorize(run: Run, work: str, state: dict) -> None:
    from cudadepthmapintegration_tpu.cli import colorize
    from cudadepthmapintegration_tpu.io import DepthMapDataset, read_vtp
    from cudadepthmapintegration_tpu.ops.coloration import colorize_points

    with run.phase("colorize"):
        out = os.path.join(work, "colored.vtp")
        argv = ["--input", state["mesh"], "--output", out,
                "--vti", state["vti"], "--krtd", state["krtd"], "--verbose"]
        t0 = time.perf_counter()
        rc = colorize.main(argv)
        print(f"  cli.colorize rc {rc} in {time.perf_counter() - t0:.3f} s",
              flush=True)
        run.gate("colorize_rc", rc == 0, f"rc {rc}")
        mesh = read_vtp(out)
        pd = mesh.point_data
        names = ("MeanColoration", "MedianColoration", "NbProjectedDepthMap")
        present = all(n in pd for n in names)
        hit = float((pd["NbProjectedDepthMap"] > 0).mean()) if present else 0.0
        run.gate("coloration_arrays", present and hit >= HIT_FRACTION,
                 f"arrays present {present}, count > 0 on {hit:.4f} of "
                 f"{mesh.num_points} vertices (>= {HIT_FRACTION})")
        nrm = np.linalg.norm(pd["Normals"], axis=1) if "Normals" in pd else []
        unit = len(nrm) > 0 and bool(np.allclose(nrm, 1.0, atol=NORMAL_TOL))
        run.gate("unit_normals", unit, f"|Normals| within {NORMAL_TOL} of 1")

        # The XLA gather's end-to-end rate on views already in memory.
        views = list(DepthMapDataset(state["vti"], state["krtd"]))
        colorize_points(mesh.points, views)  # compiles
        t0 = time.perf_counter()
        colorize_points(mesh.points, views)
        dt = time.perf_counter() - t0
        n = mesh.num_points * len(views)
        print(f"  colorize_points {mesh.num_points} vertices x {len(views)} "
              f"views: {dt:.4f} s, {n / dt:.4e} samples/s", flush=True)


def phase_rgbd(run: Run, work: str) -> None:
    from cudadepthmapintegration_tpu.cli import fuse_rgbd
    from cudadepthmapintegration_tpu.io import read_vtp

    with run.phase("rgbd"):
        w, h = SIZE["rgbd_image"]
        n = SIZE["rgbd_frames"]
        # A handheld-like orbit 2.5 m around a 1 m sphere, focal as TUM fr1.
        views = orbit_views(n, w, h, seed=1, cam_radius=2.5, focal=525.0,
                            cam_height=0.5)
        vti, krtd = write_dataset(os.path.join(work, "rgbd"), views)
        out = os.path.join(work, "rgbd.vtp")
        t0 = time.perf_counter()
        rc = fuse_rgbd.main(["--vti", vti, "--krtd", krtd, "--voxelSize",
                             str(SIZE["rgbd_voxel"]), "--colorize",
                             "--output", out])
        dt = time.perf_counter() - t0
        print(f"  cli.fuse_rgbd rc {rc}, {n} frames in {dt:.3f} s", flush=True)
        mesh = read_vtp(out) if rc == 0 else None
        tris = mesh.num_triangles if mesh is not None else 0
        colored = mesh is not None and "MeanColoration" in mesh.point_data
        run.gate("rgbd_mesh", rc == 0 and tris > 0 and colored,
                 f"rc {rc}, {tris} triangles, colours {colored}")


def phase_memory(run: Run) -> None:
    from cudadepthmapintegration_tpu.utils.profiling import device_memory_stats

    stats = device_memory_stats()
    peak = stats.get("peak_bytes_in_use")
    run.gate("peak_device_memory", peak is not None and peak > 0,
             f"peak {peak} of {stats.get('bytes_limit')} bytes")


def run_one_card(devices) -> Run:
    run = Run()
    phase_device(run, devices)
    phase_oracle(run)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as work:
        state: dict = {}
        phase_reconstruct(run, work, state)
        if "mesh" in state:
            phase_colorize(run, work, state)
        phase_rgbd(run, work)
    phase_memory(run)
    return run


def sharded_fuse(grid, views, params, mesh, stream_batch=32):
    """Z-slab sharded fusion over `mesh`; returns the sharded volume."""
    from cudadepthmapintegration_tpu.parallel import ShardedTSDFIntegrator

    sh = ShardedTSDFIntegrator(grid, params, mesh).reset()
    for s in range(0, len(views), stream_batch):
        sh.integrate(views[s:s + stream_batch])
    return sh.volume


def run_four_cards(devices) -> Run:
    """Z-slab sharded fusion, halo cell->point and sharded colouring on four
    cards, each against the same work on one card."""
    import jax

    from cudadepthmapintegration_tpu.ops import cell_to_point, colorize_points
    from cudadepthmapintegration_tpu.ops.marching_cubes import (
        extract_isosurface,
    )
    from cudadepthmapintegration_tpu.parallel import (
        make_mesh,
        sharded_cell_to_point,
        sharded_colorize_points,
    )
    from cudadepthmapintegration_tpu.testing.parity import (
        FLIP_BUDGET,
        flip_fraction,
    )

    run = Run()
    phase_device(run, devices)
    if len(devices) < 4:
        run.gate("four_cards", False, f"{len(devices)} devices")
        return run
    with run.phase("four_cards"):
        dims, nv = SIZE["dims"], SIZE["views"]
        w, h = SIZE["image"]
        views = orbit_views(nv, w, h, seed=0)
        grid = sphere_grid(dims)
        params = ray_params(grid)
        mesh = make_mesh(n_z=4, devices=devices[:4])

        t0 = time.perf_counter()
        one = fuse_integrator(grid, views, params)
        one.volume.block_until_ready()
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        vol4 = sharded_fuse(grid, views, params, mesh)
        vol4.block_until_ready()
        t_four = time.perf_counter() - t0
        print(f"  fusion: one card {t_one:.3f} s, four cards {t_four:.3f} s "
              "(first calls, compile included)", flush=True)
        for label, fuse in (
            ("one card", lambda: fuse_integrator(grid, views, params).volume),
            ("four cards", lambda: sharded_fuse(grid, views, params, mesh)),
        ):
            t0 = time.perf_counter()
            fuse().block_until_ready()
            dt = time.perf_counter() - t0
            print(f"  fusion {label}, warm: {dt:.4f} s, "
                  f"{nv / dt:.1f} views/s", flush=True)
        # Tolerance: the one-card kernel and the sharded XLA scan both add
        # one view at a time, so only half-pixel lines and the ray
        # potential's jump at delta can differ (FLIP_BUDGET of voxels).
        vol1 = one.result()
        f = flip_fraction(np.asarray(jax.device_get(vol4)), vol1)
        run.gate("sharded_fusion", f <= FLIP_BUDGET,
                 f"flip fraction {f:.3e} vs one card")

        p1 = np.asarray(cell_to_point(one.volume))
        p4 = np.asarray(jax.device_get(sharded_cell_to_point(vol4, mesh)))
        f = flip_fraction(p4, p1)
        run.gate("sharded_cell_to_point", f <= FLIP_BUDGET,
                 f"flip fraction {f:.3e} vs one card (ppermute halo)")

        verts = extract_isosurface(grid, vol1, 1.0,
                                   compute_normals=False).points
        c1 = colorize_points(verts, views)
        c4 = sharded_colorize_points(verts, views, mesh)
        same = all(np.array_equal(a, b) for a, b in zip(c1, c4))
        run.gate("sharded_colorize", same,
                 f"{len(verts)} vertices x {nv} views: mean/median/count "
                 "equal to one card (same gather, exact integer sums)")
    phase_memory(run)
    return run


def require_gpu():
    """JAX's devices, or None when the first is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != PLATFORM:
        print(f"no GPU: JAX platform is {devices[0].platform!r}", flush=True)
        return None
    return devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the z-slab sharded path on four GPUs")
    args = ap.parse_args(argv)

    devices = require_gpu()
    if devices is None:
        print(final_line(False), flush=True)
        return 1
    try:
        from cudadepthmapintegration_tpu.cli._cache import (
            enable_compile_cache,
        )
    except ImportError as e:
        print(f"package not importable: {e}", flush=True)
        print(final_line(False), flush=True)
        return 1
    enable_compile_cache()

    t0 = time.perf_counter()
    run = run_four_cards(devices) if args.four_cards else run_one_card(devices)
    print(f"phase seconds {json.dumps(run.seconds)}", flush=True)
    print(f"total {time.perf_counter() - t0:.3f} s; failed phases "
          f"{run.failed}; gates {sum(run.gates.values())}/{len(run.gates)}",
          flush=True)
    print(card_line(), flush=True)
    print(final_line(run.ok, devices if run.ok else None), flush=True)
    return 0 if run.ok else 1


if __name__ == "__main__":
    sys.exit(main())
