"""Benchmark: dense TSDF fusion throughput on one NVIDIA GPU.

Times two shapes — 512^3 cells x 32 orbit views of 512x512, and 257^3
points x 8 views of 1920x1080 — through both integrate implementations:

* ``kernel``: the voxel-parallel kernel TSDFIntegrator takes on a GPU
  (``kernels/integrate_triton.py``);
* ``xla``: ``ops.integrate._integrate_batched`` (view_batch 8), the
  ``vs_baseline`` denominator.

Each is timed end to end through ``TSDFIntegrator.integrate`` +
``result()`` (host tables, host->device copy, fusion, volume download) in
20 pairs that alternate which implementation runs first, and device-only
on staged inputs (every rep ends in ``block_until_ready``). ``value`` is
the end-to-end median rate of the implementation TSDFIntegrator picks at
512^3; ``vs_baseline`` is XLA's end-to-end median over the kernel's. The
``device_only_*`` figures leave out the host. The six parity cases of
``testing/parity.py`` gate both against the float64 oracle.

Prints exactly one JSON line; exits 1 where JAX finds no GPU.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

from chip_smoke import card_line


def workload(dims, n_views, width, height):
    from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
    from cudadepthmapintegration_tpu.testing import (
        orbit_cameras,
        render_sphere_view,
    )

    grid = VoxelGrid(dims=(dims,) * 3, origin=(-1.6,) * 3,
                     spacing=(3.2 / (dims - 1),) * 3)
    cams = orbit_cameras(n_views, 4.0, focal=300.0, width=width,
                         image_height=height)
    views = [render_sphere_view(c, width, height, radius=1.0,
                                background=-1.0) for c in cams]
    return grid, views, RayPotential(thick=0.025, rho=0.8, eta=0.03,
                                     delta=0.1)


def device_times(grid, views, params, reps):
    """Seconds per rep of each implementation on staged inputs."""
    import jax.numpy as jnp

    from cudadepthmapintegration_tpu.kernels.integrate_triton import (
        integrate_triton,
    )
    from cudadepthmapintegration_tpu.ops import integrate as I

    h, w = views[0].depth.shape
    t = I.projection_tables(grid, views, np.float32)
    d = np.stack([v.depth for v in views]).astype(np.float32)
    args = [jnp.asarray(a) for a in (t.tx, t.ty, t.tz, t.tc, d)]
    kw = dict(h=int(h), w=int(w), thick=params.thick, rho=params.rho,
              eta=params.eta, delta=params.delta)
    impls = {
        "kernel": lambda vol: integrate_triton(vol, *args, **kw),
        "xla": lambda vol: I._integrate_batched(vol, *args, view_batch=8,
                                                **kw),
    }
    times = {name: [] for name in impls}
    for rep in range(reps + 1):  # rep 0 compiles
        for name in (("kernel", "xla") if rep % 2 else ("xla", "kernel")):
            vol = jnp.zeros(grid.volume_shape, jnp.float32)
            vol.block_until_ready()
            t0 = time.perf_counter()
            impls[name](vol).block_until_ready()
            if rep:
                times[name].append(time.perf_counter() - t0)
    return times


def e2e_times(grid, views, params, reps):
    """Seconds per TSDFIntegrator.integrate + result() of all views, in
    `reps` pairs that alternate which implementation runs first."""
    import jax

    from cudadepthmapintegration_tpu.ops import TSDFIntegrator

    times = {"kernel": [], "xla": []}
    for rep in range(reps + 1):
        for name in (("kernel", "xla") if rep % 2 else ("xla", "kernel")):
            integ = TSDFIntegrator(grid, params).reset()
            integ.use_kernel = name == "kernel"
            jax.block_until_ready(integ.volume)
            t0 = time.perf_counter()
            integ.integrate(views)
            integ.result()
            if rep:
                times[name].append(time.perf_counter() - t0)
    return times


def parity():
    from cudadepthmapintegration_tpu.ops import (
        TSDFIntegrator,
        integrate_views_oracle,
    )
    from cudadepthmapintegration_tpu.testing.parity import (
        FLIP_BUDGET,
        flip_fraction,
        parity_cases,
    )

    worst = {"kernel": 0.0, "xla": 0.0}
    for _, grid, views, params, thr in parity_cases():
        exp = integrate_views_oracle(grid, views, params,
                                     threshold_best_cost=thr)
        for name in worst:
            integ = TSDFIntegrator(grid, params).reset()
            integ.use_kernel = name == "kernel"
            got = integ.integrate(views, thr).result()
            worst[name] = max(worst[name], flip_fraction(got, exp))
    return all(f <= FLIP_BUDGET for f in worst.values()), worst


def main():
    import jax

    devices = jax.devices()
    result = {
        "metric": "tsdf_voxel_updates_per_sec_512cube_32views",
        "unit": "voxel_updates/s",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    }
    if devices[0].platform != "gpu":
        result["error"] = "no GPU: the benchmark measures only a GPU"
        print(json.dumps(result), flush=True)
        return 1
    from cudadepthmapintegration_tpu.cli._cache import enable_compile_cache
    from cudadepthmapintegration_tpu.ops import TSDFIntegrator
    from cudadepthmapintegration_tpu.utils.profiling import hbm_peak

    enable_compile_cache()
    result["card"] = card_line()
    result["xla_flags"] = os.environ.get("XLA_FLAGS")
    peak = hbm_peak(devices[0].device_kind)
    configs = {}
    for label, dims, nv, w, h in (("512", 513, 32, 512, 512),
                                  ("hd", 257, 8, 1920, 1080)):
        grid, views, params = workload(dims, nv, w, h)
        upd = grid.num_cells * nv
        dev = device_times(grid, views, params, reps=5)
        e2e = e2e_times(grid, views, params, reps=20)
        cfg = {}
        for name in ("kernel", "xla"):
            tmin = min(dev[name])
            # Least volume traffic: one read+write of the float32 volume
            # per call (kernel) or per 8-view chunk (XLA).
            sweeps = 1 if name == "kernel" else -(-nv // 8)
            cfg[name] = {
                "e2e_s": e2e[name],
                "e2e_quartiles_s": np.percentile(e2e[name],
                                                 [25, 50, 75]).tolist(),
                "e2e_gups": upd / float(np.median(e2e[name])) / 1e9,
                "device_only_s": dev[name],
                "device_only_gups": upd / tmin / 1e9,
                "device_only_volume_roofline":
                    sweeps * 8 * grid.num_cells / tmin / peak,
            }
        k, x = np.array(e2e["kernel"]), np.array(e2e["xla"])
        cfg["e2e_kernel_wins"] = f"{int((k < x).sum())}/{len(k)}"
        cfg["e2e_vs_xla"] = float(np.median(x) / np.median(k))
        cfg["device_only_vs_xla"] = min(dev["xla"]) / min(dev["kernel"])
        configs[label] = cfg
    picked = "kernel" if TSDFIntegrator(grid, params).reset().use_kernel \
        else "xla"
    result["value"] = configs["512"][picked]["e2e_gups"] * 1e9
    result["value_is"] = (f"end-to-end median, {picked} path: "
                          "TSDFIntegrator.integrate + result() of 32 views")
    result["vs_baseline"] = configs["512"]["e2e_vs_xla"]
    result["configs"] = configs
    ok, worst = parity()
    result["parity_ok"] = ok
    result["parity_max_flip"] = worst
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
