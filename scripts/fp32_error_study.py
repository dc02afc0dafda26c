"""fp32 accumulation error growth vs view count (capstone-depth evidence).

The reference computes in float64 throughout (``CudaReconstruction.cu:51``,
``vtkCudaReconstructionFilter.cxx:175``); the float32 integrators
accumulate in float32. This script measures how the fp32 error grows with fused view
count against the fp64 NumPy oracle, at capstone depth (1000 views), and
reports max/median absolute error plus the error relative to the
accumulated magnitude — the measured epsilon behind docs/PARITY.md's
"within-epsilon" claim.

Runs on the CPU (the same fp32 accumulation class as the integrators).

    JAX_PLATFORMS=cpu python scripts/fp32_error_study.py
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops.oracle import integrate_views_oracle
from cudadepthmapintegration_tpu.testing import orbit_cameras, render_sphere_view


def build(n_views, width=256, height=192):
    grid = VoxelGrid(
        dims=(65, 65, 65), origin=(-1.63, -1.61, -1.59), spacing=(0.05,) * 3
    )
    cams = orbit_cameras(
        n_views, 4.0, focal=150.0, width=width, image_height=height,
        height=0.7,
    )
    views = [render_sphere_view(c, width, height) for c in cams]
    params = RayPotential(thick=0.05, rho=0.8, eta=0.03, delta=0.2)
    return grid, views, params


def fp32_oracle(grid, views, params):
    """The oracle algorithm with fp32 arithmetic + fp32 accumulation — the
    precision class of the integrators, with no gather/rounding differences
    (isolates ACCUMULATION error from projection rounding flips)."""
    vol = np.zeros(grid.volume_shape, np.float32)
    for v in views:
        # fp64 projection (host tables are fp64 in the real pipeline), fp32
        # potential value + fp32 accumulate.
        contrib = integrate_views_oracle(grid, [v], params)
        vol += contrib.astype(np.float32)
    return vol


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", type=int, nargs="*",
                    default=[8, 64, 256, 1000])
    args = ap.parse_args()

    n_max = max(args.counts)
    grid, views_all, params = build(n_max)
    print(f"grid 64^3, views up to {n_max} (256x192), "
          f"params {params}", flush=True)
    print(f"{'views':>6} {'max|err|':>12} {'med|err|':>12} "
          f"{'max|err|/|sum|_max':>18}  note", flush=True)

    rows = []
    for n in args.counts:
        views = views_all[:n]
        exp = integrate_views_oracle(grid, views, params)  # fp64
        got = fp32_oracle(grid, views, params)
        err = np.abs(got - exp)
        scale = np.abs(exp).max()
        rows.append((n, err.max(), np.median(err), err.max() / scale))
        print(f"{n:6d} {err.max():12.3e} {np.median(err):12.3e} "
              f"{err.max() / scale:18.3e}  fp32 accumulate", flush=True)

    # Theoretical bound for context: sequential fp32 summation error grows
    # ~ n * eps * max|partial sum|; the measured growth should sit well
    # below rho (one vote) at n=1000.
    n, mx, md, rel = rows[-1]
    budget = 0.01 * params.rho
    verdict = "PASS" if mx < budget else "FAIL"
    print(f"{verdict}: max fp32 accumulation error at {n} views = {mx:.3e} "
          f"(budget {budget:.1e} = 1% of one rho vote)", flush=True)
    return 0 if mx < budget else 1


if __name__ == "__main__":
    raise SystemExit(main())
