"""Subprocess worker for the 2-process multi-host smoke test.

Driven by tests/test_multihost_smoke.py. Env protocol:
  MH_ROLE        "crash" (phase A: host 1 dies after its first unit) or
                 "resume" (phase B: jax.distributed 2-process resume + sum)
  MH_PROC        process id (0 or 1)
  MH_COORD       coordinator address (phase B only)
  MH_DIR         scratch dir for checkpoints / results
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")  # before any device use

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudadepthmapintegration_tpu.cli._cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.0)

from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid  # noqa: E402
from cudadepthmapintegration_tpu.ops import TSDFIntegrator  # noqa: E402
from cudadepthmapintegration_tpu.pipeline.runner import (  # noqa: E402
    FaultTolerantRunner,
)
from cudadepthmapintegration_tpu.testing import sphere_scene  # noqa: E402

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)


def build():
    grid = VoxelGrid(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)
    views = sphere_scene(n_views=8, width=64, height=48)
    return grid, views


def integrate_fn_for(grid, crash_after=None, counter=None):
    def integrate_fn(volume, batch):
        if crash_after is not None:
            counter["n"] += 1
            if counter["n"] > crash_after:
                os._exit(17)  # simulated host preemption (no cleanup)
        integ = TSDFIntegrator(grid, PARAMS, dtype=np.float64).reset(volume)
        integ.integrate(batch)
        return integ.result()

    return integrate_fn


def main():
    role = os.environ["MH_ROLE"]
    proc = int(os.environ["MH_PROC"])
    out_dir = os.environ["MH_DIR"]
    grid, views = build()
    ckpt = os.path.join(out_dir, "run.ckpt")

    if role == "crash":
        counter = {"n": 0}
        crash_after = 1 if proc == 1 else None
        runner = FaultTolerantRunner(
            grid, PARAMS, integrate_fn_for(grid, crash_after, counter),
            unit_size=2, checkpoint_path=ckpt,
            host_id=proc, num_hosts=2,
        )
        runner.run(views)
        return 0

    # role == "resume": join the 2-process runtime, finish remaining units,
    # then reduce the partial volumes across processes.
    jax.distributed.initialize(
        coordinator_address=os.environ["MH_COORD"],
        num_processes=2,
        process_id=proc,
    )
    from cudadepthmapintegration_tpu.parallel import distributed

    assert distributed.is_multihost()
    runner = FaultTolerantRunner(
        grid, PARAMS, integrate_fn_for(grid),
        unit_size=2, checkpoint_path=ckpt,
        host_id=proc, num_hosts=2,
    )
    partial = runner.run(views, resume=True)
    np.save(os.path.join(out_dir, f"resumed_units.{proc}.npy"),
            np.asarray(sorted(runner.completed_units)))
    total = distributed.all_sum_volume(partial)
    if proc == 0:
        np.save(os.path.join(out_dir, "total.npy"), total)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
