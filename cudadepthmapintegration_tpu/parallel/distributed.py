"""Multi-process runtime initialization and topology helpers.

With several hosts every process runs the same program; ``jax.distributed``
wires them into one JAX runtime whose global device list spans all of
them. The fusion framework then needs nothing else: the (z, v) mesh from
:func:`parallel.mesh.make_mesh` spans all global devices, and view
streaming is per-host disk -> its own devices (the network never carries
the grid — SURVEY.md section 5 "Distributed communication backend").

Typical multi-process entrypoint:

    from cudadepthmapintegration_tpu.parallel import distributed, make_mesh

    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()                  # all global devices on z
    views = my_shard_of_views()         # each host reads its own files
    ...ShardedTSDFIntegrator(grid, params, mesh).integrate(views)...

Process-level failures compose with pipeline.runner.FaultTolerantRunner:
a restarted host re-joins with the same process id and re-fuses only its
unfinished units (idempotent sum).
"""

from __future__ import annotations

import jax

__all__ = [
    "initialize",
    "is_multihost",
    "host_view_slice",
    "all_sum_volume",
    "topology_summary",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed for a multi-process launch.

    Nothing on a GPU host tells JAX of a cluster, so the launcher passes
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``. Without a coordinator address this is a no-op, so it
    is safe to call on a single host.
    """
    if jax.process_count() > 1:
        return  # already initialized
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_view_slice(n_views: int) -> range:
    """This host's contiguous share of a global view list (for per-host
    disk reads; fusion order does not matter)."""
    p = jax.process_index()
    n = jax.process_count()
    start = (n_views * p) // n
    stop = (n_views * (p + 1)) // n
    return range(start, stop)


def all_sum_volume(volume):
    """Sum per-host partial volumes across all processes (replica mode).

    This is the final cross-host reduction of the
    ``FaultTolerantRunner`` replica model: every host fuses only its
    striped units into a full-size volume replica, and the true fusion is
    the elementwise sum of all replicas (order-independent addition,
    ``CudaReconstruction.cu:211``). Single-process: identity.

    Uses ``process_allgather`` — transfer is P x volume once per
    run, negligible next to fusion; the z-SHARDED mode
    (parallel/sharded_integrate.py) needs no volume reduction at all and
    is the preferred layout at scale.
    """
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(volume)
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    stacked = multihost_utils.process_allgather(
        jnp.asarray(volume, jnp.float32)
    )  # (num_processes, cz, cy, cx)
    return np.asarray(stacked).sum(axis=0)


def topology_summary() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform if jax.devices() else None,
    }
