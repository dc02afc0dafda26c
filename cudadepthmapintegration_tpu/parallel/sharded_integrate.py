"""Multi-device TSDF fusion over a named mesh.

Two complementary strategies (composable on a (z, v) mesh):

* **Spatial (z-slab) sharding** — the volume and the z-dependent projection
  table are sharded along ``z``; every device integrates all views against
  its own slab. Because a voxel's update depends only on that voxel, fusion
  is embarrassingly parallel in space: XLA partitions the computation with
  ZERO communication. This inverts the reference's view-outer loop
  (``CudaReconstruction.cu:343-365``) exactly as planned in SURVEY.md 7.4 —
  a 1024^3 grid never needs a 4 GiB all-reduce.
* **View sharding** — views are sharded along ``v``; each device fuses its
  view subset into a full volume replica and partial volumes are summed with
  one ``psum`` (fusion is an associative sum over views,
  ``CudaReconstruction.cu:211``). Used when the grid is small and views are
  many.

Both paths reuse the single-device XLA integrator body.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential
from ..core.view import DepthMapView
from ..ops.integrate import projection_tables, _view_contribution

__all__ = ["ShardedTSDFIntegrator"]


@partial(
    jax.jit,
    static_argnames=("h", "w", "thick", "rho", "eta", "delta"),
    donate_argnames=("volume",),
)
def _integrate_all_views(volume, tx, ty, tz, tc, depths, h, w,
                         thick, rho, eta, delta):
    """Sum every view's contribution into the volume in one fused pass.

    Under GSPMD, sharding `volume`/`tz` along z partitions this computation
    spatially; sharding the view axis of the tables/depths (with a psum on
    the result) partitions it across views. The body is identical either
    way — the mesh placement decides.
    """

    def body(vol, args):
        vtx, vty, vtz, vtc, vdepth = args
        return vol + _view_contribution(
            vtx, vty, vtz, vtc, vdepth, h, w, thick, rho, eta, delta
        ), None

    volume, _ = jax.lax.scan(
        body, volume,
        (tx, ty, tz, tc, depths.reshape(depths.shape[0], -1)),
    )
    return volume


class ShardedTSDFIntegrator:
    """Fusion over a (z, v) mesh.

    The volume lives sharded on the mesh between calls; only :meth:`result`
    gathers it to the host.
    """

    def __init__(
        self,
        grid: VoxelGrid,
        params: RayPotential,
        mesh: Mesh,
        dtype=jnp.float32,
        slab_interleave: bool = False,
    ):
        """``slab_interleave=True`` assigns z slices to shards round-robin
        (shard d owns original slices d, d+nz, d+2*nz, ...) instead of one
        contiguous slab each. Implemented as an EXACT z-permutation: the
        volume lives permuted on device, tz tables are permuted at staging,
        and :meth:`result` unpermutes — bit-identical to contiguous slabs
        (each z slice is fused independently)."""
        self.grid = grid
        self.params = params.validate()
        self.mesh = mesh
        self.dtype = np.dtype(dtype)
        nz = mesh.shape["z"]
        cz = grid.volume_shape[0]
        if cz % nz:
            raise ValueError(
                f"grid z cells ({cz}) must divide over the z mesh axis ({nz});"
                " pad the grid dims"
            )
        self.slab_interleave = bool(slab_interleave)
        # Round-robin layout: new slice d*m + j holds original slice
        # j*nz + d, so shard d's contiguous block is original slices d::nz.
        m = cz // nz
        order = np.arange(cz).reshape(m, nz).T.reshape(-1)  # new <- old
        self._z_order = order if self.slab_interleave else None
        self._z_inv = np.argsort(order) if self.slab_interleave else None
        self.vol_sharding = NamedSharding(mesh, P("z", None, None))
        self.volume = None
        self.views_fused = 0
        # Per-shard volume read+write sweeps (for --metrics roofline):
        # the scan RMWs the slab once per view.
        self.volume_sweeps = 0
        self._zeros = None  # cached jitted sharded-zeros initializer

    def reset(self, initial: np.ndarray | None = None):
        if initial is None:
            # Fill on device (sharded): a host np.zeros would ship the whole
            # volume through the host link on every reset.
            if self._zeros is None:
                shape, dtype = self.grid.volume_shape, self.dtype
                self._zeros = jax.jit(
                    lambda: jnp.zeros(shape, dtype),
                    out_shardings=self.vol_sharding,
                )
            self.volume = self._zeros()
        else:
            init = np.asarray(initial, self.dtype)
            if self._z_order is not None:
                init = init[self._z_order]
            self.volume = jax.device_put(init, self.vol_sharding)
        self.views_fused = 0
        self.volume_sweeps = 0
        return self

    def _permute_tz(self, tz: np.ndarray) -> np.ndarray:
        """Apply the slab-interleave z-permutation to a (V, 4, cz) table
        (identity when contiguous slabs are in use)."""
        return tz if self._z_order is None else tz[:, :, self._z_order]

    def integrate(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ):
        """Fuse a batch of views, spatially sharded (no communication)."""
        if self.volume is None:
            self.reset()
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        h, w = views[0].depth.shape
        t = projection_tables(self.grid, views, self.dtype)
        depths = np.stack([v.depth for v in views]).astype(self.dtype)
        mesh = self.mesh
        # tz is (V, 4, cz): shard its z extent like the volume; everything
        # else is replicated (each device sees all views).
        tz_sh = jax.device_put(
            self._permute_tz(t.tz), NamedSharding(mesh, P(None, None, "z"))
        )
        repl = NamedSharding(mesh, P())
        self.volume = _integrate_all_views(
            self.volume,
            jax.device_put(t.tx, repl),
            jax.device_put(t.ty, repl),
            tz_sh,
            jax.device_put(t.tc, repl),
            jax.device_put(depths, repl),
            h=int(h), w=int(w),
            thick=float(self.params.thick), rho=float(self.params.rho),
            eta=float(self.params.eta), delta=float(self.params.delta),
        )
        self.views_fused += len(views)
        self.volume_sweeps += len(views)
        return self

    def integrate_view_parallel(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ):
        """Fuse with views sharded over the ``v`` mesh axis.

        Each v-shard integrates its local views into a partial z-slab and the
        partials are reduced with ONE ``psum`` — valid because
        fusion is an associative/commutative sum over views
        (``CudaReconstruction.cu:211``). Composes with z sharding: the grid
        stays z-sharded, so the psum payload is a slab, not the full grid.
        Requires len(views) divisible by the v-axis size (pad with dummy
        views whose depth is the -1 sentinel if needed).
        """
        if self.volume is None:
            self.reset()
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        nv = self.mesh.shape["v"]
        if len(views) % nv:
            raise ValueError(f"need a multiple of {nv} views, got {len(views)}")
        h, w = views[0].depth.shape
        t = projection_tables(self.grid, views, self.dtype)
        depths = np.stack([v.depth for v in views]).astype(self.dtype)
        mesh = self.mesh
        kw = dict(
            h=int(h), w=int(w),
            thick=float(self.params.thick), rho=float(self.params.rho),
            eta=float(self.params.eta), delta=float(self.params.delta),
        )

        def body(volume, tx, ty, tz, tc, depths):
            # The zero init must be marked varying over 'v' (each v-shard
            # accumulates different views) for shard_map's vma typing.
            init = jax.lax.pcast(jnp.zeros_like(volume), ("v",), to="varying")
            local = _integrate_all_views(init, tx, ty, tz, tc, depths, **kw)
            return volume + jax.lax.psum(local, "v")

        step = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(
                    P("z", None, None),
                    P("v", None, None),
                    P("v", None, None),
                    P("v", None, "z"),
                    P("v", None),
                    P("v", None, None),
                ),
                out_specs=P("z", None, None),
            )
        )
        view_sh = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
        self.volume = step(
            self.volume,
            view_sh(t.tx, P("v", None, None)),
            view_sh(t.ty, P("v", None, None)),
            view_sh(self._permute_tz(t.tz), P("v", None, "z")),
            view_sh(t.tc, P("v", None)),
            view_sh(depths, P("v", None, None)),
        )
        self.views_fused += len(views)
        self.volume_sweeps += len(views) // nv
        return self

    def result(self) -> np.ndarray:
        if self.volume is None:
            self.reset()
        vol = np.asarray(jax.device_get(self.volume))
        if self._z_inv is not None:
            vol = vol[self._z_inv]
        return vol
