"""TSDF integration (the dense fusion hot loop).

Re-designs the per-voxel CUDA kernel (``Reconstruction/CudaReconstruction.cu:
158-212``):

* **Separable projection.** A voxel center is ``origin + (idx+0.5)*spacing``,
  so for the composed projection ``P = K4 @ RT @ grid_matrix`` the homogeneous
  coordinate of cell (k, j, i) is a sum of three per-axis 1-D tables plus a
  constant: ``hom_r[k,j,i] = tz[r,k] + ty[r,j] + tx[r,i] + tc[r]``. The
  reference performs three mat4 products *per voxel per thread*
  (``.cu:166-176``); here the per-axis tables are computed once per view on
  the host **in float64** (one rounding into the compute dtype), and the hot
  loop is broadcast adds.
* **View batching.** The reference re-reads and re-writes the whole grid once
  per depth map (``.cu:211,363``). Summing a static batch of per-view
  contributions before touching the grid amortizes the volume read-modify-
  write by the batch size.
* **Branch-free masking.** CUDA early-returns (``.cu:177-205``) become
  ``where`` masks so XLA emits one fused elementwise kernel around the
  depth-map gather.

All math after the tables runs in the compute dtype (default float32).
Tests validate against the float64 oracle in ``ops/oracle.py``; on CPU with
x64 enabled the two agree exactly.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.camera import compose_projection, round_half_away_jnp
from ..core.grid import VoxelGrid
from ..core.ray_potential import RayPotential, ray_potential_jnp
from ..core.view import DepthMapView
from ..kernels.integrate_triton import fits_int32_offsets, integrate_triton

__all__ = ["ProjectionTables", "projection_tables", "TSDFIntegrator"]


@dataclasses.dataclass
class ProjectionTables:
    """Per-view separable projection tables.

    Rows 0..2 are the composed projection ``P = K4 @ RT @ grid_matrix``;
    row 3 is the camera-z functional (row 2 of ``RT @ grid_matrix``) that
    supplies ``realDepth`` (``CudaReconstruction.cu:207``). (When K has the
    standard [0,0,1] bottom row, row 2 == row 3; we keep both to support
    arbitrary K.)

    Shapes: tx (V, 4, cx), ty (V, 4, cy), tz (V, 4, cz), tc (V, 4).
    """

    tx: np.ndarray
    ty: np.ndarray
    tz: np.ndarray
    tc: np.ndarray


def projection_tables(
    grid: VoxelGrid, views: list[DepthMapView], dtype=np.float32
) -> ProjectionTables:
    """Build per-view separable tables in float64, rounding once to `dtype`."""
    xs, ys, zs = grid.cell_center_axes(np.float64)
    tx, ty, tz, tc = [], [], [], []
    for view in views:
        p_full, cam_row = compose_projection(view.camera, grid)
        rows = np.vstack([p_full[:3, :], cam_row[None, :]])  # (4, 4)
        tx.append(rows[:, 0:1] * xs[None, :])
        ty.append(rows[:, 1:2] * ys[None, :])
        tz.append(rows[:, 2:3] * zs[None, :])
        tc.append(rows[:, 3])
    return ProjectionTables(
        tx=np.stack(tx).astype(dtype),
        ty=np.stack(ty).astype(dtype),
        tz=np.stack(tz).astype(dtype),
        tc=np.stack(tc).astype(dtype),
    )


def _view_contribution(tx, ty, tz, tc, depth_flat, h, w, thick, rho, eta, delta):
    """One view's masked ray-potential contribution over the full volume.

    Args are one view's tables: tx (4, cx), ty (4, cy), tz (4, cz), tc (4,),
    depth_flat (h*w,). Returns (cz, cy, cx).
    """

    def lattice(r):
        return (
            tz[r][:, None, None] + ty[r][None, :, None] + tx[r][None, None, :] + tc[r]
        )

    hom0, hom1, hom2, cam_z = lattice(0), lattice(1), lattice(2), lattice(3)
    u = round_half_away_jnp(hom0 / hom2)
    v = round_half_away_jnp(hom1 / hom2)
    # Bounds tests in float so NaN/overflow can't wrap after the int cast;
    # hom2 >= 0 keeps the `hom.z < 0` rejection of .cu:177-180.
    valid = (
        (hom2 >= 0) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    )
    ui = jnp.where(valid, u, 0).astype(jnp.int32)
    vi = jnp.where(valid, v, 0).astype(jnp.int32)
    depth = jnp.take(depth_flat, vi * w + ui)
    valid &= depth != -1.0
    value = ray_potential_jnp(cam_z, depth, thick, rho, eta, delta)
    return jnp.where(valid, value, jnp.zeros_like(value))


@partial(
    jax.jit,
    static_argnames=("h", "w", "view_batch", "thick", "rho", "eta", "delta"),
    donate_argnames=("volume",),
)
def _integrate_batched(
    volume, tx, ty, tz, tc, depths, h, w, view_batch, thick, rho, eta, delta
):
    """Scan over view-chunks; inside each chunk, an unrolled sum of per-view
    contributions is fused by XLA into a single pass over the volume, so the
    grid RMW costs 2*4 bytes/voxel per *chunk* instead of per view."""
    n_views = tx.shape[0]
    pad = (-n_views) % view_batch
    if pad:
        # Padded views contribute zero: depth == -1 everywhere.
        tx = jnp.concatenate([tx, jnp.zeros((pad,) + tx.shape[1:], tx.dtype)])
        ty = jnp.concatenate([ty, jnp.zeros((pad,) + ty.shape[1:], ty.dtype)])
        tz = jnp.concatenate([tz, jnp.zeros((pad,) + tz.shape[1:], tz.dtype)])
        tc = jnp.concatenate([tc, jnp.zeros((pad,) + tc.shape[1:], tc.dtype)])
        depths = jnp.concatenate(
            [depths, jnp.full((pad,) + depths.shape[1:], -1.0, depths.dtype)]
        )
    n_chunks = tx.shape[0] // view_batch

    def chunk(vol, args):
        ctx, cty, ctz, ctc, cdepths = args
        # vmap (not an unrolled python loop) keeps the HLO one-view-sized; the
        # sum over the batch axis is an input-fused reduction in XLA, so the
        # volume read-modify-write still happens once per chunk.
        contribs = jax.vmap(
            lambda a, b_, c, d, e: _view_contribution(
                a, b_, c, d, e, h, w, thick, rho, eta, delta
            )
        )(ctx, cty, ctz, ctc, cdepths)
        return vol + contribs.sum(axis=0), None

    reshape = lambda a: a.reshape((n_chunks, view_batch) + a.shape[1:])
    volume, _ = jax.lax.scan(
        chunk, volume, (reshape(tx), reshape(ty), reshape(tz), reshape(tc),
                        reshape(depths.reshape(depths.shape[0], -1))),
    )
    return volume


class TSDFIntegrator:
    """Stateful fusion driver: owns the device-resident volume and streams
    depth-map batches through it (equivalent of ``ProcessDepthMap``,
    ``CudaReconstruction.cu:302-386``, minus the per-view host round trips).

    A float32 volume on a GPU is fused by the voxel-parallel kernel
    (``kernels/integrate_triton.py``): one volume read+write per
    ``integrate`` call. Every other dtype and platform, and any call whose
    offsets overflow the kernel's int32 indexing, takes
    :func:`_integrate_batched`: one read+write per ``view_batch`` views.
    ``reset`` sets ``use_kernel`` from the volume's platform and dtype;
    clearing it times the XLA path on a GPU, and setting it on another
    platform raises at the next ``integrate``.
    """

    def __init__(
        self,
        grid: VoxelGrid,
        params: RayPotential,
        dtype=jnp.float32,
        view_batch: int = 8,
        device=None,
    ):
        self.grid = grid
        self.params = params
        self.dtype = dtype
        self.view_batch = int(view_batch)
        self.device = device
        self.volume = None  # lazily initialized device array (cz, cy, cx)
        self.views_fused = 0
        # Volume read+write sweeps performed (for the --metrics roofline):
        # one per kernel call, or one per view_batch chunk on the XLA path.
        self.volume_sweeps = 0

    def reset(self, initial: np.ndarray | None = None):
        vol = (
            np.zeros(self.grid.volume_shape, dtype=self.dtype)
            if initial is None
            else np.asarray(initial, dtype=self.dtype)
        )
        self.volume = jax.device_put(vol, self.device)
        platform = next(iter(self.volume.devices())).platform
        self.use_kernel = platform == "gpu" and vol.dtype == np.float32
        self.views_fused = 0
        self.volume_sweeps = 0
        return self

    def integrate(
        self,
        views: list[DepthMapView],
        threshold_best_cost: float | None = None,
    ):
        """Fuse a batch of views into the held volume."""
        if self.volume is None:
            self.reset()
        if threshold_best_cost is not None:
            views = [v.thresholded(threshold_best_cost) for v in views]
        h, w = views[0].depth.shape
        for view in views:
            if view.depth.shape != (h, w):
                # Reference invariant: all depth maps share view 0's dims
                # (vtkCudaReconstructionFilter.cxx:167-173).
                raise ValueError(
                    f"depth map {view.name!r} has shape {view.depth.shape}, "
                    f"expected {(h, w)}"
                )
        tables = projection_tables(self.grid, views, np.dtype(self.dtype))
        depths = np.stack([v.depth for v in views]).astype(self.dtype)
        args = [
            jnp.asarray(a)
            for a in (tables.tx, tables.ty, tables.tz, tables.tc, depths)
        ]
        kw = dict(
            h=h, w=w,
            thick=float(self.params.thick), rho=float(self.params.rho),
            eta=float(self.params.eta), delta=float(self.params.delta),
        )
        if self.use_kernel and fits_int32_offsets(
            self.volume.size, len(views), h, w
        ):
            self.volume = integrate_triton(self.volume, *args, **kw)
            self.volume_sweeps += 1
        else:
            vb = min(self.view_batch, len(views))
            self.volume = _integrate_batched(
                self.volume, *args, view_batch=vb, **kw
            )
            self.volume_sweeps += -(-len(views) // vb)
        self.views_fused += len(views)
        return self

    def result(self) -> np.ndarray:
        """Fetch the fused (cz, cy, cx) volume to host."""
        if self.volume is None:
            self.reset()
        return np.asarray(jax.device_get(self.volume))
