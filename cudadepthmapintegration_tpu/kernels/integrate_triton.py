"""Voxel-parallel TSDF integrate kernel for NVIDIA GPUs (Pallas, Triton route).

The shape of the reference's ``depthMapKernel``
(``Reconstruction/CudaReconstruction.cu:158-212``) with its loop nest
inverted: each program owns a (by, bx) tile of one z slice, loops over
every view of the call inside the program with the running sum in
registers, and reads and writes its voxels once per call. The reference
reads and writes the whole grid once per view.

Per view the tile's homogeneous coordinates come from the separable tables
of :func:`ops.integrate.projection_tables`, added in the same order as the
XLA path (``tz + ty + tx + tc``). The depth lookup is a masked index-array
load from the flattened depth maps. Division is IEEE round-to-nearest
(``div.rn.f32``), as XLA emits it, so the two paths project voxels to the
same pixels.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.camera import round_half_away_jnp
from ..core.ray_potential import ray_potential_jnp

__all__ = ["MAX_OFFSET", "fits_int32_offsets", "integrate_triton"]

# Tile of one z slice owned by a program: 16 rows of 64 voxels, 4 warps.
# Fastest of seven tiles timed on an H100 at 512^3 x 32 views of 512^2.
TILE_Y, TILE_X, NUM_WARPS = 16, 64, 4
# The kernel indexes the flat volume and depth maps with int32 offsets.
MAX_OFFSET = 2**31


def fits_int32_offsets(volume_size, n_views, h, w) -> bool:
    """Whether every voxel and depth-sample offset of a call fits in int32."""
    return volume_size < MAX_OFFSET and n_views * h * w < MAX_OFFSET


def _div_rn(a, b, interpret):
    if interpret:
        return a / b
    (q,) = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )
    return q


def _kernel(tx_ref, ty_ref, tz_ref, tc_ref, depth_ref, vol_ref, out_ref, *,
            n_views, h, w, cz, cy, cx, by, bx, thick, rho, eta, delta,
            interpret):
    k = pl.program_id(0)
    j = pl.program_id(1) * by + jnp.arange(by, dtype=jnp.int32)
    i = pl.program_id(2) * bx + jnp.arange(bx, dtype=jnp.int32)
    in_grid = (j < cy)[:, None] & (i < cx)[None, :]
    voxel = (k * cy + j[:, None]) * cx + i[None, :]
    acc = plgpu.load(vol_ref.at[voxel], mask=in_grid, other=0.0)
    jj = jnp.minimum(j, cy - 1)
    ii = jnp.minimum(i, cx - 1)

    def view(v, acc):
        def lattice(r):
            row = v * 4 + r
            return (
                (tz_ref[row * cz + k] + ty_ref[row * cy + jj][:, None])
                + tx_ref[row * cx + ii][None, :]
            ) + tc_ref[row]

        hom0, hom1, hom2, cam_z = lattice(0), lattice(1), lattice(2), lattice(3)
        u = round_half_away_jnp(_div_rn(hom0, hom2, interpret))
        vv = round_half_away_jnp(_div_rn(hom1, hom2, interpret))
        valid = (hom2 >= 0) & (u >= 0) & (vv >= 0) & (u < w) & (vv < h)
        pix = (jnp.where(valid, vv, 0.0).astype(jnp.int32) * w
               + jnp.where(valid, u, 0.0).astype(jnp.int32))
        d = plgpu.load(depth_ref.at[v * (h * w) + pix], mask=valid & in_grid,
                       other=-1.0)
        valid &= d != -1.0
        value = ray_potential_jnp(cam_z, d, thick, rho, eta, delta)
        return acc + jnp.where(valid, value, 0.0)

    acc = jax.lax.fori_loop(0, n_views, view, acc)
    plgpu.store(out_ref.at[voxel], acc, mask=in_grid)


@partial(
    jax.jit,
    static_argnames=("h", "w", "thick", "rho", "eta", "delta", "interpret"),
    donate_argnames=("volume",),
)
def integrate_triton(volume, tx, ty, tz, tc, depths, h, w, thick, rho, eta,
                     delta, interpret=False):
    """Fuse every view of (tx, ty, tz, tc, depths) into float32 `volume`.

    Shapes as :func:`ops.integrate._integrate_batched`: volume (cz, cy, cx),
    tx (V, 4, cx), ty (V, 4, cy), tz (V, 4, cz), tc (V, 4), depths (V, h, w).
    ``interpret=True`` runs the Pallas interpreter (CPU tests only);
    without it the call raises on any platform but a GPU.
    """
    cz, cy, cx = volume.shape
    n_views = tx.shape[0]
    if not fits_int32_offsets(volume.size, n_views, h, w):
        raise ValueError("integrate_triton indexes with int32 offsets")
    by, bx = TILE_Y, TILE_X
    kernel = partial(
        _kernel, n_views=n_views, h=h, w=w, cz=cz, cy=cy, cx=cx, by=by, bx=bx,
        thick=thick, rho=rho, eta=eta, delta=delta, interpret=interpret,
    )
    flat = [a.reshape(-1) for a in (tx, ty, tz, tc, depths, volume)]
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((volume.size,), jnp.float32),
        grid=(cz, pl.cdiv(cy, by), pl.cdiv(cx, bx)),
        input_output_aliases={5: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="tsdf_integrate",
    )(*flat)
    return out.reshape(volume.shape)
