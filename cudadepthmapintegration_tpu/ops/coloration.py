"""Mesh coloration: per-vertex color statistics over all views.

Re-design of ``MeshColoration::ProcessColoration``
(``Coloration/MeshColoration.cxx:98-199``): the reference's O(V x views)
scalar CPU loop becomes a batched project->gather->masked-reduction over a
(vertex-chunk, view-chunk) lattice.

Memory model (capstone-scale): views are streamed in ``view_chunk`` batches
— only one batch of color images is ever device-resident (the round-1
design replicated ALL images on device, ~6 GB at 1000 realistic views).
Per vertex chunk the gathered SAMPLES (views x chunk x 3 uint8, ~24 MB at
1000 views x 8k vertices) are kept for the exact masked median; mean and
count accumulate incrementally.

Reference semantics preserved exactly:

* Projection via ``TransformWorldToDepthMapPosition``
  (``Sources/ReconstructionData.cxx:169-182``): cam = RT @ p; hom = K @ cam;
  pixel = round(hom.xy / hom.z). **No** hom.z<0 rejection and **no** occlusion
  test — vertices behind a camera can still land in bounds and sample color;
  we mirror that (a `visibility_z_test` opt-in gives the corrected behavior).
* Bounds test against view-0 dimensions (``MeshColoration.cxx:158-163``).
* Color gather with the bottom-left y-flip (``ReconstructionData.cxx:107``) —
  absorbed here by loading images top-down.
* ``MeanColoration``: the reference accumulates into an int
  (``std::accumulate(..., 0)`` — ``MeshColoration.cxx:176-178``), truncating
  per addition; then vtk's SetTuple3 into a uchar array truncates the mean.
  For uchar-valued samples per-addition truncation is lossless (sums stay
  exact in f32 up to 2^24), so the float mean + final floor is bit-equal.
  Since round 5 the numerators are per-view-batch device fp32 sums —
  integer-exact by the same bound — accumulated in fp64 on the host, so
  the int and float accumulates coincide by construction and
  ``compat_int_mean`` is accepted as a no-op (kept for CLI compatibility;
  samples are uchar by format, so no input can split the two).
* ``MedianColoration``: sort + middle; even counts average the two middle
  values (``Sources/Helper.h:174-187``), then truncate to uint8.
* ``NbProjectedDepthMap``: int count of in-bounds projections.
* Zero-hit vertices keep (0,0,0)/0 (``MeshColoration.cxx:113-133,173``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.view import DepthMapView
from ..io.polydata import PolyData

__all__ = ["colorize_mesh", "colorize_points"]


@partial(
    jax.jit, static_argnames=("h", "w", "z_test", "occlusion")
)
def _gather_chunk(
    points, proj, colors_flat, h, w, z_test,
    occlusion=False, depths_flat=None, occlusion_tol=0.0,
):
    """points (N, 3); proj (Vc, 3, 4); colors_flat (Vc, h*w, 3) uint8.

    Returns samples (Vc, N, 3) uint8 and valid (Vc, N) bool for one view
    batch — the project->gather stage of ``MeshColoration.cxx:150-170``.

    ``occlusion=True`` additionally rejects samples whose camera-space z
    lies more than ``occlusion_tol`` behind the view's own depth surface
    at that pixel (``depths_flat`` (Vc, h*w); the reference never does
    this — MeshColoration.cxx:150-170 samples straight through occluders).
    Pixels with the -1 invalid-depth sentinel carry no visibility
    evidence and are rejected, as are vertices behind the camera (z <= 0).
    """
    # hom[v, n, r] = proj[v, r, :3] @ p + proj[v, r, 3], written ELEMENTWISE
    # in fixed left-to-right association ((px*x + py*y) + pz*z) + pw — NOT
    # einsum: a float32 dot may run at reduced precision (TF32 on a GPU)
    # and may associate differently, perturbing u/v by an ulp and flipping
    # round()ed pixel indices. Elementwise fp ops are never reassociated.
    p_ = proj[:, None, :, :]  # (V, 1, 3, 4)
    hom = (
        p_[..., 0] * points[None, :, None, 0]
        + p_[..., 1] * points[None, :, None, 1]
        + p_[..., 2] * points[None, :, None, 2]
        + p_[..., 3]
    )  # (V, N, 3)
    z = hom[..., 2]
    u = hom[..., 0] / z
    v = hom[..., 1] / z
    # std::round: half away from zero (ReconstructionData.cxx:179-181).
    pu = jnp.sign(u) * jnp.floor(jnp.abs(u) + 0.5)
    pv = jnp.sign(v) * jnp.floor(jnp.abs(v) + 0.5)
    valid = (pu >= 0) & (pv >= 0) & (pu < w) & (pv < h)
    if z_test:
        valid &= z > 0
    ui = jnp.where(valid, pu, 0).astype(jnp.int32)
    vi = jnp.where(valid, pv, 0).astype(jnp.int32)
    idx = vi * w + ui  # (Vc, N)
    if occlusion:
        d = jnp.take_along_axis(depths_flat, idx, axis=1)  # (Vc, N)
        # z > 0: a vertex BEHIND the camera has no visibility evidence
        # (its mirror projection may land in-bounds with z < 0, which
        # would trivially satisfy z <= d + tol) — reject it like the -1
        # sentinel, even when z_test itself was not requested.
        valid &= (z > 0) & (d != -1.0) & (z <= d + occlusion_tol)
    rgb = jnp.take_along_axis(
        colors_flat, idx[..., None].astype(jnp.int32), axis=1
    )  # (Vc, N, 3) uint8
    return rgb, valid


@jax.jit
@jax.jit
def _batch_sum_count(samples, valid):
    """Per-view-batch masked sum + count over the view axis (device).
    fp32 sums are exact for uchar-valued samples while batch*255 < 2^24
    (any realistic view_chunk); accumulated in fp64 on the host."""
    s = (samples.astype(jnp.float32) * valid[..., None]).sum(axis=0)
    return s, valid.sum(axis=0).astype(jnp.int32)


def _median_from_samples(samples, valid):
    """Masked median over the view axis: samples (V, N, 3) uint8,
    valid (V, N) bool -> median (N, 3) f32.

    Invalid -> +inf, sort ascending over views, then the two middle *valid*
    entries are at (count-1)//2 and count//2 (Helper.h:174-187)."""
    count = valid.sum(axis=0).astype(jnp.int32)
    big = jnp.where(valid[..., None], samples.astype(jnp.float32), jnp.inf)
    srt = jnp.sort(big, axis=0)  # (V, N, 3)
    lo = jnp.maximum((count - 1) // 2, 0)
    hi = count // 2
    take = lambda i: jnp.take_along_axis(srt, i[None, :, None].repeat(3, 2), axis=0)[0]
    med = 0.5 * (take(lo) + take(hi))
    return jnp.where(count[:, None] > 0, med, 0.0)


def _view_proj(v: DepthMapView) -> np.ndarray:
    return (v.camera.k4 @ v.camera.rt)[:3, :]  # (3, 4)


def _view_colors(v: DepthMapView, h: int, w: int) -> np.ndarray:
    return v.color if v.color is not None else np.zeros((h, w, 3), np.uint8)


def colorize_points(
    points: np.ndarray,
    views,
    chunk: int = 1 << 13,
    view_chunk: int = 64,
    z_test: bool = False,
    dtype=np.float32,
    compat_int_mean: bool = False,
    occlusion_tol: float | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Color statistics for (N, 3) world points against all views.

    ``views`` is any indexable sequence of DepthMapView (e.g. a lazy
    dataset): views are loaded/staged ``view_chunk`` at a time, so device
    (and host, for lazy datasets) memory never holds more than one batch of
    images.

    `dtype` is the projection compute precision: float32 (the default) may
    flip a pixel on exact rounding boundaries vs the float64 reference;
    float64 reproduces the reference bit-for-bit.

    ``occlusion_tol`` (opt-in; the reference samples straight through
    occluders, SURVEY §7.1) rejects samples whose camera z exceeds the
    view's depth at the pixel by more than the tolerance (or whose depth
    is the -1 sentinel).

    Returns (mean_uint8 (N,3), median_uint8 (N,3), count_int32 (N,)).
    """
    n_views = len(views)
    if n_views == 0:
        raise ValueError("no views given for coloration")
    dtype = np.dtype(dtype)
    first = views[0]
    h, w = first.depth.shape

    n = points.shape[0]
    means = np.zeros((n, 3), np.float64)
    meds = np.zeros((n, 3), np.float32)
    counts = np.zeros((n,), np.int64)
    # Bucket the chunk size to powers of two to bound jit recompiles.
    pad_n = min(chunk, max(256, 1 << (max(1, n) - 1).bit_length()))
    # Pad the view axis of the LAST batch to the batch size (dummy views
    # with always-out-of-bounds projection) to keep one jit shape.
    vc = min(view_chunk, n_views)
    # Staged color images of a view batch are reused across point chunks
    # while their total stays under a device-memory budget; above it, each
    # batch is re-staged per chunk (the streaming regime — device memory
    # never holds more than one batch). 1.5 GB covers 500 x 512^2 views.
    staged_budget = 1536 << 20
    staged_bytes = 0
    staged_cache: dict = {}

    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        block = np.zeros((pad_n, 3), dtype)
        block[: stop - start] = points[start:stop]
        block_j = jnp.asarray(block)

        # Device-resident accumulation (round 5): the round-2..4 loop
        # pulled every gathered sample to host and pushed it back for the
        # median — ~1 GB of link traffic per 10^6-vertex mesh at 200
        # views; now only per-chunk STATISTICS cross to the host. Mean
        # numerators are per-view-batch device fp32 sums (exact: uchar
        # samples, vc*255 < 2^24) accumulated in fp64 on the host, so
        # they equal the reference's int accumulate bit for bit
        # (MeshColoration.cxx:176-178); dummy-padded tail views carry
        # valid=False and are inert in every statistic.
        sample_parts: list = []
        valid_parts: list = []
        sum_host = np.zeros((pad_n, 3), np.float64)
        cnt_host = np.zeros((pad_n,), np.int64)
        for vs in range(0, n_views, vc):
            ve = min(vs + vc, n_views)
            cached = staged_cache.get(vs)
            if cached is None:
                batch = [views[i] for i in range(vs, ve)]
                proj = np.stack(
                    [_view_proj(v) for v in batch]
                ).astype(np.float64)
                colors = np.stack([_view_colors(v, h, w) for v in batch])
                pad_v = vc - len(batch)
                if pad_v:
                    # Dummy views: projection row 2 forces u,v out of bounds.
                    dummy = np.zeros((pad_v, 3, 4), np.float64)
                    dummy[:, 2, 3] = 1.0
                    dummy[:, 0, 3] = dummy[:, 1, 3] = -1e9
                    proj = np.concatenate([proj, dummy])
                    colors = np.concatenate(
                        [colors, np.zeros((pad_v, h, w, 3), np.uint8)]
                    )
                depths_j = None
                if occlusion_tol is not None:
                    depths = np.stack(
                        [np.asarray(v.depth, np.float32) for v in batch]
                    )
                    if pad_v:
                        depths = np.concatenate(
                            [depths, np.full((pad_v, h, w), -1.0, np.float32)]
                        )
                    depths_j = jnp.asarray(depths.reshape(vc, h * w))
                cached = (
                    jnp.asarray(proj.astype(dtype)),
                    jnp.asarray(colors.reshape(vc, h * w, 3)),
                    depths_j,
                )
                cached_bytes = cached[1].size + (
                    depths_j.nbytes if depths_j is not None else 0
                )
                if staged_bytes + cached_bytes <= staged_budget:
                    staged_cache[vs] = cached
                    staged_bytes += cached_bytes
            rgb, ok = _gather_chunk(
                block_j, cached[0], cached[1], h=h, w=w, z_test=z_test,
                occlusion=occlusion_tol is not None,
                depths_flat=cached[2],
                occlusion_tol=(
                    0.0 if occlusion_tol is None
                    else jnp.asarray(occlusion_tol, dtype)
                ),
            )
            sample_parts.append(rgb)
            valid_parts.append(ok)
            bs, bc = _batch_sum_count(rgb, ok)
            sum_host += np.asarray(bs, np.float64)
            cnt_host += np.asarray(bc, np.int64)

        med = _median_from_samples(
            jnp.concatenate(sample_parts, axis=0),
            jnp.concatenate(valid_parts, axis=0),
        )
        meds[start:stop] = np.asarray(med)[: stop - start]
        counts[start:stop] = cnt_host[: stop - start]
        # compat_int_mean needs no separate numerator: the device fp32
        # batch sums are already integer-exact (see above), so the int
        # and float accumulates coincide by construction here.
        means[start:stop] = (
            sum_host[: stop - start]
            / np.maximum(cnt_host[: stop - start, None], 1)
        )

    # vtk uchar-array SetTuple truncates doubles (MeshColoration.cxx:180,185).
    mean_u8 = np.clip(means, 0, 255).astype(np.uint8)
    med_u8 = np.clip(meds, 0, 255).astype(np.uint8)
    return mean_u8, med_u8, counts.astype(np.int32)


def colorize_mesh(
    mesh: PolyData,
    views,
    chunk: int = 1 << 13,
    view_chunk: int = 64,
    z_test: bool = False,
    dtype=np.float32,
    compat_int_mean: bool = False,
    occlusion_tol: float | None = None,
) -> PolyData:
    """Attach MeanColoration / MedianColoration / NbProjectedDepthMap arrays
    (names per ``MeshColoration.cxx:113-133``) to a copy of `mesh`."""
    out = PolyData(mesh.points.copy(), mesh.triangles.copy())
    out.point_data = dict(mesh.point_data)
    out.active_scalars = getattr(mesh, "active_scalars", None)
    mean_u8, med_u8, counts = colorize_points(
        mesh.points, views, chunk=chunk, view_chunk=view_chunk,
        z_test=z_test, dtype=dtype, compat_int_mean=compat_int_mean,
        occlusion_tol=occlusion_tol,
    )
    out.point_data["MeanColoration"] = mean_u8
    out.point_data["MedianColoration"] = med_u8
    out.point_data["NbProjectedDepthMap"] = counts.astype(np.int32)
    return out
