"""Truncated signed-distance ray-potential profile.

Exact semantics of ``rayPotential`` in
``Reconstruction/CudaReconstruction.cu:104-120``, with
``diff = real_distance - depth`` (voxel's camera-space z minus the depth-map
value):

* ``|diff| >  delta``:  ``0`` if diff > 0 (voxel far behind the surface),
  else ``-eta * rho`` (voxel well in front, empty-space vote);
* ``delta >= |diff| > thick``:  ``rho * sign(diff)``;
* ``|diff| <= thick``:  ``(rho / thick) * diff`` (linear ramp through 0).

Validation rules come from the CLI (``Reconstruction/main.cxx:270-276``):
``delta >= thick`` and ``0 <= eta <= 1``. Defaults from
``Reconstruction/main.cxx:75-80`` (note: the *defaults* thick=2, delta=0.3
violate delta>=thick, so the reference forces users to set them; we validate
at construction of an explicit config, matching the CLI behavior).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

__all__ = ["RayPotential", "ray_potential_np", "ray_potential_jnp"]


@dataclasses.dataclass(frozen=True)
class RayPotential:
    """TSDF ray-potential parameters (thick, rho, eta, delta)."""

    thick: float = 2.0
    rho: float = 0.8
    eta: float = 0.03
    delta: float = 0.3

    def validate(self) -> "RayPotential":
        """CLI-equivalent validation (``Reconstruction/main.cxx:270-276``)."""
        if self.delta < self.thick:
            raise ValueError(
                f"rayDelta ({self.delta}) must be >= rayThick ({self.thick})"
            )
        if not (0.0 <= self.eta <= 1.0):
            raise ValueError(f"rayEta ({self.eta}) must be within [0, 1]")
        if self.thick <= 0:
            raise ValueError(f"rayThick ({self.thick}) must be > 0")
        return self

    def astuple(self) -> tuple[float, float, float, float]:
        return (self.thick, self.rho, self.eta, self.delta)


def ray_potential_np(
    real_distance: np.ndarray, depth: np.ndarray, p: RayPotential
) -> np.ndarray:
    """float64 NumPy oracle of ``rayPotential`` (CudaReconstruction.cu:104-120)."""
    diff = np.asarray(real_distance, dtype=np.float64) - np.asarray(
        depth, dtype=np.float64
    )
    a = np.abs(diff)
    sign = np.sign(diff)
    far = np.where(diff > 0, 0.0, -p.eta * p.rho)
    shell = p.rho * sign
    ramp = (p.rho / p.thick) * diff
    return np.where(a > p.delta, far, np.where(a > p.thick, shell, ramp))


def ray_potential_jnp(real_distance, depth, thick, rho, eta, delta):
    """jnp version (traced; parameters may be python floats or scalars).

    Branch-free ``where`` chain: the same piecewise regions as the CUDA
    device function, without per-thread control flow. The XLA path and the
    GPU kernel both evaluate it.
    """
    diff = real_distance - depth
    a = jnp.abs(diff)
    sign = jnp.sign(diff)
    far = jnp.where(diff > 0, jnp.zeros_like(diff), -eta * rho)
    shell = rho * sign
    ramp = (rho / thick) * diff
    return jnp.where(a > delta, far, jnp.where(a > thick, shell, ramp))
