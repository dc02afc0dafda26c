"""cudadepthmapintegration_tpu — volumetric depth-map fusion in JAX.

A JAX/XLA/Pallas re-design of the capabilities of
``bastienjacquet/CudaDepthMapIntegration`` (Kitware, 2016): truncated
signed-distance ray-potential fusion of calibrated depth maps into a dense
voxel grid, isosurface extraction (marching cubes), and mesh coloration —
one GPU or a z-slab-sharded mesh of several.
"""

__version__ = "0.1.0"

from .core import Camera, DepthMapView, RayPotential, VoxelGrid

__all__ = ["Camera", "DepthMapView", "RayPotential", "VoxelGrid", "__version__"]
