"""ReconstructionPipeline over a device mesh (end-to-end sharded fusion)."""

import numpy as np

from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from cudadepthmapintegration_tpu.parallel import make_mesh
from cudadepthmapintegration_tpu.pipeline import (
    ReconstructionConfig,
    ReconstructionPipeline,
)
from cudadepthmapintegration_tpu.testing import sphere_scene

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)


def config17():
    return ReconstructionConfig(
        grid_dims=(17, 17, 17),
        grid_spacing=(0.2, 0.2, 0.2),
        grid_origin=(-1.63, -1.61, -1.59),
        ray_thick=0.1, ray_rho=0.8, ray_eta=0.03, ray_delta=0.3,
        contour_value=1.0,
        dtype="float64",
        write_mha_path=None,
    )


def test_pipeline_runs_sharded_over_mesh():
    views = sphere_scene(n_views=6, width=64, height=48)
    mesh = make_mesh(n_z=8)
    pipe = ReconstructionPipeline(config17(), mesh=mesh)
    result = pipe.run(views)
    grid = VoxelGrid(
        dims=(17, 17, 17), origin=(-1.63, -1.61, -1.59), spacing=(0.2,) * 3
    )
    exp = integrate_views_oracle(grid, views, PARAMS, threshold_best_cost=0.14)
    np.testing.assert_allclose(result.volume, exp, atol=1e-9)
    assert result.views_fused == 6
    assert result.mesh.num_triangles > 50

