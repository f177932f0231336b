"""3D immersed elasticity (tests/test_models.py's
test_immersed_elasticity_3d_block_mg workload: the cut cube, n_fg = 2·n_bg,
three fields, ``ImmersedElasticityProblem(k=1)``) built by the JAX package
and by the port from identical numpy state, for the 3D block-path test
files. One build per n_bg per process."""
import functools

import jax
import jax.numpy as jnp
import torch

from iifea_tpu.mesh.generators import immersed_cube_problem as j_cube
from iifea_tpu.models.elasticity import ImmersedElasticityProblem as JElastic
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.ops.projection import assemble_background_system


class Elastic3:
    """3D immersed elasticity (three fields, n_fg = 2·n_bg) assembled by
    both packages from the same numpy state, once per n_bg."""

    def __init__(self, n_bg):
        mesh_j, self.M_j = j_cube(n_fg=2 * n_bg, n_bg=n_bg, n_fields=3)
        form_j = JElastic(mesh_j, k=1).form
        A, self.b_j = jax.jit(lambda u: j_assemble(form_j, u, self.M_j))(
            jnp.zeros(form_j.n_dofs))
        self.A_j = JBackgroundOperator(form_j, A.blocks, self.M_j)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=self.M_j.idx_np,
            val=self.M_j.val_np, n_bg_dofs=self.M_j.n_bg_dofs, device="cpu")
        self.M = st.M
        self.prob = ImmersedElasticityProblem(st.mesh, k=1, device="cpu")
        self.A, self.b = assemble_background_system(
            self.prob.form,
            torch.zeros(self.prob.space.n_dofs, dtype=torch.float64), st.M)
        self.shape = (n_bg + 1,) * 3

    def norms(self, u):
        return self.prob.error_norms(self.M.mv(u))


@functools.cache
def elastic3(n_bg: int) -> Elastic3:
    return Elastic3(n_bg)
