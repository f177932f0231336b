"""The immersed elasticity system (tests/test_models.py's workload: the cut
square, n_fg = 2·n_bg, two fields, ``ImmersedElasticityProblem(k=1)``)
built by the JAX package and by the port from identical numpy state, for
the block-path test files. One build per n_bg per process: the JAX side's
assembly and block probe compile for each shape, and both files use the
same sizes."""
import functools

import jax
import jax.numpy as jnp
import torch

from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.elasticity import ImmersedElasticityProblem as JElastic
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperatorBlock2D as JBlock
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import StencilOperatorBlock2D


class Elastic:
    """Both packages' problem, assembled at u = 0 (``A_j``/``b_j``,
    ``A``/``b``), and on first use both block stencil probes (``S_j``,
    ``S``, f64)."""

    def __init__(self, n_bg):
        mesh_j, self.M_j = j_square(n_fg=2 * n_bg, n_bg=n_bg, n_fields=2)
        self.prob_j = JElastic(mesh_j, k=1)
        form_j = self.prob_j.form
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
        self.shape = (n_bg + 1, n_bg + 1)

    @functools.cached_property
    def S_j(self):
        return JBlock.probe_multi(self.A_j.mv_multi, self.shape, n_fields=2,
                                  dtype=jnp.float64)

    @functools.cached_property
    def S(self):
        return StencilOperatorBlock2D.probe_multi(
            self.A.mv_multi, self.shape, n_fields=2, dtype=torch.float64,
            device="cpu")

    def norms(self, u):
        return self.prob.error_norms(self.M.mv(u))


@functools.cache
def elastic(n_bg: int) -> Elastic:
    return Elastic(n_bg)
