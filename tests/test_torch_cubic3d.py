"""The 3D radius-4 multigrid (the cubic B-spline background in 3D) against
the JAX package on the CPU from the same numpy inputs:

* a seeded two-level 17³ operator at r = 4: the Galerkin coarse operator
  (``_coarsen3``: the RAP kernel and the off-grid masks), the dense coarse
  pseudo-inverse of its 9³ level and one V-cycle, each to 1e-10;
* the 3D biharmonic on the 9³ cubic net (``immersed_cube_bspline_problem(
  n_fg=12, n_bg=6, bg_degree=3)``, one dense level): the 729-colour probe,
  the pseudo-inverse and the V-cycle on b, and both packages'
  ``solve_ksp(gmres, pc='mg', stencil_radius=4)``.

The second is the witness for ``chip_smoke.py``'s 3D cubic gates: the JAX
package's own cycle takes about a hundred GMRES iterations on this one
dense level, and a relative residual of 1e-11 fixes the solution only to
about 1e-2 (``tests/compare_cubic3_jax.py`` takes the same comparison to
the 17³ net).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from iifea_tpu.mesh.generators import (
    immersed_cube_bspline_problem as j_bspline_cube,
)
from iifea_tpu.models.biharmonic import BiharmonicProblem as JBiharmonic
from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.solvers import ksp as jksp
from iifea_tpu_torch.mesh.generators import immersed_cube_bspline_problem
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import StencilOperator3D
from iifea_tpu_torch.solvers import ksp as tksp

R = 4
N_BG = 6                     # a 9³ cubic net: one dense level


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_torch_multigrid3d_radius4():
    """``_coarsen3`` at radius 4 (its 729 planes through the RAP kernel and
    the off-grid masks), the 9³ level's dense pseudo-inverse and one
    V-cycle (Chebyshev smoothing on the 17³ level) on a seeded two-level
    operator, each against JAX's to 1e-10."""
    shape = (17, 17, 17)
    rng = np.random.default_rng(19)
    C = rng.uniform(-0.005, 0.005, (729, *shape))
    C[364] += 4.0
    S_j = JStencil3(jnp.asarray(C), shape, R)
    S_t = StencilOperator3D(torch.from_numpy(C), shape, R)
    mg_j, mg_t = jmg.StencilMultigrid3D(S_j), tmg.StencilMultigrid3D(S_t)
    assert [lv.shape for lv in mg_t.levels] == [shape, (9, 9, 9)]
    assert _rel(mg_t.levels[1].coeffs, mg_j.levels[1].coeffs) < 1e-10
    assert _rel(mg_t.coarse_inv, mg_j.coarse_inv) < 1e-10
    r = rng.standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)), mg_j.minv(jnp.asarray(r))) \
        < 1e-10


def test_torch_cubic_biharmonic3d_matches_jax():
    """The 3D biharmonic on the 9³ cubic net in both packages: b and the
    probe's planes to 1e-12, the dense pseudo-inverse to 1e-10 and the
    V-cycle on b to 1e-9 (measured 3.6e-15, 8.4e-13, 4.2e-11: the 50
    Newton–Schulz steps leave the near-null modes of cubic B-splines with
    slivers of support half inverted, where rounding parts the packages).
    Then MG-GMRES to 1e-10 in each: both converge to a true residual below
    1e-10, in iteration counts within 10 (98 JAX, 104 the port) and with
    L2/H1/H2 within 1e-4 relative (7.1e-6 measured): a residual of 1e-11
    fixes this solution only to ~6e-3 (max-abs, JAX against the port)."""
    mesh_j, M_j, shape = j_bspline_cube(n_fg=2 * N_BG, n_bg=N_BG,
                                        bg_degree=3)
    prob_j = JBiharmonic(mesh_j)
    form_j = prob_j.form
    A, b_j = jax.jit(lambda u: j_assemble(form_j, u, M_j))(
        jnp.zeros(form_j.n_dofs))
    A_j = JBackgroundOperator(form_j, A.blocks, M_j)
    shape = tuple(shape)
    S_j = jksp._probe_general(A_j, shape, R, "float64",
                              jksp._probe_chunk(A_j, np.dtype(np.float64)))
    mg_j = jmg.StencilMultigrid3D(S_j)

    mesh, M, shape_t = immersed_cube_bspline_problem(
        n_fg=2 * N_BG, n_bg=N_BG, bg_degree=3, device="cpu")
    assert tuple(shape_t) == shape == (9, 9, 9)
    prob = BiharmonicProblem(mesh, device="cpu")
    A_t, b_t = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    assert _rel(b_t, b_j) < 1e-12
    S = tksp._probe_general(A_t, shape, R, torch.float64)
    assert _rel(S.coeffs, S_j.coeffs) < 1e-12
    mg = tmg.StencilMultigrid3D(S)
    assert len(mg.levels) == 1 and mg.coarse_inv is not None
    assert _rel(mg.coarse_inv, mg_j.coarse_inv) < 1e-10
    assert _rel(mg.minv(b_t), jax.jit(mg_j.minv)(b_j)) < 1e-9

    kw = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=shape,
              stencil_radius=R, monitor=False)
    x_j, info_j = jksp.solve_ksp(A_j, b_j, **kw)
    x, info = tksp.solve_ksp(A_t, b_t, **kw)
    assert info.converged and bool(info_j.converged)
    assert float(jnp.linalg.norm(b_j - A_j.mv(x_j))) < 1e-10 * float(
        jnp.linalg.norm(b_j))
    assert float(torch.linalg.vector_norm(b_t - A_t.mv(x))) < 1e-10 * float(
        torch.linalg.vector_norm(b_t))
    assert abs(int(info.iters) - int(info_j.iters)) <= 10
    n, n_j = prob.error_norms(M.mv(x)), prob_j.error_norms(M_j.mv(x_j))
    for k in ("L2_rel", "H1_rel", "H2_rel"):
        assert abs(n[k] - float(n_j[k])) <= 1e-4 * float(n_j[k]), k
