"""The port's 3D main path end to end (BinnedLatticeSolver on CPU tensors)
vs the JAX package at n_bg=16, n_fg=20 (17³ → 9³: one Chebyshev-smoothed
level above the dense coarse solve), from identical state: the JAX
explicitly projected system solved by host SuperLU gives the reference
error norms (the criterion of the JAX package's 3D end-to-end test), and
the JAX BinnedLatticeSolver gives the reference CG iteration count."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_cube_problem as j_problem
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.projection import assemble_background_system
from iifea_tpu.solvers import BinnedLatticeSolver as JSolver
from iifea_tpu.solvers import solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

N_BG, N_FG = 16, 20
SHAPE = (N_BG + 1,) * 3


@pytest.fixture(scope="module")
def reference():
    mesh_j, M_j = j_problem(n_fg=N_FG, n_bg=N_BG, degree=1, dtype=np.float64)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10, dtype=np.float64)
    A, b = assemble_background_system(prob_j.form,
                                      jnp.zeros(prob_j.space.n_dofs), M_j)
    u_d, _ = solve_ksp(A, b, method="direct")
    norms_d = prob_j.error_norms(M_j.mv(u_d))
    _, info_j = JSolver(prob_j, M_j, SHAPE).solve(rtol=1e-10)
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu",
    )
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    solver = BinnedLatticeSolver(prob, st.M, SHAPE, device="cpu")
    u, info = solver.solve(rtol=1e-10)
    return np.asarray(b), norms_d, info_j, st, prob, solver, u, info


def test_torch_slice3d_converges(reference):
    b_ref, _, info_j, st, _, solver, u, info = reference
    assert info["rel_residual"] < 1e-10
    assert u.dtype == torch.float64 and u.shape == (st.M.n_bg_dofs,)
    assert len(solver.build_mg(solver.probe(solver.bind(
        *solver.assemble()[1:]))).levels) == 2
    b64, *_ = solver.assemble()
    assert (np.linalg.norm(b64.numpy() - b_ref)
            / np.linalg.norm(b_ref)) < 1e-13
    # the reference's window-mode solve at the same size
    assert float(info_j["rel_residual"]) < 1e-10
    assert abs(info["cg_iters"] - int(info_j["cg_iters"])) <= 3


def test_torch_slice3d_error_norms_match_direct(reference):
    """Sliver-cut background dofs are numerically undetermined; the
    foreground field is not: its L2/H10 errors match the direct solve's to
    1e-8 relative."""
    _, norms_d, _, st, prob, _, u, _ = reference
    norms = prob.error_norms(st.M.mv(u))
    for key in ("L2", "H10"):
        assert abs(norms[key] - norms_d[key]) < 1e-8 * abs(norms_d[key]), key
    assert 0 < norms["L2"] < 0.1


def test_torch_slice3d_residual_is_exact(reference):
    """The refinement residual is the exact f64 b − Mᵀ A_f M x."""
    *_, solver, u, info = reference
    b64, Kc, Kf = solver.assemble()
    r64, r32, relres = solver.residual(solver.bind(Kc, Kf), b64, u)
    assert relres == pytest.approx(info["rel_residual"], rel=1e-6)
    assert r32.dtype == torch.float32 and r64.dtype == torch.float64
