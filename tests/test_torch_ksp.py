"""The port's solve_ksp vs the JAX package's on the same immersed problems,
from identical numpy state: every Krylov method with pc none/jacobi and the
direct solve on the cut square (n_fg=48, n_bg=32), pc='mg' in 2D (n_bg=32)
and 3D (n_bg=6), and nonsymmetric Nitsche with BiCGStab. Solutions agree to
1e-6·max|x| on dofs with a nonzero diagonal (the criterion of
tests/test_solvers.py::test_solve_ksp_mg_pc) and iteration counts within
the port's check interval."""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_cube_problem as j_cube
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.solvers.ksp import solve_ksp

CHECK = {"cg": 8, "bicgstab": 8, "gmres": 1, "gcr": 1}
MG_CHECK = 4        # the MG route checks CG and GMRES every 4 iterations


def j_assemble_jit(form, M):
    """The JAX package's assemble_background_system at u = 0 as one jitted
    call (one XLA compile, ~10x faster on the CPU than op by op); the
    operator is rebuilt on the original form and M, whose host-side
    tables jit's outputs do not carry."""
    A, b = jax.jit(lambda u: j_assemble(form, u, M))(jnp.zeros(form.n_dofs))
    return JBackgroundOperator(form, A.blocks, M), b


class System:
    """One immersed problem assembled by both packages."""

    def __init__(self, gen, n_fg, n_bg, sym=True):
        mesh_j, M_j = gen(n_fg=n_fg, n_bg=n_bg)
        prob_j = JPoisson(mesh_j, k=1, sym=sym, beta_value=10)
        self.A_j, self.b_j = j_assemble_jit(prob_j.form, M_j)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=M_j.idx_np, val=M_j.val_np,
            n_bg_dofs=M_j.n_bg_dofs, device="cpu")
        prob = PoissonProblem(st.mesh, k=1, sym=sym, beta_value=10,
                              device="cpu")
        self.A, self.b = assemble_background_system(
            prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64),
            st.M)
        self.alive = np.abs(np.asarray(self.A_j.diag())) > 0
        self.shape = (n_bg + 1,) * mesh_j.dim
        self._ref = {}

    def ref(self, **kw):
        """The JAX solve with these arguments, computed once."""
        key = tuple(sorted(kw.items()))
        if key not in self._ref:
            x, info = j_solve_ksp(self.A_j, self.b_j, monitor=False, **kw)
            self._ref[key] = (np.asarray(x), None if info is None
                              else int(info.iters))
        return self._ref[key]

    def agree(self, x, x_ref):
        x = x.numpy()
        scale = np.abs(x_ref).max()
        return np.abs(x - x_ref)[self.alive].max() <= 1e-6 * scale


@pytest.fixture(scope="module")
def square():
    return System(j_square, 48, 32)


@pytest.mark.parametrize("pc", ["none", "jacobi"])
@pytest.mark.parametrize("method", ["cg", "gmres", "gcr", "bicgstab"])
def test_torch_solve_ksp_krylov(square, method, pc):
    x_ref, it_ref = square.ref(method=method, pc=pc, rtol=1e-10)
    x, info = solve_ksp(square.A, square.b, method=method, pc=pc,
                        rtol=1e-10, monitor=False)
    assert info.converged
    assert square.agree(x, x_ref)
    assert abs(info.iters - it_ref) < max(CHECK[method], 2)


def test_torch_solve_ksp_direct(square):
    x_ref, _ = square.ref(method="direct")
    x, info = solve_ksp(square.A, square.b, method="direct")
    assert info is None and x.dtype == torch.float64
    assert square.agree(x, x_ref)


@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_torch_solve_ksp_mg_2d(square, method):
    """pc='mg' on the CPU runs in f64 (mixed off), as JAX's on the CPU."""
    x_ref, it_ref = square.ref(method=method, pc="mg", rtol=1e-10,
                               lattice_shape=square.shape)
    x, info = solve_ksp(square.A, square.b, method=method, pc="mg",
                        rtol=1e-10, lattice_shape=square.shape,
                        monitor=False)
    assert info.converged
    assert square.agree(x, x_ref)
    assert abs(info.iters - it_ref) < MG_CHECK


def test_torch_solve_ksp_mg_mixed(square, capsys):
    """The f32 MG-Krylov passes with f64 refinement (the CUDA default),
    here on the plain versions: f64 residual below rtol, the f64 MG
    solution of JAX reproduced."""
    x_ref, _ = square.ref(method="cg", pc="mg", rtol=1e-10,
                          lattice_shape=square.shape)
    x, info = solve_ksp(square.A, square.b, method="cg", pc="mg",
                        rtol=1e-10, lattice_shape=square.shape, mixed=True)
    assert x.dtype == torch.float64
    rel = float(torch.linalg.vector_norm(square.b - square.A.mv(x))
                / torch.linalg.vector_norm(square.b))
    assert info.converged and rel < 1e-10
    assert len(info.history) >= 2 and info.history[-1] < 1e-10
    assert square.agree(x, x_ref)
    assert "Converged in" in capsys.readouterr().out


def test_torch_solve_ksp_mg_3d():
    """pc='mg' on a 3D lattice against JAX's Jacobi-CG solution (JAX's own
    3D MG solve compiles for over a minute on the CPU; at n_bg=6 the 7³
    lattice is the dense coarsest level, so both packages' MG-CG take 4)."""
    cube = System(j_cube, 10, 6)
    x_ref, it_j = cube.ref(method="cg", pc="jacobi", rtol=1e-10)
    x, info = solve_ksp(cube.A, cube.b, method="cg", pc="mg", rtol=1e-10,
                        lattice_shape=cube.shape, monitor=False)
    assert info.converged and info.iters == MG_CHECK < it_j
    assert cube.agree(x, x_ref)


def test_torch_solve_ksp_nonsymmetric_bicgstab():
    nonsym = System(j_square, 48, 32, sym=False)
    x_ref, it_ref = nonsym.ref(method="bicgstab", pc="jacobi", rtol=1e-10)
    x, info = solve_ksp(nonsym.A, nonsym.b, method="bicgstab", pc="jacobi",
                        rtol=1e-10, monitor=False)
    assert info.converged and nonsym.agree(x, x_ref)
    assert abs(info.iters - it_ref) < CHECK["bicgstab"]


def test_torch_solve_ksp_options(square):
    """bfr trimming, the ICC fallback, pc='mg' on a trimmed operator (the
    coloured general probe) and pc='asm' (the solve, with JAX's count)."""
    A, b = square.A, square.b
    x_ref, _ = square.ref(method="gmres", pc="jacobi", rtol=1e-10,
                          bfr_tol=1e-9)
    x, _ = solve_ksp(A, b, method="gmres", pc="jacobi", rtol=1e-10,
                     bfr_tol=1e-9, monitor=False)
    assert square.agree(x, x_ref)
    with pytest.warns(UserWarning, match="jacobi"):
        x_icc, _ = solve_ksp(A, b, method="cg", pc="ICC", rtol=1e-10,
                             monitor=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x_jac, _ = solve_ksp(A, b, method="cg", pc="jacobi", rtol=1e-10,
                             monitor=False)
    assert torch.equal(x_icc, x_jac)
    x_ref, it_ref = square.ref(method="gmres", pc="asm", rtol=1e-10)
    x, info = solve_ksp(A, b, method="gmres", pc="asm", rtol=1e-10,
                        monitor=False)
    assert info.converged and square.agree(x, x_ref)
    assert abs(info.iters - it_ref) < max(CHECK["gmres"], 2)
    mask = A.diag() <= 0
    x_ref, it_ref = square.ref(method="cg", pc="mg", rtol=1e-10,
                               lattice_shape=square.shape, bfr_tol=0.0)
    x, info = solve_ksp(A.with_trim(mask), b, pc="mg", method="cg",
                        rtol=1e-10, lattice_shape=square.shape, monitor=False)
    assert info.converged and abs(info.iters - it_ref) < MG_CHECK
    assert square.agree(x, x_ref)
    with pytest.raises(ValueError, match="lattice_shape"):
        solve_ksp(A, b, pc="mg", monitor=False)
