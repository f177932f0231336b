"""The port's 2D main path end to end (BinnedLatticeSolver on CPU tensors)
vs the JAX package's explicitly projected system solved by host SuperLU,
from identical state at n_bg=24, n_fg=48."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_square_problem as j_problem
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.projection import assemble_background_system
from iifea_tpu.solvers import solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.lattice_bin import LatticeBinError
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BG, N_FG = 24, 48


@pytest.fixture(scope="module")
def reference():
    mesh_j, M_j = j_problem(n_fg=N_FG, n_bg=N_BG)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10)
    A, b = assemble_background_system(prob_j.form,
                                      jnp.zeros(prob_j.space.n_dofs), M_j)
    u_d, _ = solve_ksp(A, b, method="direct")
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu",
    )
    return (np.asarray(b), np.asarray(u_d), np.asarray(A.diag()), st)


def _solver(st):
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    return prob, BinnedLatticeSolver(prob, st.M, (N_BG + 1, N_BG + 1),
                                     device="cpu")


def test_torch_slice_solve_matches_direct(reference):
    b_ref, u_d, diag, st = reference
    _, solver = _solver(st)
    u, info = solver.solve(rtol=1e-10)
    assert info["rel_residual"] < 1e-10
    assert info["cg_iters"] > 0
    assert u.dtype == torch.float64 and u.shape == (st.M.n_bg_dofs,)
    b64, _, _ = solver.assemble()
    assert (np.linalg.norm(b64.numpy() - b_ref)
            / np.linalg.norm(b_ref)) < 1e-13
    mask = np.abs(diag) > 0
    scale = max(float(np.abs(u_d).max()), 1.0)
    assert np.abs(u.numpy()[mask] - u_d[mask]).max() <= 1e-7 * scale


def test_torch_slice_error_norms(reference):
    """The discrete solution is close to the manufactured one."""
    *_, st = reference
    prob, solver = _solver(st)
    u, _ = solver.solve(rtol=1e-10)
    norms = prob.error_norms(st.M.mv(u))
    assert 0 < norms["L2"] < 0.05 and 0 < norms["H10"] < 0.2


def test_torch_slice_rejects_unsupported(reference):
    *_, st = reference
    prob = PoissonProblem(st.mesh, device="cpu")
    with pytest.raises(LatticeBinError):
        BinnedLatticeSolver(prob, st.M, (N_BG + 1,) * 3, device="cpu")
    with pytest.raises(ValueError):
        BinnedLatticeSolver(prob, st.M, (N_BG + 1, N_BG + 1), device="meta")


def test_torch_port_imports_no_jax():
    """Every module of the port (models, utils, demos included) and
    chip_smoke.py import neither JAX nor the JAX package."""
    code = ("import importlib, pkgutil, sys, iifea_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "iifea_tpu_torch.__path__, 'iifea_tpu_torch.')]; "
            "import iifea_tpu_torch.models.navier_stokes, "
            "iifea_tpu_torch.utils.checkpoint, iifea_tpu_torch.utils.fieldio, "
            "iifea_tpu_torch.demos.tg_vortex, "
            "iifea_tpu_torch.demos.background_unfitted.tg_unfitted; "
            "import chip_smoke; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'iifea_tpu' not in sys.modules, 'iifea_tpu imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
