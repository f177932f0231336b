"""Reference-API parity surface (port of
``iifea_tpu/api.py``): one function per public call of the reference's
``common``/``la_utils``.

  getIdentity                    -> ExtractionOperator.identity
  zeroDofBackground              -> zero_dof_background
  transferToForeground           -> transfer_to_foreground
  assembleLinearSystemBackground -> assemble_background_system
  AT_x / A_x_b / AT_R_A          -> M.rmv / operator.mv / BackgroundOperator
  solveKSP                       -> solve_ksp
  solveNonlinear                 -> solve_nonlinear
  solveNewtonsLinear             -> solve_newtons_linear
  trimNodes / removeZeroDiagonal -> solvers.trim utilities
  estimateConditionNumber        -> estimate_condition_number
  L2Project / L2Norm             -> l2_project / l2_norm
  generateUnfittedMesh           -> generate_unfitted_mesh
  mixedScalarSpace               -> mixed_scalar_space
  averageCellDiagonal            -> average_cell_diagonal
  cellMetric                     -> cell_metric

``readExOp`` comes with the mesh files (ROADMAP.md item 12e).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.mesh.generators import generate_unfitted_mesh  # noqa: F401
from iifea_tpu_torch.ops.assembly import Form, Term, integrate
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.projection import (  # noqa: F401
    BackgroundOperator,
    assemble_background_system,
)
from iifea_tpu_torch.solvers.condition import (  # noqa: F401
    estimate_condition_number,
)
from iifea_tpu_torch.solvers.ksp import solve_ksp
from iifea_tpu_torch.solvers.newton import (  # noqa: F401
    NonlinearSolveError,
    solve_newtons_linear,
    solve_nonlinear,
)


def zero_dof_background(M: ExtractionOperator,
                        dtype=torch.float64) -> torch.Tensor:
    """zeroDofBackground parity: a zero background vector on M's device."""
    return torch.zeros(M.n_bg_dofs, dtype=dtype, device=M.device)


def transfer_to_foreground(u_p: torch.Tensor,
                           M: ExtractionOperator) -> torch.Tensor:
    """transferToForeground parity: u_f = M u_b."""
    return M.mv(u_p)


def l2_project(expr_fn, space: FunctionSpace, cell_dom,
               M: ExtractionOperator, bfr_tol=None, method="cg",
               pc="jacobi", monitor=False):
    """L2Project parity: mass-matrix projection of an expression onto the
    foreground and background spaces; returns (u_p, u_f = M u_p).
    ``expr_fn(x) -> (n_fields,)`` target values at one point x (dim,)."""
    nF = space.n_fields

    def kern(u_loc, aux_loc, ctx, params):
        uq = torch.einsum("qb,bf->qf", ctx.phi, u_loc)
        eq = vmap(expr_fn)(ctx.x).reshape(uq.shape[0], nF)
        return torch.einsum("q,qf,qb->bf", ctx.w, uq - eq, ctx.phi)

    form = Form(space, [Term(cell_dom, kern)])
    u0 = torch.zeros(space.n_dofs, dtype=torch.float64, device=M.device)
    A, b = assemble_background_system(form, u0, M)
    u_p, _ = solve_ksp(A, b, method=method, pc=pc, bfr_tol=bfr_tol,
                       monitor=monitor)
    return u_p, M.mv(u_p)


def l2_norm(u: torch.Tensor, cell_dom, n_fields: int = 1) -> float:
    """L2Norm parity over a cell domain."""

    def kern(u_loc, aux_loc, ctx, params):
        uq = torch.einsum("qb,bf->qf", ctx.phi, u_loc)
        return torch.einsum("q,qf->", ctx.w, uq ** 2)

    return math.sqrt(float(integrate(cell_dom, kern, u, n_fields=n_fields)))


def mixed_scalar_space(mesh: Mesh, k: int = 1) -> FunctionSpace:
    """mixedScalarSpace parity: the equal-order u-u-p space."""
    return FunctionSpace(mesh, degree=k, n_fields=3)


def average_cell_diagonal(mesh: Mesh) -> float:
    """averageCellDiagonal parity."""
    average_cell_area = float(mesh.cell_volumes.sum()) / mesh.n_cells
    return math.sqrt(average_cell_area * 4)


def cell_metric(mesh: Mesh) -> np.ndarray:
    """cellMetric parity: G = (4/h_max²) I."""
    return (4.0 / mesh.hmax() ** 2) * np.eye(mesh.dim)
