"""Host sparse direct solve, the 'mumps' role (numpy/scipy copy of
``iifea_tpu/solvers/direct.py``; it takes and returns numpy arrays).

SuperLU (``scipy.sparse.linalg.splu``) with the null-pivot handling the
reference gets from MUMPS (``mat_mumps_icntl_24=1`` / ``cntl_3=1e-12``):

- structurally empty rows (background basis functions without foreground
  support) become identity rows up front;
- a factorization's stability is judged by iterative refinement, not by its
  one-solve residual: a stable LU of an ill-conditioned system stagnates at
  its conditioning floor and is accepted, while an unstable one diverges
  under refinement and escalates a relative-diagonal BFR trim (row and
  column zeroed, unit diagonal, zero rhs);
- if every rung is unstable (near-null subspaces that are not axis-aligned),
  the solve falls back to Jacobi-preconditioned CG, then BiCGStab, from
  zero, which never excite the near-null directions.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

# relative-diagonal trim thresholds (|d| <= tol·max|d|), tried in order
_TRIM_LADDER = (None, 1e-12, 1e-10, 1e-8, 1e-6)


def _trim_sym(A, b, keep_mask):
    """Zero rows and columns of ~keep_mask, unit diagonal, zero rhs."""
    Dm = sp.diags(keep_mask.astype(np.float64))
    At = (Dm @ A @ Dm + sp.diags(1.0 - keep_mask)).tocsc()
    return At, b * keep_mask


def solve_direct(A_csr, b: np.ndarray, null_pivot_tol: float = 1e-12,
                 relres_ok: float = 1e-8,
                 relres_accept: float = 1e-4) -> np.ndarray:
    """Solve A x = b with sparse LU; returns a numpy array."""
    A = A_csr.tocsr()
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[0]

    # structurally dead rows: max |entry| below the absolute tolerance
    row_max = np.zeros(n)
    if A.nnz:
        row_of = np.repeat(np.arange(n), np.diff(A.indptr))
        np.maximum.at(row_max, row_of, np.abs(A.data))
    alive = (row_max > null_pivot_tol).astype(np.float64)

    d = np.abs(A.diagonal())
    dmax = d.max() if n else 1.0

    best = None
    for tol in _TRIM_LADDER:
        keep = alive if tol is None else alive * (d > tol * dmax)
        At, bt = _trim_sym(A, b, keep)
        # relative to the system actually factorized
        bnorm = max(np.linalg.norm(bt), 1e-300)
        try:
            lu = spla.splu(At)
            x = lu.solve(bt)
        except RuntimeError:  # singular factor: escalate the trim
            continue
        relres = np.linalg.norm(At @ x - bt) / bnorm
        if not np.isfinite(relres):
            continue
        # refinement stagnates on a stable factorization (accept it) and
        # diverges on an unstable one (escalate)
        diverged = False
        for _ in range(4):
            if relres <= relres_ok:
                break
            x2 = x + lu.solve(bt - At @ x)
            r2 = np.linalg.norm(At @ x2 - bt) / bnorm
            if not np.isfinite(r2) or r2 > 10.0 * relres:
                diverged = True
                break
            if r2 < relres:
                x, relres = x2, r2
            else:
                break
        if best is None or relres < best[0]:
            best = (relres, x)
        if relres <= relres_ok or (not diverged and relres <= relres_accept):
            return x

    # every LU rung failed the backward-error check: Krylov from zero
    At, bt = _trim_sym(A, b, alive)
    bnorm = max(np.linalg.norm(bt), 1e-300)
    dd = np.abs(At.diagonal())
    Minv = sp.diags(1.0 / np.where(dd > 0, dd, 1.0))
    x = np.zeros(n)
    for solver in (spla.cg, spla.bicgstab):
        x_it, _ = solver(At, bt, M=Minv, x0=x, maxiter=20000,
                         rtol=relres_ok * 1e-2, atol=0.0)
        relres = np.linalg.norm(At @ x_it - bt) / bnorm
        if np.isfinite(relres) and (best is None or relres < best[0]):
            best = (relres, x_it)
        if relres <= relres_ok:
            return x_it
        x = x_it if np.all(np.isfinite(x_it)) else x

    if best is None:
        raise RuntimeError("solve_direct: all trimmed factorizations failed")
    return best[1]
