"""Newton solvers on the background space (port of
``iifea_tpu/solvers/newton.py``).

``solve_nonlinear`` mirrors the reference's solveNonlinear: per iteration
the residual and its autodiff Jacobian are re-assembled (one jacfwd pass,
``Form.jacobian_and_residual``) and re-projected, the update system
``J du = R`` is solved through ``solve_ksp``, and convergence is tested on
both the relative ‖du‖ and the relative ‖R‖, with absolute escapes after
iteration 1. The converged iteration's du is not applied, as in the
reference. With ``linear_pc='mg'`` every linearised solve runs the
hand-written stencil kernels on a card (the stencil planes are rebuilt per
iteration, since the Jacobian changes; the lattice tables are cached per
(form, M) by ``ksp.lattice_tables``).

``solve_newtons_linear`` mirrors solveNewtonsLinear: defect correction for
ill-conditioned linear systems, A and L assembled once, iterations solving
``A du = A u + L``.

Everything runs on ``u_p``'s device.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from contextvars import ContextVar

import torch

from iifea_tpu_torch.ops.assembly import Form
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.projection import BackgroundOperator
from iifea_tpu_torch.solvers.ksp import solve_ksp
from iifea_tpu_torch.solvers.trim import (
    apply_trim_rhs,
    mask_from_ids,
    trim_mask_from_diag,
)
from iifea_tpu_torch.utils.logging import log_info
from iifea_tpu_torch.utils.profiling import timed


class NonlinearSolveError(RuntimeError):
    pass


# the list ``recording`` fills, per thread and task
_RECORD: ContextVar[list | None] = ContextVar("newton_record", default=None)


@contextmanager
def recording(record: list):
    """Within the block, every Newton iteration of ``solve_nonlinear``
    appends one dict to ``record``: the seconds of the assembly
    (``assembly``: element Jacobians, residual and Mᵀr) and of the linear
    solve (``solve``, with the direct solve's host stages ``to_scipy`` and
    ``direct_solve`` inside it), each synchronised with the card, and the
    linear iterations (``linear_iters``, None for the direct solve)."""
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


def _norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v))


def solve_nonlinear(
    form: Form,
    u_f: torch.Tensor,
    M: ExtractionOperator,
    u_p: torch.Tensor,
    aux=None,
    params=None,
    max_iters: int = 20,
    relative_tolerance: float = 1e-4,
    monitor_newton: bool = True,
    monitor_linear: bool = False,
    linear_method: str | None = None,
    linear_pc: str | None = None,
    bfr_tol: float | None = None,
    relax_param: float = 1.0,
    absolute_tolerance: float = 1e-6,
    absolute_tolerance_res: float = 1e-9,
    du_0_mag: float | None = None,
    zero_ids=None,
    estimate_cond_num: bool = False,
    linear_rtol: float = 1e-8,
    linear_atol: float = 1e-9,
    lattice_shape: tuple | None = None,
    n_fields: int = 1,
    line_search: bool = False,
    max_halvings: int = 8,
    ptc_sigma0: float | None = None,
):
    """Newton's iteration; returns (u_p, u_f) with u_f = M u_p kept in sync.
    Inside a ``recording`` block each iteration is recorded.

    ``linear_pc='mg'`` + ``lattice_shape`` routes each linearised solve
    through the stencil fast path (``solvers/ksp._mg_solve``).

    ``bfr_tol`` trims rows by the Jacobian's diagonal, ``zero_ids`` pins the
    listed background dofs; either way the trimmed rows' rhs is the current
    u_p, so the update leaves them at zero.

    ``line_search=True`` adds a backtracking (Armijo on ‖R‖) globalisation:
    step α·relax·du with α halved from 1 until
    ‖R(u − α·relax·du)‖ ≤ (1 − 1e-4 α)‖R(u)‖; if no α in ``max_halvings``
    qualifies, the least-bad trial is taken.

    ``ptc_sigma0`` enables pseudo-transient continuation: each linearised
    solve uses A + σ_k·|diag(A)| with σ_k = σ0·min(1, ‖R_k‖/‖R_0‖)."""
    aux = aux or {}
    initial_norm = initial_norm_res = None
    converged = False
    record = _RECORD.get()

    def trim_mask(A):
        if bfr_tol is not None:
            return trim_mask_from_diag(A.diag(), bfr_tol)
        if zero_ids is not None:
            return mask_from_ids(zero_ids, M.n_bg_dofs, device=u_p.device)
        return None

    for i in range(max_iters):
        rec = {}

        def clock(key):
            return nullcontext() if record is None else timed(rec, key)

        with clock("assembly"):
            blocks, res = form.jacobian_and_residual(u_f, aux, params)
            R_b = M.rmv(res)
        A = BackgroundOperator(form, blocks, M)
        mask = trim_mask(A)
        if mask is not None:
            A = A.with_trim(mask)
            R_b = apply_trim_rhs(R_b, mask, target=u_p)

        if estimate_cond_num:
            from iifea_tpu_torch.solvers.condition import (
                estimate_condition_number,
            )

            smax, smin = estimate_condition_number(A)
            log_info(f"sigma_max: {smax}, sigma_min: {smin}")

        current_norm_res = _norm(R_b)
        if i == 0:
            initial_norm_res = current_norm_res
        relative_norm_res = current_norm_res / max(initial_norm_res, 1e-300)
        if ptc_sigma0 is not None:
            sig = ptc_sigma0 * min(1.0, relative_norm_res)
            A = A.with_shift(sig * A.diag().abs())
        with clock("solve"):
            du_p, info = solve_ksp(
                A, R_b, method=linear_method or "gmres",
                pc=linear_pc or "jacobi", monitor=monitor_linear,
                rtol=linear_rtol, atol=linear_atol,
                lattice_shape=lattice_shape, n_fields=n_fields, timings=rec,
            )
        if record is not None:
            rec["linear_iters"] = None if info is None else int(info.iters)
            record.append(rec)
        current_norm = _norm(du_p)
        if i == 0:
            initial_norm = current_norm
        if du_0_mag is not None:
            initial_norm = du_0_mag
        relative_norm = current_norm / max(initial_norm, 1e-300)
        if monitor_newton:
            log_info(
                f"Newton solver iteration: {i}, Relative norm of du: "
                f"{relative_norm}, Relative norm of res: {relative_norm_res}"
            )
        if relative_norm < relative_tolerance and \
                relative_norm_res < relative_tolerance:
            converged = True
            break
        if i > 1 and (
            current_norm < absolute_tolerance
            or current_norm_res < absolute_tolerance_res
        ):
            converged = True
            break
        if line_search:
            # the shifted operator's diagonal decides the bfr mask here, as
            # in the reference
            mask = trim_mask(A)

            def merit(trial_p, trial_f):
                R = M.rmv(form.residual(trial_f, aux, params))
                if mask is not None:
                    R = apply_trim_rhs(R, mask, target=trial_p)
                return _norm(R)

            alpha, accepted = 1.0, False
            best_state, best_rn = None, float("inf")
            for _ in range(max_halvings):
                trial_p = u_p - (alpha * relax_param) * du_p
                trial_f = M.mv(trial_p)
                rn = merit(trial_p, trial_f)
                if rn <= (1.0 - 1e-4 * alpha) * current_norm_res:
                    u_p, u_f, accepted = trial_p, trial_f, True
                    break
                if rn < best_rn:
                    best_state, best_rn = (trial_p, trial_f, alpha), rn
                alpha *= 0.5
            if not accepted:
                u_p, u_f, alpha = best_state
            if monitor_newton:
                log_info(f"    line search: alpha = {alpha}"
                         + ("" if accepted else " (least-bad fallback)"))
        else:
            u_p = u_p - relax_param * du_p
            u_f = M.mv(u_p)

    if not converged:
        raise NonlinearSolveError("Nonlinear solver failed to converge.")
    return u_p, u_f


def solve_newtons_linear(
    form: Form,
    u_f: torch.Tensor,
    M: ExtractionOperator,
    u_p: torch.Tensor,
    aux=None,
    params=None,
    max_iters: int = 20,
    relative_tolerance: float = 1e-7,
    monitor_newton: bool = True,
    monitor_linear: bool = False,
    linear_method: str | None = None,
    linear_pc: str | None = None,
    relax_param: float = 1.0,
    zero_ids=None,
):
    """Defect correction for ill-conditioned linear systems.

    Assembles A_b and L_b = Mᵀ R(0) once, then iterates
    res = A u + L; solve A du = res; u −= relax·du, from the caller's u_p
    (a warm start). Returns (u_p, u_f = M u_p).

    Pinned rows (``zero_ids``) target zero: in the fixed point
    res = A u + L = 0 with identity trim rows, L[pin] = t gives u[pin] = −t,
    so the warm start as target would pin the dofs at minus the initial
    guess."""
    aux = aux or {}
    blocks, res = form.jacobian_and_residual(torch.zeros_like(u_f), aux,
                                             params)
    L_b = M.rmv(res)
    A = BackgroundOperator(form, blocks, M)
    u_p = torch.as_tensor(u_p, dtype=L_b.dtype, device=L_b.device)
    if zero_ids is not None:
        mask = mask_from_ids(zero_ids, M.n_bg_dofs, device=L_b.device)
        A = A.with_trim(mask)
        L_b = apply_trim_rhs(L_b, mask, target=None)
        u_p = torch.where(mask, 0.0, u_p)

    initial_norm = initial_norm_res = None
    for i in range(max_iters):
        res_b = A.mv(u_p) + L_b
        current_norm_res = _norm(res_b)
        du_p, _ = solve_ksp(
            A, res_b, method=linear_method or "gmres",
            pc=linear_pc or "jacobi", monitor=monitor_linear,
        )
        current_norm = _norm(du_p)
        if i == 0:
            initial_norm = current_norm
            initial_norm_res = current_norm_res
        relative_norm = current_norm / max(initial_norm, 1e-300)
        relative_norm_res = current_norm_res / max(initial_norm_res, 1e-300)
        if monitor_newton:
            log_info(
                f"Newton solver iteration: {i}, Relative norm of du: "
                f"{relative_norm}, Relative norm of res: {relative_norm_res}"
            )
        if relative_norm < relative_tolerance or \
                relative_norm_res < relative_tolerance:
            log_info("converged")
            return u_p, M.mv(u_p)
        u_p = u_p - relax_param * du_p
    raise NonlinearSolveError("Nonlinear solver failed to converge.")
