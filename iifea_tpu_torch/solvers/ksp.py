"""solveKSP parity: one front-end for the background linear solves (port of
``iifea_tpu/solvers/ksp.py``).

  method 'cg' | 'gmres' | 'gcr' | 'bicgstab'   Krylov on the device
         'direct' | 'mumps'                    host SuperLU (solvers/direct)
  pc     'none', 'jacobi' (exact diagonal of Mᵀ A_f M)
         'mg'     geometric multigrid on a lattice background: the projected
                  operator is assembled into radius-2 stencil planes from
                  the lattice-binned (2D) or cell-window (3D) tables and
                  preconditioned by a V-cycle; needs ``lattice_shape``
         'ICC' | 'ILU' | 'ILUT' degrade to 'jacobi' with a warning.

Not ported yet, and raising ``NotImplementedError``: pc='bjacobi' on a
multi-field system and pc='asm' (ROADMAP.md item 13, with the block
workloads), and the pc='mg' cases that need the coloured general probe, a
trim mask, a shift, a stencil radius other than 2 or a form the lattice
tables cannot bin (ROADMAP.md item 12a). With a single field pc='bjacobi'
is pointwise Jacobi, as in the reference.

The MG route (``_mg_solve``) differs from the JAX package in two ways, by
design:

* ``mixed`` (f32 probe, MG and Krylov, refined against the exact f64
  operator until the f64 relative residual meets rtol) turns on by default
  for f64 systems on CUDA, where the hand-written stencil kernels are f32
  and an f64 stencil apply would run the plain ``mv_ref``; JAX turns it on
  for f64 systems on a TPU. On the CPU it stays off, so an f64 system runs
  the whole MG-Krylov solve in f64, as JAX does on the CPU. On CUDA a
  non-f32 stencil (``mixed=False`` with an f64 system) is refused.
* The Krylov matvec is ``S.mv``, the hand kernel for f32 stencils, as in
  ``BinnedLatticeSolver``; JAX applies ``S.mv_ref`` because of a TPU
  layout clash between a Pallas call and the V-cycle's convolutions.
"""
from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch

from iifea_tpu_torch.ops.projection import BackgroundOperator
from iifea_tpu_torch.solvers import krylov, precond
from iifea_tpu_torch.solvers.direct import solve_direct
from iifea_tpu_torch.solvers.trim import apply_trim_rhs, trim_mask_from_diag

_NO_GPU_PC = {"ICC", "ILU", "ILUT"}

# the lattice tables are a host pass over every element plus device
# uploads: repeated solve_ksp(pc='mg') calls on the same (form, M) reuse
# them. Weak keys: dropping the form or M frees the tables.
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_UNBINNABLE = object()   # sentinel: the tables raised LatticeBinError


def lattice_tables(form, M, shape):
    """The cached lattice-binned (2D) or cell-window (3D) reducers of
    (form, M) on ``shape``, or None when the form cannot be binned."""
    from iifea_tpu_torch.ops import cell_window, lattice_bin

    per_M = _TABLES.setdefault(form, weakref.WeakKeyDictionary())
    by_shape = per_M.setdefault(M, {})
    if shape not in by_shape:
        build = (lattice_bin.build_binned_projection if len(shape) == 2
                 else cell_window.build_window_projection)
        try:
            by_shape[shape] = build(form, M, shape, device=M.device)
        except lattice_bin.LatticeBinError:
            by_shape[shape] = _UNBINNABLE
    out = by_shape[shape]
    return None if out is _UNBINNABLE else out


def _probe(reducers, blocks, shape, dtype):
    """Stencil operator of Mᵀ A_f M from the compact element blocks: the
    direct congruence assembly, f64 tables and blocks, cast to ``dtype``."""
    from iifea_tpu_torch.ops import cell_window, lattice_bin
    from iifea_tpu_torch.ops.stencil import StencilOperator2D, StencilOperator3D

    if len(shape) == 2:
        C = lattice_bin.stencil_planes_binned(reducers, blocks)
        return StencilOperator2D(C.to(dtype), shape, 2)
    C = cell_window.stencil_planes_windows(reducers, blocks)
    return StencilOperator3D(C.to(dtype), shape, 2)


def _run_stencil_krylov(S, mg, b, x0, rtol, atol, method, max_it, restart):
    """MG-preconditioned Krylov on a stencil operator: CG for 'cg', (F)GMRES
    for every other method, as in the reference."""
    # check every 4 iterations: a V-cycle per iteration costs more than
    # the host sync of a check, and CG's default of 8 would run further
    # past the tolerance
    kw = dict(minv=mg.minv, rtol=rtol, atol=atol, max_it=max_it,
              check_every=4)
    if method == "cg":
        return krylov.cg(S.mv, b, x0, **kw)
    return krylov.gmres(S.mv, b, x0, restart=restart, **kw)


def _mg_solve(A, b, x0, lattice_shape, method, rtol, atol, max_it,
              n_fields=1, stencil_radius=2, restart=300, mixed=None):
    """Assemble the projected operator into stencil form and solve with an
    MG-preconditioned Krylov method: the lattice fast path as a library
    feature (see the module docstring for ``mixed``)."""
    from iifea_tpu_torch.ops.multigrid import (
        StencilMultigrid,
        StencilMultigrid3D,
        full_f32,
    )

    shape = tuple(int(s) for s in lattice_shape)
    if n_fields > 1:
        raise NotImplementedError(
            "pc='mg' on a multi-field system needs the block stencil "
            "operators (ROADMAP.md item 13)")
    reducers = None
    if A.trim_mask is None and A.shift is None and stencil_radius == 2:
        reducers = lattice_tables(A.form, A.M, shape)
    if reducers is None:
        raise NotImplementedError(
            "pc='mg' with a trim mask, a shift, stencil_radius != 2 or a form "
            "the lattice tables cannot bin needs the coloured general probe "
            "(ROADMAP.md item 12a)")
    if mixed is None:
        mixed = b.dtype == torch.float64 and b.device.type == "cuda"
    sdt = torch.float32 if mixed else b.dtype
    if b.device.type == "cuda" and sdt != torch.float32:
        raise ValueError(
            "on CUDA pc='mg' runs the f32 stencil kernels: pass an f32 "
            "system or mixed=True (the default for f64 systems)")
    full_f32()
    S = _probe(reducers, A.blocks, shape, sdt)
    mg = StencilMultigrid(S) if len(shape) == 2 else StencilMultigrid3D(S)

    if not mixed:
        return _run_stencil_krylov(S, mg, b, x0, rtol, atol, method,
                                   max_it, restart)

    # -- mixed precision: f32 MG-Krylov passes + f64 refinement --------------
    b_norm = float(torch.linalg.vector_norm(b))
    rtol_eff = max(float(rtol), float(atol) / max(b_norm, 1e-300))
    x64 = x0.to(torch.float64)
    zero32 = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    iters, relf, hist = 0, 1.0, []
    for _ in range(12):
        r64 = b - A.mv(x64)
        relf = float(torch.linalg.vector_norm(r64)) / b_norm
        hist.append(relf)
        if relf < rtol_eff or iters >= max_it:
            break
        # contract only as far as this pass needs (0.25x margin for the
        # f32 apply error), clamped to the f32 floor
        rtol_pass = min(max(0.25 * rtol_eff / relf, 1e-6), 3e-2)
        dx, info = _run_stencil_krylov(S, mg, r64.to(torch.float32), zero32,
                                       rtol_pass, 0.0, method, max_it,
                                       restart)
        iters += info.iters
        x64 = x64 + dx.to(torch.float64)
        if info.iters == 0:
            break   # no progress possible (e.g. a zero rhs)
    return x64, krylov.SolveInfo(iters, relf * b_norm, relf < rtol_eff,
                                 hist)


def solve_ksp(A: BackgroundOperator, b: torch.Tensor,
              x0: torch.Tensor | None = None, method: str = "gmres",
              pc: str = "jacobi", rtol: float = 1e-8, atol: float = 1e-9,
              max_it: int = 1000000, gmres_restart: int = 300,
              bfr_tol: float | None = None, bfr_b: bool = True,
              monitor: bool = True, lattice_shape: tuple | None = None,
              n_fields: int = 1, stencil_radius: int = 2,
              mixed: bool | None = None):
    """Solve A u = b on the background space; returns (u, info), info None
    for the direct solve. Everything runs on b's device (the direct solve's
    factorization on the host). ``mixed`` applies to pc='mg' only: None =
    auto (on for f64 systems on CUDA), True/False forces it."""
    method = method or "gmres"
    pc = pc or "jacobi"
    if pc in _NO_GPU_PC:
        warnings.warn(
            f"preconditioner '{pc}' has no GPU-native analog; using 'jacobi'",
            stacklevel=2)
        pc = "jacobi"

    if bfr_tol is not None:
        mask = trim_mask_from_diag(A.diag(), bfr_tol)
        A = A.with_trim(mask)
        if bfr_b:
            b = apply_trim_rhs(b, mask)

    if method in ("mumps", "direct"):
        u = solve_direct(A.to_scipy(), b.cpu().numpy())
        return torch.as_tensor(u, dtype=b.dtype, device=b.device), None

    x0 = torch.zeros_like(b) if x0 is None else x0
    if pc in ("asm", "ASM") or (pc == "bjacobi" and n_fields > 1):
        raise NotImplementedError(
            f"pc='{pc}' waits for the block workloads (ROADMAP.md item 13)")
    if pc == "mg":
        if lattice_shape is None:
            raise ValueError(
                "pc='mg' requires lattice_shape=(nx+1, ny+1[, nz+1])")
        x, info = _mg_solve(A, b, x0, lattice_shape, method, rtol, atol,
                            max_it, n_fields=n_fields,
                            stencil_radius=stencil_radius,
                            restart=gmres_restart, mixed=mixed)
    else:
        if pc == "bjacobi":
            warnings.warn(
                "pc='bjacobi' with a single field is pointwise jacobi; "
                "pass n_fields>1 for field-coupled blocks", stacklevel=2)
            pc = "jacobi"
        minv = precond.jacobi(A.diag()) if pc == "jacobi" else None
        kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it)
        if method == "cg":
            x, info = krylov.cg(A.mv, b, x0, **kw)
        elif method == "bicgstab":
            x, info = krylov.bicgstab(A.mv, b, x0, **kw)
        elif method == "gcr":
            x, info = krylov.gcr(A.mv, b, x0, restart=gmres_restart, **kw)
        else:
            x, info = krylov.gmres(A.mv, b, x0, restart=gmres_restart, **kw)
    if monitor:
        _print_monitor(info)
    return x, info


def _print_monitor(info):
    print(f"Converged in {int(info.iters)} iterations. "
          f"(residual norm {float(info.resnorm):.3e})")
    if info.history is not None:
        h = np.asarray(info.history)
        print("Convergence history:", h[h >= 0].tolist())
