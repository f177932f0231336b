"""solveKSP parity: one front-end for the background linear solves (port of
``iifea_tpu/solvers/ksp.py``).

  method 'cg' | 'gmres' | 'gcr' | 'bicgstab'   Krylov on the device
         'direct' | 'mumps'                    host SuperLU (solvers/direct)
  pc     'none', 'jacobi' (exact diagonal of Mᵀ A_f M)
         'bjacobi' point-block Jacobi on the exact (nF, nF) node blocks
                  (``BackgroundOperator.block_diag``); pointwise Jacobi
                  with a single field, as in the reference
         'mg'     geometric multigrid on a lattice background; needs
                  ``lattice_shape``. The projected operator becomes stencil
                  planes by one of three routes: radius 2, untrimmed,
                  unshifted, single-field, binnable: the direct assembly
                  from the lattice-binned (2D) or cell-window (3D) tables;
                  otherwise the coloured general probe of ``A.mv_multi``
                  (``StencilOperator2D/3D.probe_multi``); n_fields > 1: the
                  block probe, preconditioned by ``StencilMultigridBlock``
                  (2D) or ``StencilMultigridBlock3D`` with field-constant
                  null-mode deflation
         'asm'    restricted additive Schwarz (``precond.AdditiveSchwarz``):
                  host patch setup from the explicit CSR, batched dense
                  patch solves on the device; ``asm_core``, ``asm_overlap``
         'ICC' | 'ILU' | 'ILUT' degrade to 'jacobi' with a warning.

Not ported yet, and raising ``NotImplementedError``: on CUDA a stencil
radius the kernels do not take (3: ROADMAP.md item 14).

The MG route (``_mg_solve``) differs from the JAX package in these ways,
by design:

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
* The general probe applies the operator in its own dtype (f64) and casts
  the planes to the stencil dtype; that is JAX's arithmetic, where the f32
  combs meet f64 extraction weights. Its column chunk follows a fixed
  budget for the 80 GB card (``PROBE_BUDGET_BYTES``), not an environment
  variable.
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

# live temporaries of one general-probe chunk (the stacked element gather
# and products, (ne + 3) per column): sized for the 80 GB card. The n_bg=512
# elasticity probe (754,974 block cells, 6 dofs each, 50 f64 columns,
# ~326 MB per column) runs unchunked; the trimmed 3D n_bg=104 Poisson probe
# (2,847,276 cells, 125 columns, ~638 MB per column) in chunks of 26, its
# solve peaking at 19.2 GiB (chip_smoke.py, H100 80GB HBM3 at 700 W); the
# n_bg=96 3D elasticity probe (375 columns) in chunks of a few.
PROBE_BUDGET_BYTES = 16 * 2 ** 30

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


def _probe_chunk(A, dtype) -> int | None:
    """Probe columns per chunk so the stacked ``A.mv_multi``'s live
    temporaries stay under PROBE_BUDGET_BYTES."""
    per_col, n_temps = 0, 4
    for dom, _ in A.form.terms:
        ne, nE = dom.eldofsT.shape
        if ne * nE > per_col:
            per_col, n_temps = ne * nE, ne + 3
    if per_col == 0:
        return None
    item = torch.empty((), dtype=dtype).element_size()
    return max(int(PROBE_BUDGET_BYTES // (n_temps * per_col * item)), 1)


def _probe_general(A, shape, radius, dtype):
    """Stencil operator of A by the coloured probe of ``A.mv_multi`` in
    A's dtype, cast to ``dtype``."""
    from iifea_tpu_torch.ops.stencil import StencilOperator2D, StencilOperator3D

    adt = A.blocks[0].dtype
    op = StencilOperator2D if len(shape) == 2 else StencilOperator3D
    S = op.probe_multi(A.mv_multi, shape, radius=radius, dtype=adt,
                       chunk=_probe_chunk(A, adt), device=A.M.device)
    return S.to(dtype)


def _probe_block(A, shape, n_fields, radius, dtype):
    """Block stencil operator of A (2D or 3D by the lattice's rank) by the
    nF·(2r+1)^dim colour probe."""
    from iifea_tpu_torch.ops.stencil import (
        StencilOperatorBlock2D,
        StencilOperatorBlock3D,
    )

    adt = A.blocks[0].dtype
    op = StencilOperatorBlock2D if len(shape) == 2 else StencilOperatorBlock3D
    S = op.probe_multi(
        A.mv_multi, shape, n_fields=n_fields, radius=radius, dtype=adt,
        chunk=_probe_chunk(A, adt), device=A.M.device)
    return S.to(dtype)


def _deflation_space(S, n_fields, dtype):
    """Field-constant null-mode deflation: for each field, the normalised
    indicator of its supported nodes, kept if the stencil maps it to
    (numerically) zero, as an enclosed flow's constant pressure. A V-cycle's
    coarse pseudo-inverse would amplify such near-null content. Returns the
    (q, n) orthonormal rows, or None."""
    dgf = S.point_block_diag()
    sig = float(S.coeffs.abs().sum(dim=(1, 2)).max())
    qs = []
    for f in range(n_fields):
        v = torch.zeros((n_fields, S.nn), dtype=dtype, device=S.device)
        v[f] = (dgf[f, f].abs() > 0).to(dtype)
        v = v.reshape(-1)
        vn = float(torch.linalg.vector_norm(v))
        if vn == 0.0:
            continue
        v = v / vn
        if float(torch.linalg.vector_norm(S.mv(v))) < 1e-8 * sig:
            qs.append(v)
    return torch.stack(qs) if qs else None


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


def _run_stencil_krylov(S, mg, Q, b, x0, rtol, atol, method, max_it,
                        restart):
    """MG-preconditioned Krylov on a stencil operator: CG for 'cg', (F)GMRES
    for every other method, as in the reference. With a deflation space Q
    the preconditioner is P·mg·P, P = I − QᵀQ."""
    minv = mg.minv
    if Q is not None:
        def minv(r):
            z = mg.minv(r - Q.T @ (Q @ r))
            return z - Q.T @ (Q @ z)
    # check every 4 iterations: a V-cycle per iteration costs more than
    # the host sync of a check, and CG's default of 8 would run further
    # past the tolerance
    kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it,
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
        StencilMultigridBlock,
        StencilMultigridBlock3D,
        full_f32,
    )

    shape = tuple(int(s) for s in lattice_shape)
    if mixed is None:
        mixed = b.dtype == torch.float64 and b.device.type == "cuda"
    sdt = torch.float32 if mixed else b.dtype
    if b.device.type == "cuda" and sdt != torch.float32:
        raise ValueError(
            "on CUDA pc='mg' runs the f32 stencil kernels: pass an f32 "
            "system or mixed=True (the default for f64 systems)")
    if b.device.type == "cuda" and stencil_radius not in (1, 2):
        raise NotImplementedError(
            f"stencil_radius={stencil_radius}: the CUDA stencil kernels take "
            "radius 1 or 2 (radius 3, the biharmonic: ROADMAP.md item 14)")
    full_f32()
    Q = None
    if n_fields > 1:
        S = _probe_block(A, shape, n_fields, stencil_radius, sdt)
        mg = (StencilMultigridBlock(S) if len(shape) == 2
              else StencilMultigridBlock3D(S))
        Q = _deflation_space(S, n_fields, sdt)
    else:
        reducers = None
        if A.trim_mask is None and A.shift is None and stencil_radius == 2:
            reducers = lattice_tables(A.form, A.M, shape)
        S = (_probe(reducers, A.blocks, shape, sdt) if reducers is not None
             else _probe_general(A, shape, stencil_radius, sdt))
        mg = StencilMultigrid(S) if len(shape) == 2 else StencilMultigrid3D(S)

    if not mixed:
        return _run_stencil_krylov(S, mg, Q, b, x0, rtol, atol, method,
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
        dx, info = _run_stencil_krylov(S, mg, Q, r64.to(torch.float32),
                                       zero32,
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
              mixed: bool | None = None, asm_core: int = 64,
              asm_overlap: int = 1):
    """Solve A u = b on the background space; returns (u, info), info None
    for the direct solve. Everything runs on b's device (the direct solve's
    factorization and pc='asm''s patch setup on the host). ``mixed``
    applies to pc='mg' only: None = auto (on for f64 systems on CUDA),
    True/False forces it. ``asm_core``/``asm_overlap``: dofs per patch core
    and adjacency layers of overlap of pc='asm'."""
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
    if pc == "mg":
        if lattice_shape is None:
            raise ValueError(
                "pc='mg' requires lattice_shape=(nx+1, ny+1[, nz+1])")
        x, info = _mg_solve(A, b, x0, lattice_shape, method, rtol, atol,
                            max_it, n_fields=n_fields,
                            stencil_radius=stencil_radius,
                            restart=gmres_restart, mixed=mixed)
    else:
        if pc == "bjacobi" and n_fields <= 1:
            warnings.warn(
                "pc='bjacobi' with a single field is pointwise jacobi; "
                "pass n_fields>1 for field-coupled blocks", stacklevel=2)
            pc = "jacobi"
        if pc in ("asm", "ASM"):
            minv = precond.AdditiveSchwarz(
                A.to_scipy(), core_size=asm_core, overlap=asm_overlap,
                dtype=b.dtype, device=b.device).minv
        elif pc == "bjacobi":
            minv = precond.block_jacobi(A.block_diag(n_fields))
        elif pc == "jacobi":
            minv = precond.jacobi(A.diag())
        else:
            minv = None
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
