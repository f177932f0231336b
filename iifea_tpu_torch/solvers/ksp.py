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

Every (dimension, 1–3 fields, radius, f32 or f64) MG solve runs on the
hand kernels on CUDA: fixed-radius instances at radius 1–4, the
runtime-radius ones from 5 (a quartic or higher B-spline background).
Refused with ``ValueError``: a 2D radius whose staged tile a block cannot
hold (above 41 in f64 with three fields; ``stencil_kernels.max_radius2d``)
and a 3D lattice where a block cannot hold even one field's staged x
planes (f64, radius 4 from about a 313-point row; three fields from a
73-point row are staged one field at a time).

The MG route (``_mg_solve``) differs from the JAX package in these ways,
by design:

* ``mixed`` (f32 probe, MG and Krylov, refined against the exact f64
  operator until the f64 relative residual meets rtol) turns on by default
  for f64 systems on CUDA at radius 1 and 2; JAX turns it on for f64
  systems on a TPU. From radius 3 (the biharmonic on the quadratic, cubic
  and quartic nets, κ ~ h⁻⁴) it stays off on CUDA too: the f64 route runs the
  f64 instances of the hand kernels, the
  JAX package's own arithmetic off a TPU (``MIXED_DEFAULT_MAX_RADIUS``).
  On the CPU it stays off, so an f64 system runs the whole MG-Krylov solve
  in f64, as JAX does on the CPU. ``mixed=False`` runs that f64 route on
  the card too, on the f64 instances of every kernel (2D and 3D, scalar
  and block).
* In the mixed route each f32 pass solves for the residual less its
  component along the deflation vectors that are also left null vectors
  of A (``_left_null_rows``): no update reduces that component, and a pass
  asked to reach below it stalls. A pass on a one-level hierarchy checks
  its CG every iteration. JAX's mixed route (a TPU's) does neither; its
  f64 route, and the port's, are the same arithmetic.
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
from iifea_tpu_torch.utils.profiling import timed

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
    temporaries stay under PROBE_BUDGET_BYTES: those of the element
    product, or those of the extraction's gather and Mᵀ on the operator's
    support (two (k, kmax, rows) planes), whichever is larger, plus the
    largest padded gather of a fixed-order sum (the form's scatters, Mᵀ)."""
    per_col, n_temps = 0, 4
    for dom, _ in A.form.terms:
        ne, nE = dom.eldofsT.shape
        if ne * nE > per_col:
            per_col, n_temps = ne * nE, ne + 3
    if per_col == 0:
        return None
    gathers = [A.form._scatter(i).pos.numel()
               for i in range(len(A.form.terms))]
    words = (max(n_temps * per_col, 2 * A.support()[2].numel())
             + max(gathers + [A.support()[3].pos.numel()]))
    item = torch.empty((), dtype=dtype).element_size()
    return max(int(PROBE_BUDGET_BYTES // (words * item)), 1)


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


def _left_null_rows(A, Q, S):
    """The rows q of the deflation space Q that are also left null vectors
    of the exact operator (‖Aᵀq‖ < 1e-8·max row sum, in A's f64), or None.
    The residual's component along such a q is a property of b that no
    update can change: for an enclosed flow's constant pressure the
    continuity rows tested with q = 1 sum to the boundary flux of the
    data, whatever u and p are."""
    sig = float(S.coeffs.abs().sum(dim=(1, 2)).max())
    adt = A.blocks[0].dtype
    rows = [q for q in Q
            if float(torch.linalg.vector_norm(A.mv_t(q.to(adt)))) < 1e-8 * sig]
    return torch.stack(rows) if rows else None


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
                        restart, check_every=4):
    """MG-preconditioned Krylov on a stencil operator: CG for 'cg', (F)GMRES
    for every other method, as in the reference. With a deflation space Q
    the preconditioner is P·mg·P, P = I − QᵀQ."""
    minv = mg.minv
    if Q is not None:
        def minv(r):
            z = mg.minv(r - Q.T @ (Q @ r))
            return z - Q.T @ (Q @ z)
    # check every 4 iterations by default: a V-cycle per iteration costs
    # more than the host sync of a check, and CG's default of 8 would run
    # further past the tolerance
    kw = dict(minv=minv, rtol=rtol, atol=atol, max_it=max_it,
              check_every=check_every)
    if method == "cg":
        return krylov.cg(S.mv, b, x0, **kw)
    return krylov.gmres(S.mv, b, x0, restart=restart, **kw)


# the largest stencil radius at which pc='mg' on CUDA runs mixed (f32
# passes refined in f64) by default; above it, the f64 route
MIXED_DEFAULT_MAX_RADIUS = 2


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _cuda_mg_refusal(shape, n_fields, radius, dtype) -> Exception | None:
    """Why the card's stencil kernels cannot take this MG solve, or None:
    they take 2D and 3D operators of 1 to 3 fields at every radius in f32
    or f64, up to the 2D radius a block can stage
    (``stencil_kernels._check_instance``); every 3D lattice (one whose x
    planes a block cannot stage runs the unstaged route)."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    if dtype not in (torch.float32, torch.float64):
        return ValueError(
            f"on CUDA pc='mg' runs f32 or f64 stencil kernels, got {dtype}")
    try:
        sk._check_instance(dtype, radius, n_fields, len(shape))
    except ValueError as e:
        return e
    return None


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
    on_card = _on_card(b)
    if mixed is None:
        mixed = (b.dtype == torch.float64 and on_card
                 and stencil_radius <= MIXED_DEFAULT_MAX_RADIUS)
    sdt = torch.float32 if mixed else b.dtype
    if on_card:
        err = _cuda_mg_refusal(shape, n_fields, stencil_radius, sdt)
        if err is not None:
            raise err
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
    # a pass aims at the reducible part of the residual: its component
    # along a left null vector stays whatever the pass does, and asking a
    # pass to reach below it stalls every pass (the unpinned Taylor-Green
    # system: thousands of GMRES iterations a solve on the card, 16 + 12
    # with the projection at n_bg = 16)
    QL = None if Q is None else _left_null_rows(A, Q, S)
    b_norm = float(torch.linalg.vector_norm(b))
    rtol_eff = max(float(rtol), float(atol) / max(b_norm, 1e-300))
    x64 = x0.to(torch.float64)
    zero32 = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    # a pass on a single level checks every iteration: its dense inverse
    # takes the residual to the f32 floor in one, and the iterations past
    # it amplify rounding noise
    check_every = 1 if len(mg.levels) == 1 else 4
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
        r32 = r64.to(torch.float32)
        if QL is not None:
            r32 = r32 - QL.T @ (QL @ r32)
        # a pass stops where its f32 residual stops falling (three checks
        # of CG; GMRES's three cycles): the single 3 x 9³ level of the 3D
        # elasticity at n_bg = 8 (a coarse inverse amplifying a near-null
        # pair) otherwise wandered for up to 10⁶ CG iterations on a card
        dx, info = _run_stencil_krylov(S, mg, Q, r32, zero32,
                                       rtol_pass, 0.0, method, max_it,
                                       restart, check_every)
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
              asm_overlap: int = 1, timings: dict | None = None):
    """Solve A u = b on the background space; returns (u, info), info None
    for the direct solve. Everything runs on b's device (the direct solve's
    factorization and pc='asm''s patch setup on the host). ``mixed``
    applies to pc='mg' only: None = auto (on for f64 systems on CUDA),
    True/False forces it. ``asm_core``/``asm_overlap``: dofs per patch core
    and adjacency layers of overlap of pc='asm'. ``timings``, a dict,
    accumulates the direct solve's host stages: "to_scipy" (Mᵀ A_f M
    formed on the host) and "direct_solve" (the sparse LU)."""
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
        timings = {} if timings is None else timings
        with timed(timings, "to_scipy"):
            A_sp = A.to_scipy()
        with timed(timings, "direct_solve"):
            u = solve_direct(A_sp, b.cpu().numpy())
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
