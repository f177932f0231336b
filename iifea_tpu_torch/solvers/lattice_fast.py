"""The lattice fast solve (port of the 2D binned mode and the 3D window
mode of ``iifea_tpu/solvers/lattice_fast.py``).

2D (binned mode):
  setup (host, once): lattice-binned tables (ops/lattice_bin.py), rhs
                      quadrature tables and slot-bound cell geometry
  solve:  assemble  f64 P1 cell stiffness on the bound geometry, Nitsche
                    facet Jacobian (torch.func), f64 rhs
          bind      facet blocks into the slot layout
          probe     direct stencil assembly of Mᵀ A_f M (f64, cast to f32)
          build_mg  StencilMultigrid on the f32 stencil
          refine    f32 MG-PCG passes, refined with f64 binned residuals
                    until the relative f64 residual is below rtol

3D (window mode):
  setup (once):   cell-window tables (ops/cell_window.py)
  solve:  assemble  Form.jacobian_and_residual in f64: compact element
                    blocks (ne, ne, nE) per term and b = −Mᵀ r
          bind      nothing: the probe binds per slab from compact blocks
          probe     window congruence G = EᵀKE and placement into the
                    radius-2 3D stencil planes (f64, cast to f32)
          build_mg  StencilMultigrid3D (conv RAP, Chebyshev on the l1
                    scaling, dense coarsest level)
          refine    f32 MG-PCG passes, refined with the exact f64 residual
                    b − Mᵀ A_f M x (ops/projection.BackgroundOperator)

The f32 CG matvec, the V-cycle residuals and the V-cycle smoothers run on
the hand-written CUDA kernels when the solver lives on a GPU.

Scope: scalar P1 problems with one cell term and one boundary-facet term
on a lattice whose dimension is the mesh's (2 or 3). Construction raises
``LatticeBinError`` otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from iifea_tpu_torch.models.poisson import p1_stiffness_arrays
from iifea_tpu_torch.ops import cell_window, lattice_bin
from iifea_tpu_torch.ops.assembly import Form
from iifea_tpu_torch.ops.multigrid import (
    StencilMultigrid,
    StencilMultigrid3D,
    full_f32,
)
from iifea_tpu_torch.ops.projection import BackgroundOperator
from iifea_tpu_torch.ops.stencil import StencilOperator2D, StencilOperator3D
from iifea_tpu_torch.solvers import krylov


class BinnedLatticeSolver:
    """End-to-end immersed solve on a 2D or 3D lattice background.

    >>> solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1),
    ...                              device="cuda")
    >>> solver3 = BinnedLatticeSolver(prob3, M3, (n_bg + 1,) * 3,
    ...                               device="cuda")
    >>> u_b, info = solver.solve(rtol=1e-10)

    ``u_b`` is the f64 background solution; ``info`` reports the achieved
    relative f64 residual and the total f32 CG iterations.
    """

    def __init__(self, prob, M, lattice_shape, *, device="cuda"):
        self.device = torch.device(device)
        self.prob = prob
        self.M = M
        self.shape = tuple(lattice_shape)
        self.dim = len(self.shape)
        if self.dim != prob.mesh.dim:
            raise lattice_bin.LatticeBinError(
                f"a {self.dim}D lattice under a {prob.mesh.dim}D mesh")
        for what, dev in (("problem", prob.device), ("extraction", M.device)):
            if dev != self.device:
                raise ValueError(f"{what} lives on {dev}, solver on "
                                 f"{self.device}")
        form = prob.form
        if prob.space.degree != 1:
            raise lattice_bin.LatticeBinError(
                "BinnedLatticeSolver requires a P1 foreground space")
        if len(form.terms) != 2:
            raise lattice_bin.LatticeBinError(
                "BinnedLatticeSolver expects the [cell, facet] form, got "
                f"{len(form.terms)} terms")
        full_f32()

        if self.dim == 3:
            self.reducers = cell_window.build_window_projection(
                form, M, self.shape, device=self.device)
            return
        self.reducers = lattice_bin.build_binned_projection(
            form, M, self.shape, device=self.device)
        self.rhs_tables = prob.rhs_tables(self.reducers)
        red_c = self.reducers[0]
        self.JinvT_b = red_c.bind_static(prob.cell_dom.JinvT)
        self.wdetT_b = red_c.bind_static(prob.cell_dom.wdetT)
        self.gref = prob.cell_dom.gphi_ref.cpu().numpy()
        self.facet_form = Form(prob.space, [form.terms[1]])

    def __getstate__(self):
        """A 2D solver sent to another process (a rank of
        ``parallel.sharding.launch``) carries its lattice tables and the
        extraction, not the problem: the problem's form holds local
        functions, which do not pickle. There it refines and measures f64
        residuals; it cannot assemble. A 3D solver's residual needs the
        form, so it does not pickle."""
        if self.dim == 3:
            raise TypeError("a 3D BinnedLatticeSolver does not pickle: its "
                            "f64 residual needs the problem's form")
        return {k: v for k, v in vars(self).items()
                if k not in ("prob", "facet_form")}

    # -- pipeline stages --------------------------------------------------------

    def assemble(self):
        """2D: (b64, bound cell stiffness (3, 3, L, nc), facet blocks
        (3, 3, nF)); 3D: (b64, compact cell blocks (4, 4, nE), compact
        facet blocks (4, 4, nF)). All f64."""
        u0 = torch.zeros(self.prob.space.n_dofs, dtype=torch.float64,
                         device=self.device)
        if self.dim == 3:
            (K_cell, K_facet), r = self.prob.form.jacobian_and_residual(u0)
            return -self.M.rmv(r), K_cell, K_facet
        b64 = lattice_bin.project_rhs_binned(
            self.reducers, self.prob.rhs_el(self.rhs_tables))
        K_cell_b = p1_stiffness_arrays(self.JinvT_b, self.wdetT_b, self.gref)
        K_facet = self.facet_form.jacobian_blocks(u0)[0]
        return b64, K_cell_b, K_facet

    def bind(self, K_cell_b, K_facet):
        if self.dim == 3:
            return [K_cell_b, K_facet]
        return [K_cell_b, self.reducers[1].bind_blocks(K_facet)]

    def probe(self, bound):
        if self.dim == 3:
            C = cell_window.stencil_planes_windows(self.reducers, bound)
            return StencilOperator3D(C.to(torch.float32), self.shape, 2)
        C = lattice_bin.stencil_planes_binned_bound(self.reducers, bound)
        return StencilOperator2D(C.to(torch.float32), self.shape, 2)

    def build_mg(self, S32):
        if self.dim == 3:
            return StencilMultigrid3D(S32)
        return StencilMultigrid(S32)

    def residual(self, bound, b64, x64):
        """(r64, r32, relres): exact f64 residual, on the binned operator in
        2D and on Mᵀ A_f M from the compact blocks in 3D."""
        if self.dim == 3:
            A64 = BackgroundOperator(self.prob.form, bound, self.M)
            r64 = b64 - A64.mv(x64)
        else:
            r64 = b64 - lattice_bin.apply_binned(self.reducers, bound, x64)
        relres = float(torch.linalg.vector_norm(r64)
                       / torch.linalg.vector_norm(b64))
        return r64, r64.to(torch.float32), relres

    def cg(self, S32, mg, r32, rtol_pass):
        return krylov.cg(S32.mv, r32, minv=mg.minv, rtol=rtol_pass,
                         atol=1e-30, max_it=500, check_every=4)

    def refine(self, S32, mg, bound, b64, rtol, max_passes: int = 10,
               cg_fn=None):
        """f32 MG-PCG passes with f64 residual refinement. Pass 0 solves on
        b; each later pass first measures the f64 residual and stops below
        rtol. Returns (x64, relres, total CG iterations).

        ``cg_fn(S32, mg, r32, rtol_pass) -> (dx32, info)`` replaces the
        single-device CG (``cg``): the row-block sharded MG-PCG of
        ``parallel.multigrid.refine_sharded`` runs inside this loop."""
        cg_fn = cg_fn or self.cg
        x64 = torch.zeros(self.M.n_bg_dofs, dtype=torch.float64,
                          device=self.device)
        relres, iters = 1.0, 0
        for i in range(max_passes):
            if i == 0:
                r32 = b64.to(torch.float32)
            else:
                _, r32, relres = self.residual(bound, b64, x64)
                if relres < rtol:
                    break
            # contract only as far as this pass needs (0.25x margin for the
            # f32 apply error), clamped to the f32 floor
            rtol_pass = float(np.clip(0.25 * rtol / relres, 1e-6, 3e-2))
            dx, info = cg_fn(S32, mg, r32, rtol_pass)
            iters += info.iters
            x64 = x64 + dx.to(torch.float64)
        else:
            # passes exhausted: re-measure for the x64 actually returned
            _, _, relres = self.residual(bound, b64, x64)
        return x64, relres, iters

    def solve(self, rtol: float = 1e-10, max_passes: int = 10):
        b64, K_cell_b, K_facet = self.assemble()
        bound = self.bind(K_cell_b, K_facet)
        S32 = self.probe(bound)
        mg = self.build_mg(S32)
        x64, relres, iters = self.refine(S32, mg, bound, b64, rtol,
                                         max_passes)
        return x64, {"rel_residual": relres, "cg_iters": iters}
