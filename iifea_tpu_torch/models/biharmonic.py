"""2D/3D biharmonic problem with Nitsche boundary conditions (port of
``iifea_tpu/models/biharmonic.py``), on P2 spaces:

  A(u,v) = ∫ Δu Δv dx
         − ∫ Δu⁺ (∇v⁺·n⁺) dS + ∫ (∇(Δu⁺)·n⁺) v⁺ dS
         + sgn ∫ (∇(Δv⁺)·n⁺) u⁺ dS − sgn ∫ Δv⁺ (∇u⁺·n⁺) dS
         + β h⁻¹ ∫ (∇u⁺·n⁺)(∇v⁺·n⁺) dS + α h⁻³ ∫ u⁺ v⁺ dS
  b(v)   = ∫ f v dx + (the same adjoint and penalty terms with u → u_exact)

Third derivatives of degree-2 elements on affine simplices vanish, so the
∇(Δ·) terms are exactly zero and are omitted, as in the reference. The
default is the nonsymmetric variant (sgn = −1); f = Δ²u_exact comes from
nested ``torch.func.hessian`` in the problem's dtype (f64). Cells smaller
than ``filter_tol``·hmax^dim leave the block and the surface
(``Mesh.filter_small_cells``). The domains carry the basis Laplacians only
(``with_hessian="lap"``), all the kernels read.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.assembly import (
    Form,
    Term,
    build_cell_domain,
    build_facet_domain,
    integrate,
    lap_phi,
)


def u_exact_fn(dim: int):
    """The reference's manufactured solutions: a nearly flat cosine in 2D,
    a wavelength-2 one in 3D."""
    if dim == 2:
        def u_ex(x):
            return (torch.cos(0.05 * math.pi * x[0] + 0.1)
                    * torch.cos(0.05 * math.pi * x[1] + 0.1))
    else:
        def u_ex(x):
            return (torch.cos(math.pi * x[0] + 0.5)
                    * torch.cos(math.pi * x[1] + 0.5)
                    * torch.cos(math.pi * x[2] + 0.5))
    return u_ex


def lap_fn(f):
    """x ↦ Δf(x) by autodiff."""
    return lambda x: torch.trace(hessian(f)(x))


class BiharmonicProblem:
    """The Nitsche-biharmonic residual Form on the immersed block (k = 2)."""

    def __init__(self, mesh: Mesh, sym: bool = False, beta_value: float = 5.0,
                 alpha_value: float = 5.0, filter_tol: float = 1e-5,
                 block_id: int = 2, surf_id: int = 3, u_exact=None,
                 dtype=np.float64, *, device="cuda"):
        k = 2
        self.device = torch.device(device)
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=1)
        self.sgn = 1.0 if sym else -1.0
        self.beta = float(beta_value)
        self.alpha = float(alpha_value)
        self.u_ex = u_exact or u_exact_fn(mesh.dim)
        self.lap_u_ex = lap_fn(self.u_ex)
        self.f = lap_fn(self.lap_u_ex)

        fclass = mesh.classify_facets_by_material()
        material, fclass, n_cell_elim, n_facet_elim = mesh.filter_small_cells(
            filter_tol, block_id, fclass, surf_id)
        self.elim_counts = (n_cell_elim, n_facet_elim)
        cells = np.where(material == block_id)[0]
        facets = np.where(fclass == surf_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, k, dtype,
                                          device=self.device,
                                          with_hessian="lap")
        self.facet_dom = build_facet_domain(self.space, facets, k, dtype,
                                            device=self.device,
                                            with_hessian="lap")
        self.form = Form(self.space, [
            Term(self.cell_dom, self._cell_kernel()),
            Term(self.facet_dom, self._facet_kernel()),
        ])

    def _cell_kernel(self):
        f = self.f

        def kern(u_loc, aux_loc, ctx, params):
            lphi = lap_phi(ctx)
            lap_u = lphi @ u_loc[:, 0]
            r = torch.einsum("q,q,qb->b", ctx.w, lap_u, lphi)
            r = r - torch.einsum("q,q,qb->b", ctx.w, vmap(f)(ctx.x), ctx.phi)
            return r[:, None]

        return kern

    def _facet_kernel(self):
        u_ex = self.u_ex
        sgn, beta, alpha = self.sgn, self.beta, self.alpha
        grad_u_ex = grad(u_ex)

        def kern(u_loc, aux_loc, ctx, params):
            U = u_loc[:, 0]
            lphi = lap_phi(ctx)
            gphin = torch.einsum("qbd,d->qb", ctx.gphi, ctx.n)
            uq = ctx.phi @ U
            lap_u = lphi @ U
            gun = gphin @ U
            gq = vmap(u_ex)(ctx.x)
            ggn = vmap(grad_u_ex)(ctx.x) @ ctx.n
            w, h = ctx.w, ctx.h
            # − ∫ Δu (∇v·n)
            r = -torch.einsum("q,q,qb->b", w, lap_u, gphin)
            # − sgn ∫ Δv (∇u·n − ∇g·n)
            r = r - sgn * torch.einsum("q,q,qb->b", w, gun - ggn, lphi)
            # + β h⁻¹ ∫ (∇u·n − ∇g·n)(∇v·n)
            r = r + (beta / h) * torch.einsum("q,q,qb->b", w, gun - ggn,
                                              gphin)
            # + α h⁻³ ∫ (u − g) v
            r = r + (alpha / h ** 3) * torch.einsum("q,q,qb->b", w, uq - gq,
                                                    ctx.phi)
            return r[:, None]

        return kern

    def error_norms(self, u_f: torch.Tensor) -> dict:
        """L2, H1 and H2 errors of a foreground field against u_exact,
        absolute and relative; H1 adds the facet term ∫ e²/h, H2 the
        Laplacian's."""
        u_ex, lap_u_ex = self.u_ex, self.lap_u_ex
        grad_u_ex = grad(u_ex)

        def e_sq(u_loc, aux_loc, ctx, params):
            e = ctx.phi @ u_loc[:, 0] - vmap(u_ex)(ctx.x)
            return torch.einsum("q,q->", ctx.w, e ** 2)

        def ge_sq(u_loc, aux_loc, ctx, params):
            ge = (torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
                  - vmap(grad_u_ex)(ctx.x))
            return torch.einsum("q,qd->", ctx.w, ge ** 2)

        def edge_sq(u_loc, aux_loc, ctx, params):
            return e_sq(u_loc, aux_loc, ctx, params) / ctx.h

        def lap_e_sq(u_loc, aux_loc, ctx, params):
            e = lap_phi(ctx) @ u_loc[:, 0] - vmap(lap_u_ex)(ctx.x)
            return torch.einsum("q,q->", ctx.w, e ** 2)

        def ex_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,q->", ctx.w, vmap(u_ex)(ctx.x) ** 2)

        def gex_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,qd->", ctx.w,
                                vmap(grad_u_ex)(ctx.x) ** 2)

        def edge_ex_sq(u_loc, aux_loc, ctx, params):
            return ex_sq(u_loc, aux_loc, ctx, params) / ctx.h

        def lap_ex_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,q->", ctx.w,
                                vmap(lap_u_ex)(ctx.x) ** 2)

        cd, fd = self.cell_dom, self.facet_dom
        nL2 = integrate(cd, e_sq, u_f)
        nH1 = nL2 + integrate(cd, ge_sq, u_f) + integrate(fd, edge_sq, u_f)
        nH2 = nH1 + integrate(cd, lap_e_sq, u_f)
        L2 = integrate(cd, ex_sq, u_f)
        H1 = L2 + integrate(cd, gex_sq, u_f) + integrate(fd, edge_ex_sq, u_f)
        H2 = H1 + integrate(cd, lap_ex_sq, u_f)
        return {
            "L2": float(torch.sqrt(nL2)),
            "H1": float(torch.sqrt(nH1)),
            "H2": float(torch.sqrt(nH2)),
            "L2_rel": float(torch.sqrt(nL2) / torch.sqrt(L2)),
            "H1_rel": float(torch.sqrt(nH1) / torch.sqrt(H1)),
            "H2_rel": float(torch.sqrt(nH2) / torch.sqrt(H2)),
        }
