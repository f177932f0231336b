"""Immersed Poisson with Nitsche boundary conditions (port of
``iifea_tpu/models/poisson.py`` for P1 simplices).

  cell:   ∫ ∇u·∇v dx − ∫ f v dx
  facet:  −∫_Γ (∇u·n) v dS + sgn ∫_Γ (g − u)(∇v·n) dS
          [+ β h⁻¹ ∫_Γ (u − g) v dS  if sym or over_penalize]

sgn = 1 for symmetric Nitsche, −1 for the nonsymmetric (penalty-free)
variant. By default u_exact = sin(π(x²+y²))·cos(π(x−y)) in 2D and
sin(π(x²+y²+z²))·cos(π(x+y+z)) in 3D, g = u_exact on Γ, and the source
f = −tr Hess u_exact through ``torch.func.hessian``; both can be given.
The element stiffness of the cell term and the right-hand side tables of
the lattice solver are computed in native f64 (the reference's
double-float emulation has no counterpart on the GPU).
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
)


def u_exact(x: torch.Tensor) -> torch.Tensor:
    """Manufactured solution at one point x (2,)."""
    return torch.sin(math.pi * (x[0] ** 2 + x[1] ** 2)) * torch.cos(
        math.pi * (x[0] - x[1])
    )


def u_exact3(x: torch.Tensor) -> torch.Tensor:
    """Manufactured solution at one point x (3,)."""
    return torch.sin(math.pi * (x[0] ** 2 + x[1] ** 2 + x[2] ** 2)) * (
        torch.cos(math.pi * (x[0] + x[1] + x[2]))
    )


def u_exact_fn(dim: int):
    return u_exact if dim == 2 else u_exact3


def source_fn(u_ex):
    """f = −div grad u_ex, by autodiff."""
    def f(x: torch.Tensor) -> torch.Tensor:
        return -torch.trace(hessian(u_ex)(x))

    return f


source = source_fn(u_exact)


def eval_points(fn, xqT: torch.Tensor) -> torch.Tensor:
    """(nq, dim, nE) points -> (nq, nE) values of a pointwise function."""
    nq, dim, nE = xqT.shape
    pts = xqT.permute(0, 2, 1).reshape(-1, dim)
    return vmap(fn)(pts).reshape(nq, nE)


def p1_stiffness_arrays(JinvT: torch.Tensor, wdetT: torch.Tensor,
                        gref: np.ndarray) -> torch.Tensor:
    """P1 cell stiffness K[a,b] = (Σ_q w_q)·Σ_d G[a,d]·G[b,d] with
    G = ∇φ_ref·J⁻¹ (constant on an affine element), in the dtype of the
    geometry. Trailing axes are the element axes: (nE,) or bound (L, nc)."""
    g0 = torch.as_tensor(gref[0], dtype=JinvT.dtype, device=JinvT.device)
    G = torch.tensordot(g0, JinvT, dims=([1], [0]))     # (nb, dim, ...)
    return (G[:, None] * G[None, :]).sum(2) * wdetT.sum(0)


class PoissonProblem:
    """The Nitsche-Poisson residual Form on the immersed block."""

    def __init__(self, mesh: Mesh, k: int = 1, sym: bool = True,
                 beta_value: float = 10.0, over_penalize: bool = False,
                 block_id: int = 2, surf_id: int = 3,
                 quad_degree: int | None = None, u_exact=None, f=None, *,
                 device="cuda"):
        """``u_exact``/``f``: pointwise functions of one point x (dim,) for
        the boundary data g and the source (default: the manufactured
        solution above and f = −Δu_exact)."""
        self.device = torch.device(device)
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=1)
        self.sym = bool(sym)
        self.sgn = 1.0 if self.sym else -1.0
        self.beta = float(beta_value)
        self.over_penalize = bool(over_penalize)
        self.u_ex = u_exact or u_exact_fn(mesh.dim)
        self.f = f or source_fn(self.u_ex)
        qd = k if quad_degree is None else quad_degree
        cells = np.where(mesh.material == block_id)[0]
        facets = np.where(mesh.classify_facets_by_material() == surf_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, qd,
                                          device=self.device)
        self.facet_dom = build_facet_domain(self.space, facets, qd,
                                            device=self.device)
        self.form = Form(self.space, [
            Term(self.cell_dom, self._cell_kernel()),
            Term(self.facet_dom, self._facet_kernel()),
        ])

    # -- element kernels ------------------------------------------------------

    def _cell_kernel(self):
        f = self.f

        def kern(u_loc, aux_loc, ctx, params):
            U = u_loc[:, 0]
            gu = torch.einsum("qbd,b->qd", ctx.gphi, U)
            fx = vmap(f)(ctx.x)
            r = torch.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
            r = r - torch.einsum("q,q,qb->b", ctx.w, fx, ctx.phi)
            return r[:, None]

        return kern

    def _facet_kernel(self):
        sgn, beta, u_ex = self.sgn, self.beta, self.u_ex
        penalize = self.over_penalize or self.sym

        def kern(u_loc, aux_loc, ctx, params):
            U = u_loc[:, 0]
            uq = torch.einsum("qb,b->q", ctx.phi, U)
            gu = torch.einsum("qbd,b->qd", ctx.gphi, U)
            gun = gu @ ctx.n
            gq = vmap(u_ex)(ctx.x)
            gphin = torch.einsum("qbd,d->qb", ctx.gphi, ctx.n)
            r = -torch.einsum("q,q,qb->b", ctx.w, gun, ctx.phi)
            r = r + sgn * torch.einsum("q,q,qb->b", ctx.w, gq - uq, gphin)
            if penalize:
                r = r + (beta / ctx.h) * torch.einsum(
                    "q,q,qb->b", ctx.w, uq - gq, ctx.phi
                )
            return r[:, None]

        return kern

    # -- right-hand side at u = 0 ---------------------------------------------

    def rhs_tables(self, reducers) -> dict:
        """Pointwise quadrature data of the rhs, bound into the reducers'
        slot layout (f64): w·f(x_q) on cells; w·g(x_q), ∇φ·n, φ and
        w·g·β/h on the boundary facets."""
        cd, fd = self.cell_dom, self.facet_dom
        red_c, red_f = reducers
        F = cd.wdetT * eval_points(self.f, cd.xqT)           # (nq, nE)
        Wg = fd.wT * eval_points(self.u_ex, fd.xqT)          # (nq, nF)
        gphin = torch.einsum("qbdF,dF->qbF", fd.gphiT, fd.normalT)
        penalize = self.sym or self.over_penalize
        return {
            "F": red_c.bind_static(F),
            "Wg": red_f.bind_static(Wg),
            "gphin": red_f.bind_static(gphin),
            "phiF": red_f.bind_static(fd.phiT),
            "Wg_h": (red_f.bind_static(Wg * (self.beta / fd.h)[None, :])
                     if penalize else None),
        }

    def rhs_el(self, tables) -> list[torch.Tensor]:
        """Bound element b-vectors (= −residual at u=0) per term, (nb, L, nc):

          cell:  b_el[a] = Σ_q F_q·φ[q,a]
          facet: b_el[a] = Σ_q −sgn·Wg_q·(∇φ_a·n)_q + (β h⁻¹ Wg)_q·φ[q,a]
        """
        F = tables["F"]
        phi_c = self.cell_dom.phi
        nq, nb = phi_c.shape
        cell = torch.stack([
            sum(F[q] * phi_c[q, a] for q in range(nq)) for a in range(nb)
        ])
        Wg, gphin, phiF = tables["Wg"], tables["gphin"], tables["phiF"]
        Wg_h = tables["Wg_h"]
        facet = []
        for a in range(gphin.shape[1]):
            acc = None
            for q in range(Wg.shape[0]):
                t = -((Wg[q] * gphin[q, a]) * self.sgn)
                if Wg_h is not None:
                    t = t + Wg_h[q] * phiF[q, a]
                acc = t if acc is None else acc + t
            facet.append(acc)
        return [cell, torch.stack(facet)]

    # -- error norms ----------------------------------------------------------

    def error_norms(self, u_f: torch.Tensor) -> dict:
        """Relative L2, H1-seminorm and Nitsche-H1 errors of a foreground
        field against u_exact."""
        u_ex = self.u_ex

        def e_sq(u_loc, aux_loc, ctx, params):
            eq = torch.einsum("qb,b->q", ctx.phi, u_loc[:, 0]) - vmap(
                u_ex)(ctx.x)
            return torch.einsum("q,q->", ctx.w, eq ** 2)

        def ge_sq(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
            ge = gu - vmap(grad(u_ex))(ctx.x)
            return torch.einsum("q,qd->", ctx.w, ge ** 2)

        def edge_sq(u_loc, aux_loc, ctx, params):
            return e_sq(u_loc, aux_loc, ctx, params) / ctx.h

        def exact_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,q->", ctx.w, vmap(u_ex)(ctx.x) ** 2)

        def gexact_sq(u_loc, aux_loc, ctx, params):
            g = vmap(grad(u_ex))(ctx.x)
            return torch.einsum("q,qd->", ctx.w, g ** 2)

        def edge_exact_sq(u_loc, aux_loc, ctx, params):
            return exact_sq(u_loc, aux_loc, ctx, params) / ctx.h

        cd, fd = self.cell_dom, self.facet_dom
        norm_L2 = integrate(cd, e_sq, u_f)
        norm_H10 = integrate(cd, ge_sq, u_f)
        norm_edge = integrate(fd, edge_sq, u_f)
        L2 = integrate(cd, exact_sq, u_f)
        H10 = integrate(cd, gexact_sq, u_f)
        edge = integrate(fd, edge_exact_sq, u_f)
        return {
            "L2": float(torch.sqrt(norm_L2) / torch.sqrt(L2)),
            "H10": float(torch.sqrt(norm_H10) / torch.sqrt(H10)),
            "H1": float(torch.sqrt(norm_L2 + norm_H10 + norm_edge)
                        / torch.sqrt(L2 + H10 + edge)),
        }


def select_coercive_beta(mesh, M, k: int = 1, beta0: float = 10.0,
                         max_doublings: int = 4, **prob_kw):
    """Smallest β in {β0·2^j} whose projected symmetric Nitsche operator is
    positive definite on supported dofs (zero rows excluded), checked by a
    shift-invert Lanczos on the explicit host export: the symmetric Nitsche
    form is coercive iff its projected matrix is SPD there. Demo sizes only.
    Returns (beta, prob), ``prob`` built at the selected β on M's device
    unless ``device`` is given."""
    import scipy.sparse.linalg as spla

    from iifea_tpu_torch.ops.projection import assemble_background_system

    prob_kw.setdefault("device", M.device)
    prob = None
    for j in range(max_doublings + 1):
        beta = beta0 * 2.0 ** j
        prob = PoissonProblem(mesh, k=k, sym=True, beta_value=beta,
                              **prob_kw)
        A, _ = assemble_background_system(
            prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                                   device=prob.device), M)
        A_sp = A.to_scipy().tocsr()
        d = np.abs(A_sp.diagonal())
        alive = np.where(d > 1e-12 * max(d.max(), 1e-300))[0]
        sub = A_sp[np.ix_(alive, alive)].tocsc()
        sub = 0.5 * (sub + sub.T)
        # shift-invert at a tiny negative shift: the marginal-coercivity
        # failure is eigenvalues just below zero, i.e. the smallest |λ|
        scale = float(d[alive].max())
        try:
            vals = spla.eigsh(
                sub, k=min(3, sub.shape[0] - 1), sigma=-1e-8 * scale,
                which="LM", maxiter=1000, return_eigenvectors=False,
            )
            lam = float(np.min(vals))
        except (RuntimeError, ValueError, spla.ArpackError):
            lam = -np.inf             # singular factor / no convergence
        if lam > 0:
            return beta, prob
    return beta, prob
