"""Immersed linear elasticity with Nitsche boundary conditions (port of the
synthetic part of ``iifea_tpu/models/elasticity.py``).

The vector workload on a lattice background: the same operator class as
the reference demo's Kirsch plate (a 2- or 3-field symmetric elliptic
system projected through M), posed on the generated immersed square or
cube with a manufactured solution, so the background is a known lattice
and ``solve_ksp(pc='mg', n_fields=dim)`` applies. Weak form (symmetric
Nitsche, sgn = 1; nonsymmetric sgn = −1):

  ∫ σ(u):∇v dx − ∫_Γ (σ(u)n)·v dS − sgn ∫_Γ (σ(v)n)·(u−g) dS
    + β h⁻¹ ∫_Γ (u−g)·v dS − ∫ f·v dx,

σ = 2μ ε + λ tr(ε) I, g = u_exact on Γ, f = −div σ(u_exact) by nested
``torch.func.jacfwd``, β = beta_value·(2μ + λ).

Not ported yet: ``ElasticityProblem`` (the Kirsch plate with a hole), which
reads the reference's mesh files (ROADMAP.md item 12e).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.assembly import (
    Form,
    Term,
    build_cell_domain,
    build_facet_domain,
    integrate,
)


def sigma_nd(lam: float, mu: float, dim: int):
    """σ(∇u) = 2μ ε + λ tr(ε) I with ε = sym(∇u); ∇u is (..., dim, dim)
    with ∇u[f, d] = ∂u_f/∂x_d."""

    def sigma(grad_u: torch.Tensor) -> torch.Tensor:
        eps = 0.5 * (grad_u + grad_u.transpose(-1, -2))
        tr = torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(dim, dtype=grad_u.dtype, device=grad_u.device)
        return 2.0 * mu * eps + lam * tr[..., None, None] * eye

    return sigma


def u_exact_elasticity(dim: int):
    """The smooth manufactured displacement at one point x (dim,)."""
    pi = math.pi
    if dim == 2:
        def u_ex(x):
            return torch.stack([
                torch.sin(pi * x[0]) * torch.cos(pi * x[1]),
                torch.cos(pi * x[0]) * torch.sin(pi * x[1]) * 0.5,
            ])
    else:
        def u_ex(x):
            return torch.stack([
                torch.sin(pi * x[0]) * torch.cos(pi * x[1]) * x[2],
                torch.cos(pi * x[0]) * torch.sin(pi * x[2]) * 0.5,
                torch.sin(pi * x[1]) * torch.cos(pi * x[2]) * 0.25,
            ])
    return u_ex


def body_force_of(u_ex, sigma):
    """f = −div σ(u_ex) at one point, by nested forward-mode autodiff."""

    def sig_at(x):
        return sigma(jacfwd(u_ex)(x))

    def f(x):
        J = jacfwd(sig_at)(x)              # J[i, j, d] = ∂σ_ij/∂x_d
        return -torch.einsum("ijj->i", J)

    return f


class ImmersedElasticityProblem:
    """Vector elasticity on the immersed block (cells of material
    ``block_id``) with full-vector Nitsche Dirichlet conditions on the
    facets of class ``surf_id`` and a manufactured solution."""

    def __init__(self, mesh: Mesh, k: int = 1, E: float = 1.0,
                 nu: float = 0.3, sym: bool = True, beta_value: float = 20.0,
                 block_id: int = 2, surf_id: int = 3, u_exact=None, *,
                 device="cuda"):
        self.device = torch.device(device)
        dim = mesh.dim
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=dim)
        lam = (E * nu) / ((1 + nu) * (1 - 2 * nu))
        mu = E / (2 * (1 + nu))
        self.lam, self.mu = lam, mu
        self.sgn = 1.0 if sym else -1.0
        # coercivity needs β ≳ C·(2μ+λ): scale the user constant by it
        self.beta = float(beta_value) * (2 * mu + lam)
        self.sigma = sigma_nd(lam, mu, dim)
        self.u_ex = u_exact or u_exact_elasticity(dim)
        self.f = body_force_of(self.u_ex, self.sigma)

        cells = np.where(mesh.material == block_id)[0]
        facets = np.where(mesh.classify_facets_by_material() == surf_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, k,
                                          device=self.device)
        self.facet_dom = build_facet_domain(self.space, facets, k,
                                            device=self.device)
        self.form = Form(self.space, [
            Term(self.cell_dom, self._cell_kernel()),
            Term(self.facet_dom, self._nitsche_kernel()),
        ])

    def _cell_kernel(self):
        sigma, f = self.sigma, self.f

        def kern(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            r = torch.einsum("q,qfd,qbd->bf", ctx.w, sigma(gu), ctx.gphi)
            fx = vmap(f)(ctx.x)                                  # (nq, dim)
            return r - torch.einsum("q,qf,qb->bf", ctx.w, fx, ctx.phi)

        return kern

    def _nitsche_kernel(self):
        sigma, sgn, beta = self.sigma, self.sgn, self.beta
        lam, mu, u_ex = self.lam, self.mu, self.u_ex

        def kern(u_loc, aux_loc, ctx, params):
            n, w = ctx.n, ctx.w
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            tr_u = torch.einsum("qid,d->qi", sigma(gu), n)       # σ(u)n
            uq = torch.einsum("qb,bf->qf", ctx.phi, u_loc)
            e = uq - vmap(u_ex)(ctx.x)                           # u − g
            # (σ(v)n)·e for v = φ_b e_f:
            #   μ[(∇φ_b·n) e_f + (∇φ_b·e) n_f] + λ (∇φ_b)_f (n·e)
            gphin = torch.einsum("qbd,d->qb", ctx.gphi, n)
            gphie = torch.einsum("qbd,qd->qb", ctx.gphi, e)
            ne = torch.einsum("d,qd->q", n, e)
            sigv_e = (mu * (torch.einsum("qb,qf->qbf", gphin, e)
                            + torch.einsum("qb,f->qbf", gphie, n))
                      + lam * torch.einsum("qbf,q->qbf", ctx.gphi, ne))
            r = -torch.einsum("q,qf,qb->bf", w, tr_u, ctx.phi)
            r = r - sgn * torch.einsum("q,qbf->bf", w, sigv_e)
            return r + (beta / ctx.h) * torch.einsum("q,qf,qb->bf", w, e,
                                                     ctx.phi)

        return kern

    def error_norms(self, u_f: torch.Tensor) -> dict:
        """Relative L2 and H1-seminorm errors of a foreground displacement
        against u_exact over the block."""
        u_ex = self.u_ex
        ju_ex = jacfwd(u_ex)

        def e_sq(u_loc, aux_loc, ctx, params):
            eq = torch.einsum("qb,bf->qf", ctx.phi, u_loc) - vmap(u_ex)(ctx.x)
            return torch.einsum("q,qf->", ctx.w, eq ** 2)

        def ge_sq(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            ge = gu - vmap(ju_ex)(ctx.x)
            return torch.einsum("q,qfd->", ctx.w, ge ** 2)

        def ex_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,qf->", ctx.w, vmap(u_ex)(ctx.x) ** 2)

        def gex_sq(u_loc, aux_loc, ctx, params):
            return torch.einsum("q,qfd->", ctx.w, vmap(ju_ex)(ctx.x) ** 2)

        cd, nf = self.cell_dom, self.space.n_fields
        nL2, nH10, L2, H10 = (integrate(cd, fn, u_f, n_fields=nf)
                              for fn in (e_sq, ge_sq, ex_sq, gex_sq))
        return {"L2": float(torch.sqrt(nL2 / L2)),
                "H10": float(torch.sqrt(nH10 / H10))}
