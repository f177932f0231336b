"""Unsteady incompressible Navier-Stokes, VMS/SUPS-stabilised equal-order
u-u-p (the VarMINT formulation) with immersed weak Dirichlet conditions
(port of ``iifea_tpu/models/navier_stokes.py``).

Weak form (the reference demo's interiorResidual and weakDirichletBC):

  ∫ [ ρ DuDt·v + σ(u,p):∇v + div(u) q
      − (u·∇v + ∇q/ρ)·u′ − p′ div(v)
      + v·(u′·∇u) − ∇v:(u′⊗u′)/ρ ] dx
  u′ = −τ_M r_M,  p′ = −τ_C r_C,  r_M = ρ DuDt − div σ,  r_C = ρ div u,
  τ_M = 1/sqrt(u·Gu + C_I ν² G:G + C_t/Δt² + ε),  τ_C = 1/(τ_M tr G),

  − ∫_Γ [σ(u,p)n·v + ρ min(u·n, 0)(u−g)·v]
  − sgn ∫_Γ σ(v, −sgn q)n·(u−g)   [+ C_pen μ sqrt(n·Gn)(u−g)·v if sym],

with the midpoint rule in time: velocity arguments u_mid = (u + u_old)/2,
the pressure current, u_t = (u − u_old)/Δt. The exact Taylor-Green fields
give the boundary data g(t) and the error norms.

The solution packs 3 scalar fields per node; the old state enters as the
aux field ``up_old`` and the time as ``params['t']``. Each kernel is
written for one element with its quadrature points batched; the assembly
engine vmaps it over elements and differentiates it with ``jacfwd``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.assembly import (
    Form,
    Term,
    build_cell_domain,
    build_facet_domain,
    integrate,
)

EPS = 2.220446049250313e-16  # DOLFIN_EPS, as in the reference's τ_M


def _decay(rate: float, t):
    """exp(−rate·t) for a float or tensor time."""
    if isinstance(t, torch.Tensor):
        return torch.exp(-rate * t)
    return math.exp(-rate * t)


def u_ic(x):
    """Taylor-Green initial velocity at points x (..., 2) -> (..., 2)."""
    return torch.stack([torch.sin(x[..., 0]) * torch.cos(x[..., 1]),
                        -torch.cos(x[..., 0]) * torch.sin(x[..., 1])], dim=-1)


def u_exact(x, nu, t):
    return _decay(2.0 * nu, t) * u_ic(x)


def p_exact(x, nu, rho, t):
    return rho * 0.25 * _decay(4.0 * nu, t) * (
        torch.cos(2 * x[..., 1]) + torch.cos(2 * x[..., 0]))


def grad_u_exact(x, nu, t):
    """∇u_exact at points x (..., 2): (..., 2, 2), [f, d] = ∂u_f/∂x_d."""
    e = _decay(2.0 * nu, t)
    s0, c0 = torch.sin(x[..., 0]), torch.cos(x[..., 0])
    s1, c1 = torch.sin(x[..., 1]), torch.cos(x[..., 1])
    return e * torch.stack([torch.stack([c0 * c1, -(s0 * s1)], dim=-1),
                            torch.stack([s0 * s1, -(c0 * c1)], dim=-1)],
                           dim=-2)


def grad_p_exact(x, nu, rho, t):
    """∇p_exact at points x (..., 2): (..., 2)."""
    a = rho * 0.25 * _decay(4.0 * nu, t)
    return torch.stack([a * (-torch.sin(2 * x[..., 0]) * 2),
                        a * (-torch.sin(2 * x[..., 1]) * 2)], dim=-1)


class TaylorGreenProblem:
    """Builds the VMS residual Form; params = {'t': t}, per step."""

    def __init__(self, mesh: Mesh, k: int = 1, Re: float = 100.0,
                 Dt: float = 0.1, G_scale: float | None = None,
                 C_I: float = 60.0, C_t: float = 4.0, C_pen: float = 10.0,
                 sym: bool = False, block_id: int = 2, surf_id: int = 3,
                 n_bg_dofs: int | None = None, boundary_facets=None,
                 dtype=np.float64, *, device="cuda"):
        self.device = torch.device(device)
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=3)
        self.rho = 1.0
        self.mu = 1.0 / Re
        self.nu = self.mu / self.rho
        self.Dt = float(Dt)
        self.sgn = 1.0 if sym else -1.0
        self.sym = bool(sym)
        self.C_I, self.C_t, self.C_pen = float(C_I), float(C_t), float(C_pen)
        # the cell metric G = 4 ave_h⁻² I with ave_h from the TOTAL
        # background dof count, as the reference does
        if G_scale is None:
            m = n_bg_dofs or self.space.n_dofs
            ave_h = m ** (-k / mesh.dim)
            G_scale = 4.0 * ave_h ** (-2)
        self.G_scale = float(G_scale)

        qd = 3 * k
        cells = np.where(mesh.material == block_id)[0]
        if boundary_facets is None:
            # the immersed interface (facet class 3); fitted meshes
            # (tg_unfitted) pass their exterior boundary facets instead
            fclass = mesh.classify_facets_by_material()
            boundary_facets = np.where(fclass == surf_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, qd, dtype,
                                          device=self.device,
                                          with_hessian=(k == 2))
        terms = [Term(self.cell_dom, self._cell_kernel())]
        self.facet_dom = None
        if len(boundary_facets):
            self.facet_dom = build_facet_domain(
                self.space, boundary_facets, qd, dtype, device=self.device,
                with_hessian=(k == 2))
            terms.append(Term(self.facet_dom, self._facet_kernel()))
        self.form = Form(self.space, terms)

    def _tau(self, u_mid):
        """(τ_M, τ_C) per point of u_mid (..., dim), G = G_scale·I."""
        G, nu, dim = self.G_scale, self.nu, self.mesh.dim
        denom2 = (G * (u_mid * u_mid).sum(-1)
                  + self.C_I * nu * nu * (G * G * dim)
                  + EPS + self.C_t / self.Dt ** 2)
        tau_M = 1.0 / torch.sqrt(denom2)
        tau_C = 1.0 / (tau_M * G * dim)
        return tau_M, tau_C

    def _cell_kernel(self):
        rho, mu, Dt = self.rho, self.mu, self.Dt

        def kern(u_loc, aux_loc, ctx, params):
            old = aux_loc["up_old"]
            phi, gphi = ctx.phi, ctx.gphi                 # (q, b), (q, b, d)
            Uc, Uo = phi @ u_loc, phi @ old               # (q, 3)
            gUc = torch.einsum("qbd,bf->qfd", gphi, u_loc)
            gUo = torch.einsum("qbd,bf->qfd", gphi, old)
            u = 0.5 * (Uc[:, :2] + Uo[:, :2])             # midpoint velocity
            gu = 0.5 * (gUc[:, :2] + gUo[:, :2])          # (q, f, d)
            p, gp = Uc[:, 2], gUc[:, 2]
            u_t = (Uc[:, :2] - Uo[:, :2]) / Dt

            tau_M, tau_C = self._tau(u)
            DuDt = u_t + torch.einsum("qfd,qd->qf", gu, u)     # u·∇u
            if ctx.hess is not None:
                Hc = torch.einsum("qbde,bf->qfde", ctx.hess, u_loc)
                Ho = torch.einsum("qbde,bf->qfde", ctx.hess, old)
                Hu = 0.5 * (Hc[:, :2] + Ho[:, :2])             # (q, f, d, e)
                lap_u = torch.einsum("qfdd->qf", Hu)
                # the reference's grad-div contraction: its einsum "dfd->f"
                # over Hu.transpose(1, 0, 2) sums Hu[f, d, d]
                grad_div = torch.einsum("qdfd->qf", Hu.transpose(1, 2))
                div_sig = mu * (lap_u + grad_div) - gp
            else:
                div_sig = -gp
            tr_gu = torch.einsum("qdd->q", gu)
            r_M = rho * DuDt - div_sig
            r_C = rho * tr_gu
            uP = -tau_M[:, None] * r_M
            pP = -tau_C * r_C

            eye = torch.eye(2, dtype=u_loc.dtype, device=u_loc.device)
            sig = (2.0 * mu * 0.5 * (gu + gu.transpose(1, 2))
                   - p[:, None, None] * eye)
            gphi_u = torch.einsum("qbd,qd->qb", gphi, u)
            gphi_uP = torch.einsum("qbd,qd->qb", gphi, uP)
            gu_uP = torch.einsum("qfd,qd->qf", gu, uP)
            # v = φ_b e_f (f < 2), q = φ_b e_2
            rv = (rho * torch.einsum("qb,qf->qbf", phi, DuDt)
                  + torch.einsum("qfd,qbd->qbf", sig, gphi)       # σ:∇v
                  - torch.einsum("qb,qf->qbf", gphi_u, uP)        # (u·∇v)·u′
                  - pP[:, None, None] * gphi                      # p′ div v
                  + torch.einsum("qb,qf->qbf", phi, gu_uP)        # v·(u′·∇u)
                  - torch.einsum("qbd,qf,qd->qbf", gphi, uP, uP) / rho)
            rq = tr_gu[:, None] * phi - gphi_uP / rho   # div(u) q − ∇q·u′/ρ
            r = torch.cat([rv, rq[..., None]], dim=-1)            # (q, b, 3)
            return torch.einsum("q,qbf->bf", ctx.w, r)

        return kern

    def _facet_kernel(self):
        rho, mu, nu = self.rho, self.mu, self.nu
        sgn, C_pen = self.sgn, self.C_pen
        penalize = self.sym      # the reference demo runs overPenalize=False
        G = self.G_scale

        def kern(u_loc, aux_loc, ctx, params):
            t = params["t"]
            old = aux_loc["up_old"]
            n, phi, gphi = ctx.n, ctx.phi, ctx.gphi
            Uc, Uo = phi @ u_loc, phi @ old
            gUc = torch.einsum("qbd,bf->qfd", gphi, u_loc)
            gUo = torch.einsum("qbd,bf->qfd", gphi, old)
            u = 0.5 * (Uc[:, :2] + Uo[:, :2])
            gu = 0.5 * (gUc[:, :2] + gUo[:, :2])
            p = Uc[:, 2]
            umg = u - u_exact(ctx.x, nu, t)

            eye = torch.eye(2, dtype=u_loc.dtype, device=u_loc.device)
            sig = (2.0 * mu * 0.5 * (gu + gu.transpose(1, 2))
                   - p[:, None, None] * eye)
            traction = sig @ n                                      # (q, 2)
            un = u @ n
            # torch.minimum, like jnp.minimum, splits a tie's derivative
            inflow = rho * torch.minimum(un, torch.zeros_like(un))
            gphin = gphi @ n                                        # (q, b)
            gphi_umg = torch.einsum("qbd,qd->qb", gphi, umg)
            n_umg = umg @ n
            # consistency −(σn·v + ρ min(u·n, 0)(u−g)·v); adjoint
            # consistency, viscous part −sgn μ[(∇φ·n) umg_f + (∇φ·umg) n_f]
            rv = (-torch.einsum("qb,qf->qbf", phi,
                                traction + inflow[:, None] * umg)
                  - sgn * mu * (torch.einsum("qb,qf->qbf", gphin, umg)
                                + torch.einsum("qb,f->qbf", gphi_umg, n)))
            if penalize:
                pen = C_pen * mu * torch.sqrt(G * (n @ n))
                rv = rv + pen * torch.einsum("qb,qf->qbf", phi, umg)
            # pressure test: −sgn·sgn q (n·umg) = −q (n·umg)
            rq = -n_umg[:, None] * phi
            r = torch.cat([rv, rq[..., None]], dim=-1)
            return torch.einsum("q,qbf->bf", ctx.w, r)

        return kern

    def error_norms(self, up_f: torch.Tensor, t) -> dict:
        """L2u, H1u, L2p, the mean-removed L2p0 and H1p over the block at
        time t."""
        nu, rho = self.nu, self.rho

        def vel_err(u_loc, aux_loc, ctx, params):
            uq = (ctx.phi @ u_loc)[:, :2]
            return torch.einsum("q,qf->", ctx.w,
                                (uq - u_exact(ctx.x, nu, t)) ** 2)

        def vel_grad_err(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)[:, :2, :]
            return torch.einsum("q,qfd->", ctx.w,
                                (gu - grad_u_exact(ctx.x, nu, t)) ** 2)

        def p_err(u_loc, aux_loc, ctx, params):
            pq = ctx.phi @ u_loc[:, 2]
            return torch.einsum("q,q->", ctx.w,
                                (pq - p_exact(ctx.x, nu, rho, t)) ** 2)

        def p_grad_err(u_loc, aux_loc, ctx, params):
            gp = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 2])
            return torch.einsum("q,qd->", ctx.w,
                                (gp - grad_p_exact(ctx.x, nu, rho, t)) ** 2)

        def p_diff(u_loc, aux_loc, ctx, params):
            pq = ctx.phi @ u_loc[:, 2]
            return torch.einsum("q,q->", ctx.w, pq - p_exact(ctx.x, nu, rho,
                                                            t))

        def vol(u_loc, aux_loc, ctx, params):
            return ctx.w.sum()

        # an enclosed flow fixes the discrete pressure only up to a
        # constant, which the raw L2p carries; L2p0 removes the mean of
        # (p − p_exact) over the block first
        cd = self.cell_dom
        pm = (integrate(cd, p_diff, up_f, n_fields=3)
              / integrate(cd, vol, up_f, n_fields=3))

        def p_err0(u_loc, aux_loc, ctx, params):
            pq = ctx.phi @ u_loc[:, 2]
            return torch.einsum(
                "q,q->", ctx.w, (pq - p_exact(ctx.x, nu, rho, t) - pm) ** 2)

        # cut-cell quadratures with negative weights can integrate the
        # squared mean-removed error slightly below 0 once it reaches their
        # noise floor: 0 then means "below the quadrature floor"
        nL2p0 = torch.clamp(integrate(cd, p_err0, up_f, n_fields=3), min=0.0)

        def norm(fn):
            return float(torch.sqrt(integrate(cd, fn, up_f, n_fields=3)))

        return {"L2u": norm(vel_err), "H1u": norm(vel_grad_err),
                "L2p": norm(p_err), "L2p0": float(torch.sqrt(nL2p0)),
                "H1p": norm(p_grad_err)}
