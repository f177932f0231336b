"""Linear elasticity with Nitsche boundary conditions (port of
``iifea_tpu/models/elasticity.py``): the reference demo's Kirsch plate and
the synthetic immersed workload.

**The Kirsch plate** (``ElasticityProblem``, ``demos/linear_elasticity.py``
on the reference's mesh files): a quarter plate [0, 4]² with a hole of
radius 1, uniaxial stress sig_inf at infinity, P1 or P2 foreground,

  ∫_plate σ(u) : ∇v dx − ∫_{top, right} (σ_exact n)·v dS
    − sgn ∫_{left, bottom} (σ(v)n·n)(u·n) dS − ∫ (σ(u)n·n)(v·n) dS
    + β h⁻¹ ∫_{left, bottom} (u·n)(v·n) dS,   β = 10 μ,

the traction from the exact Kirsch stress, normal-direction Nitsche on the
symmetry edges. Kept from the reference as they are (they are its
results): σ = 2μ ε + K tr(ε) I with the bulk modulus K in place of λ (the
demo calls ``problem(u, K, mu)``), μ = 3/2 (K − λ) with λ = Eν/((1+ν)(1−ν)),
the +1e-4 regularisation of 1/r and ``arctan(y/x)`` (not ``arctan2``) in the
exact fields, and the midpoint tolerance 1e-12 of the facet classifier.

**The synthetic workload** (``ImmersedElasticityProblem``): the vector
problem on a lattice background, the same operator class (a 2- or 3-field
symmetric elliptic system projected through M) posed on the generated
immersed square or cube with a manufactured solution, so the background is
a known lattice and ``solve_ksp(pc='mg', n_fields=dim)`` applies. Weak form
(symmetric Nitsche, sgn = 1; nonsymmetric sgn = −1):

  ∫ σ(u):∇v dx − ∫_Γ (σ(u)n)·v dS − sgn ∫_Γ (σ(v)n)·(u−g) dS
    + β h⁻¹ ∫_Γ (u−g)·v dS − ∫ f·v dx,

σ = 2μ ε + λ tr(ε) I, g = u_exact on Γ, f = −div σ(u_exact) by nested
``torch.func.jacfwd``, β = beta_value·(2μ + λ).
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


HOLE_ID, PLATE_ID, RIM_ID = 1, 2, 3
LEFT_ID, BOTTOM_ID, TOP_ID, RIGHT_ID = 5, 6, 7, 8


def classify_elasticity_facets(mesh: Mesh,
                               plate_extent: float = 4.0) -> np.ndarray:
    """The reference demo's signed facet classes: marker = sum of the two
    cells' materials on an interior facet, −material on a boundary one;
    4 -> PLATE_ID, 2 or −1 -> HOLE_ID, 3 -> RIM_ID; the plate's boundary
    facets (−2) go by midpoint to LEFT/BOTTOM/TOP/RIGHT_ID (x = 0, y = 0,
    y = plate_extent, x = plate_extent, within 1e-12)."""
    fd = mesh.facet_data
    c0, c1 = fd.facet_cells[:, 0], fd.facet_cells[:, 1]
    m0 = mesh.material[c0]
    has2 = c1 >= 0
    m1 = np.where(has2, mesh.material[np.maximum(c1, 0)], 0)
    marker = np.where(has2, m0 + m1, -m0)

    out = np.zeros(mesh.num_facets, dtype=np.int32)
    out[marker == 4] = PLATE_ID
    out[(marker == 2) | (marker == -1)] = HOLE_ID
    out[marker == 3] = RIM_ID
    bdry = marker == -2
    mid = mesh.coords[fd.facets].mean(axis=1)
    tol = 1e-12
    out[bdry & (np.abs(mid[:, 0]) < tol)] = LEFT_ID
    out[bdry & (np.abs(mid[:, 1]) < tol)] = BOTTOM_ID
    out[bdry & (np.abs(mid[:, 1] - plate_extent) < tol)] = TOP_ID
    out[bdry & (np.abs(mid[:, 0] - plate_extent) < tol)] = RIGHT_ID
    return out


def kirsch_exact(R: float, sig_inf: float, E: float, nu: float,
                 x_origin: float = 0.0, y_origin: float = 0.0):
    """The analytic Kirsch fields at one point x (2,): returns
    fields(x) -> (σ (2, 2), ε (2, 2), u (2,)) in Cartesian components,
    with the reference's +1e-4 regularisation of 1/r and θ = arctan(y/x)."""
    tol = 0.0001

    def fields(x):
        xs = x[0] - x_origin
        ys = x[1] - y_origin
        r = torch.sqrt(xs * xs + ys * ys)
        theta = torch.arctan(ys / xs)
        sig_rr = sig_inf * (1 - (R / (r + tol)) ** 2)
        sig_tt = sig_inf * (1 + (R / (r + tol)) ** 2)
        zero = torch.zeros_like(r)
        sig_polar = torch.stack([torch.stack([sig_rr, zero]),
                                 torch.stack([zero, sig_tt])])
        c, s = torch.cos(theta), torch.sin(theta)
        Q = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        sig_cart = Q @ sig_polar @ Q.T
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        eps_cart = (1 / E) * ((1 + nu) * sig_cart
                              - nu * torch.trace(sig_cart) * eye)
        C1 = (1 + nu) * (1 - 2 * nu) * sig_inf / E
        C2 = (1 + nu) * R * R * sig_inf / E
        u_r = C1 * r + C2 / r
        u_cart = Q @ torch.stack([u_r, zero])
        return sig_cart, eps_cart, u_cart

    return fields


def sigma_of(K_bulk: float, mu: float):
    """σ(∇u) = 2μ sym(∇u) + K tr(ε) I, the reference demo's law as it calls
    it; ∇u is (..., 2, 2)."""
    return sigma_nd(K_bulk, mu, 2)


class ElasticityProblem:
    """The Kirsch plate: cells of material PLATE_ID, the exact traction on
    the TOP/RIGHT facets, normal-direction Nitsche on LEFT/BOTTOM."""

    def __init__(self, mesh: Mesh, k: int = 1, E: float = 200e9,
                 nu: float = 0.3, sym: bool = True, hole_radius: float = 1.0,
                 sig_inf: float = 1e6, plate_extent: float = 4.0, *,
                 device="cuda"):
        self.device = torch.device(device)
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=2)
        # the reference demo's constants
        lam = (E * nu) / ((1 + nu) * (1 - nu))
        K_bulk = E / (3 * (1 - 2 * nu))
        mu = (3 / 2) * (K_bulk - lam)
        self.K_bulk, self.mu = K_bulk, mu
        self.sgn = 1.0 if sym else -1.0
        self.beta = 10.0 * mu
        self.sigma = sigma_of(K_bulk, mu)
        self.exact = kirsch_exact(hole_radius, sig_inf, E, nu)

        fclass = classify_elasticity_facets(mesh, plate_extent)
        cells = np.where(mesh.material == PLATE_ID)[0]
        self.cell_dom = build_cell_domain(self.space, cells, k,
                                          device=self.device)

        def dom(mask):
            return build_facet_domain(self.space, np.where(mask)[0], k,
                                      device=self.device)

        self.neumann_dom = dom((fclass == TOP_ID) | (fclass == RIGHT_ID))
        self.sym_dom = dom((fclass == LEFT_ID) | (fclass == BOTTOM_ID))
        self.form = Form(self.space, [
            Term(self.cell_dom, self._cell_kernel()),
            Term(self.neumann_dom, self._traction_kernel()),
            Term(self.sym_dom, self._nitsche_kernel()),
        ])

    def _exact_stress(self, x: torch.Tensor) -> torch.Tensor:
        """σ_exact at the (nq, 2) points x: (nq, 2, 2)."""
        exact = self.exact
        return vmap(lambda p: exact(p)[0])(x)

    def _cell_kernel(self):
        sigma = self.sigma

        def kern(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            # r[b, f] = Σ_q w σ[f, d] ∂_d φ_b
            return torch.einsum("q,qfd,qbd->bf", ctx.w, sigma(gu), ctx.gphi)

        return kern

    def _traction_kernel(self):
        stress = self._exact_stress

        def kern(u_loc, aux_loc, ctx, params):
            tr = torch.einsum("qfd,d->qf", stress(ctx.x), ctx.n)
            # the residual holds −L_h: the traction enters negatively
            return -torch.einsum("q,qf,qb->bf", ctx.w, tr, ctx.phi)

        return kern

    def _nitsche_kernel(self):
        sigma, sgn, beta = self.sigma, self.sgn, self.beta
        K_bulk, mu = self.K_bulk, self.mu

        def kern(u_loc, aux_loc, ctx, params):
            n, w = ctx.n, ctx.w
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            sigu_nn = torch.einsum("qfd,f,d->q", sigma(gu), n, n)
            un = torch.einsum("qb,bf,f->q", ctx.phi, u_loc, n)      # u·n
            phin = torch.einsum("qb,f->qbf", ctx.phi, n)          # v·n
            # σ(v)n·n for v = φ_b e_f: 2μ (∇φ_b·n) n_f + K ∂_f φ_b
            gphin = torch.einsum("qbd,d->qb", ctx.gphi, n)
            sigv_nn = (2 * mu * torch.einsum("qb,f->qbf", gphin, n)
                       + K_bulk * ctx.gphi)
            r = -sgn * torch.einsum("q,qbf,q->bf", w, sigv_nn, un)
            r = r - torch.einsum("q,q,qbf->bf", w, sigu_nn, phin)
            return r + (beta / ctx.h) * torch.einsum("q,q,qbf->bf", w, un,
                                                     phin)

        return kern

    def stress_error_norm(self, u_f: torch.Tensor) -> float:
        """‖σ(u_f) − σ_exact‖ / ‖σ_exact‖ in L2 over the plate."""
        sigma, stress = self.sigma, self._exact_stress

        def err(u_loc, aux_loc, ctx, params):
            gu = torch.einsum("qbd,bf->qfd", ctx.gphi, u_loc)
            e = sigma(gu) - stress(ctx.x)
            return torch.einsum("q,qfd->", ctx.w, e * e)

        def ref(u_loc, aux_loc, ctx, params):
            sig_ex = stress(ctx.x)
            return torch.einsum("q,qfd->", ctx.w, sig_ex * sig_ex)

        num = integrate(self.cell_dom, err, u_f, n_fields=2)
        den = integrate(self.cell_dom, ref, u_f, n_fields=2)
        return float(torch.sqrt(num / den))


# -- the synthetic immersed workload (manufactured solution) ----------------


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
