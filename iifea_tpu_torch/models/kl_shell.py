"""Geometrically nonlinear Kirchhoff-Love shell (St. Venant-Kirchhoff); port
of ``iifea_tpu/models/kl_shell.py``.

* midsurface map X = F(ξ), an analytic torch function of the parametric
  point (the bent tab F = [ξ0, ξ1, ½(1−ξ0²)], or the flat square);
* shell differential geometry from the first and second parametric
  derivatives of the deformed map: covariant bases, metric a, curvature b
  by the derivative of the unit normal, the local Cartesian frame by
  Gram-Schmidt, Voigt strains;
* SVK energy W = ½(ε̄·n̄ + κ̄·m̄) J_vol, n̄ = h D ε̄, m̄ = h³ D κ̄ / 12. The
  residual is ``torch.func.grad`` of the cell energy inside the element
  kernel, and ``Form``'s ``jacfwd`` of that kernel makes the Jacobian the
  energy Hessian by forward-over-reverse autodiff, as in the reference;
* a follower pressure load −P·t (a2 · v) (non-conservative) or a fixed
  areal load, and penalty pinning on an edge set.

The surface derivatives are ``torch.func.jacfwd`` of F, twice; the
displacement's second derivatives come from the P2 Hessian tables
(``build_cell_domain(with_hessian=True)``). The quadrature points of a
cell are vectorised (``vmap``). The 2 × 2 determinants and inverses are
written out in closed form and the small products as broadcast sums
(``_dot``, ``_mm``): under vmap and the tangents of jacfwd a ``@`` of
3-vectors becomes a batched GEMM launch, an elementwise product and sum
does not.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.assembly import (
    Form,
    Term,
    build_cell_domain,
    build_facet_domain,
)


def _dot(a, b):
    return (a * b).sum(-1)


def _mm(A, B):
    """A @ B for small matrices, as a broadcast sum."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def unit(v):
    return v / torch.sqrt(_dot(v, v))


def _det2(m):
    return m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]


def _inv2(m):
    adj = torch.stack([torch.stack([m[1, 1], -m[0, 1]]),
                       torch.stack([-m[1, 0], m[0, 0]])])
    return adj / _det2(m)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def shell_geometry(dx, ddx):
    """(a0, a1, a2, a, b) from the first and second parametric derivatives
    of the midsurface map. dx: (3, 2), columns the covariant bases; ddx:
    (3, 2, 2)."""
    a0, a1 = dx[:, 0], dx[:, 1]
    c = _cross(a0, a1)
    norm_c = torch.sqrt(_dot(c, c))
    a2 = c / norm_c
    a = _mm(dx.T, dx)
    # d a2 / d xi_beta by the quotient rule
    dc = torch.stack([_cross(ddx[:, 0, b], a1) + _cross(a0, ddx[:, 1, b])
                      for b in range(2)], dim=1)             # (3, 2)
    da2 = (dc - a2[:, None] * (a2[:, None] * dc).sum(0)) / norm_c
    b_mat = -_mm(dx.T, da2)
    return a0, a1, a2, a, b_mat


def cartesian(T, a, a0, a1):
    """Change of basis of a 2 × 2 tensor to the local Cartesian frame."""
    ac = _inv2(a)
    a0c = ac[0, 0] * a0 + ac[0, 1] * a1
    a1c = ac[1, 0] * a0 + ac[1, 1] * a1
    e0 = unit(a0)
    e1 = unit(a1 - e0 * _dot(a1, e0))
    ea = _mm(torch.stack([e0, e1]), torch.stack([a0c, a1c], dim=1))
    return _mm(_mm(ea, T), ea.T)


def voigt(T):
    return torch.stack([T[0, 0], T[1, 1], 2.0 * T[0, 1]])


class KLShellProblem:
    """Cut/pinned Kirchhoff-Love SVK shell on an immersed 2D parametric mesh.

    surface_fn: ξ (2,) -> X (3,), a torch function (the reference
    configuration). Residual params: {'t': load factor} for the follower
    pressure variant. Everything lives on ``device``.
    """

    def __init__(
        self,
        mesh: Mesh,
        surface_fn,
        E: float = 3e4,
        nu: float = 0.3,
        h_th: float = 0.03,
        pressure: float = 2.0,          # follower load magnitude
        areal_force: float | None = None,  # fixed vertical load instead
        pin_alpha: float = 1e5,
        pin_mode: str = "boundary",     # 'boundary' (cut) | 'interface' (pinned)
        pin_alpha_scale: str = "hmin",  # E/hmin (cut) | h_th*E/h_facet (pinned)
        use_jvol: bool = True,
        block_id: int = 2,
        dtype=np.float64,
        *,
        device="cuda",
    ):
        k = 2
        self.mesh = mesh
        self.space = FunctionSpace(mesh, degree=k, n_fields=3)
        self.E, self.nu, self.h_th = float(E), float(nu), float(h_th)
        self.pressure = float(pressure)
        self.areal_force = areal_force
        self.pin_alpha = float(pin_alpha)
        self.pin_mode = pin_mode
        self.pin_alpha_scale = pin_alpha_scale
        self.use_jvol = use_jvol
        self.surface_fn = surface_fn
        self.dX = jacfwd(surface_fn)
        self.ddX = jacfwd(self.dX)
        self.device = torch.device(device)
        tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
        self.D = (E / (1.0 - nu * nu)) * torch.tensor(
            [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]],
            dtype=tdt, device=self.device)
        self.hmin = mesh.hmin()

        qd = 2 * k
        cells = np.where(mesh.material == block_id)[0]
        self.cell_dom = build_cell_domain(self.space, cells, qd,
                                          with_hessian=True, dtype=dtype,
                                          device=self.device)
        terms = [Term(self.cell_dom, self._cell_kernel())]

        pin_facets = self._pin_facets()
        if len(pin_facets):
            self.pin_dom = build_facet_domain(self.space, pin_facets, qd,
                                              dtype=dtype, device=self.device)
            terms.append(Term(self.pin_dom, self._pin_kernel()))
        self.form = Form(self.space, terms)

    # -- facet selection -------------------------------------------------------

    def _pin_facets(self):
        mesh = self.mesh
        fd = mesh.facet_data
        if self.pin_mode == "interface":
            # the immersed boundary (facet class 3)
            return np.where(mesh.classify_facets_by_material() == 3)[0]
        # exterior facets with midpoint x = ±1
        bdry = fd.facet_cells[:, 1] < 0
        mid = mesh.coords[fd.facets].mean(axis=1)
        pinned = bdry & np.isclose(np.abs(mid[:, 0]), 1.0, atol=1e-6)
        return np.where(pinned)[0]

    # -- kernels ---------------------------------------------------------------

    def _reference(self, xi):
        """The reference surface at one quadrature point: its first and
        second parametric derivatives, its geometry (A0, A1, A2, A, B) and
        J_vol. It does not depend on the displacement, so the cell kernel
        forms it once, outside the differentiated energy."""
        dXq = self.dX(xi)          # (3, 2)
        ddXq = self.ddX(xi)        # (3, 2, 2)
        jvol = torch.sqrt(_det2(_mm(dXq.T, dXq)))
        return dXq, ddXq, shell_geometry(dXq, ddXq), jvol

    def _energy(self, ref_q, gu_q, hu_q):
        """SVK strain energy per unit reference area at one point, from the
        point's ``_reference``."""
        dXq, ddXq, (A0, A1, A2, A, B), jvol = ref_q
        a0, a1, a2, a, b = shell_geometry(dXq + gu_q, ddXq + hu_q)
        epsilon = 0.5 * (a - A)
        kappa = B - b
        eV = voigt(cartesian(epsilon, A, A0, A1))
        kV = voigt(cartesian(kappa, A, A0, A1))
        nBar = self.h_th * _dot(self.D, eV)
        mBar = (self.h_th ** 3) * _dot(self.D, kV) / 12.0
        W = 0.5 * (_dot(eV, nBar) + _dot(kV, mBar))
        return W * jvol if self.use_jvol else W

    def _cell_kernel(self):
        pressure = self.pressure
        areal = self.areal_force
        # fixed load f = (0, 0, areal)
        f = (None if areal is None else torch.tensor(
            [0.0, 0.0, areal], dtype=self.D.dtype, device=self.device))
        reference = vmap(self._reference)
        energy = vmap(self._energy)
        normal = vmap(lambda ref_q, gu_q, hu_q: shell_geometry(
            ref_q[0] + gu_q, ref_q[1] + hu_q)[2])

        def derivs(ctx, ul):
            """(nq, 3, 2) gradients and (nq, 3, 2, 2) Hessians of u."""
            gu = (ctx.gphi[:, :, None] * ul[None, :, :, None]).sum(1)
            hu = (ctx.hess[:, :, None] * ul[None, :, :, None, None]).sum(1)
            return gu, hu

        def kern(u_loc, aux_loc, ctx, params):
            ref = reference(ctx.x)

            def w_total(ul):
                return (ctx.w * energy(ref, *derivs(ctx, ul))).sum()

            r = grad(w_total)(u_loc)   # the internal energy's variation
            if areal is None:
                # follower pressure −P·t (a2·v)
                a2 = normal(ref, *derivs(ctx, u_loc))            # (nq, 3)
                wphi = (pressure * params["t"]) * ctx.w[:, None] * ctx.phi
                r = r - (wphi[:, :, None] * a2[:, None, :]).sum(0)
            else:
                # fixed load −f·v
                r = r - (ctx.w[:, None] * ctx.phi).sum(0)[:, None] * f
            return r

        return kern

    def _pin_kernel(self):
        alpha, E, h_th = self.pin_alpha, self.E, self.h_th
        hmin = self.hmin
        dX = vmap(self.dX)
        scale_mode = self.pin_alpha_scale
        use_jsurf = self.use_jvol

        def kern(u_loc, aux_loc, ctx, params):
            # penalty: scale · (u − u_pre)·v [J_surf] ds, u_pre = 0
            uq = (ctx.phi[:, :, None] * u_loc[None]).sum(1)       # (nq, 3)
            if scale_mode == "hmin":
                scale = alpha * E / hmin
            else:
                scale = alpha * h_th * E / ctx.h
            w = ctx.w
            if use_jsurf:
                dXq = dX(ctx.x)                                   # (nq, 3, 2)
                g = _mm(dXq.transpose(1, 2), dXq)
                det = g[:, 0, 0] * g[:, 1, 1] - g[:, 0, 1] * g[:, 1, 0]
                N = ctx.n
                # N·g⁻¹N by the adjugate
                ngn = (g[:, 1, 1] * N[0] * N[0] + g[:, 0, 0] * N[1] * N[1]
                       - (g[:, 0, 1] + g[:, 1, 0]) * N[0] * N[1]) / det
                w = w * torch.sqrt(det * ngn)                     # J_surf
            wphi = (w * scale)[:, None] * ctx.phi
            return (wphi[:, :, None] * uq[:, None, :]).sum(0)

        return kern

    # -- point evaluation (the demos' tracker points) --------------------------

    def evaluate(self, u_f: torch.Tensor, points) -> np.ndarray:
        from iifea_tpu_torch.mesh.generators import locate_cells

        mesh = self.mesh
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        cells = locate_cells(mesh, pts, tol=1e-9)
        out = np.zeros((len(pts), 3))
        u = u_f.detach().cpu().numpy().reshape(-1, 3)
        el = self.space.element
        cd = np.asarray(self.space.cell_dofs)
        for i, (p, c) in enumerate(zip(pts, cells)):
            if c < 0:
                out[i] = np.nan
                continue
            verts = mesh.cell_coords[c]
            J = (verts[1:] - verts[:1]).T
            ref = np.linalg.solve(J, p - verts[0])
            phi = el.tabulate(ref[None, :])[0]
            out[i] = phi @ u[cd[c]]
        return out
