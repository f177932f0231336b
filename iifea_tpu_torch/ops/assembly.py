"""Batched element assembly engine (port of ``iifea_tpu/ops/assembly.py``
for P1 and P2 simplices).

Domains are built in numpy on the host and hold their data as tensors on
``device`` with the element axis last ("struct of planes", as in the
reference). A kernel is written for ONE element,

    kernel(u_loc, aux_loc, ctx, params) -> r_loc (nb, n_fields),

with u_loc (nb, n_fields) the local dofs, aux_loc {name: (nb, n_fields)}
extra discrete fields gathered like u, ctx the element's CellCtx/FacetCtx
and params anything the kernel closes over (not batched). It is batched
with ``torch.func.vmap`` over the trailing element axis; element Jacobians
come from ``torch.func.jacfwd`` of the kernel, in element chunks of
JAC_CHUNK.

Residuals and the foreground operator applications scatter element
vectors with ``index_add_``: on CUDA the order in which several elements
add onto one dof is not fixed, so f64 results may differ in the last bits
from run to run. Not ported: Hessian tabulation (P2 and the biharmonic
model, later slices).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from iifea_tpu_torch.mesh.core import FunctionSpace, flat_dofs
from iifea_tpu_torch.ops import quadrature
from iifea_tpu_torch.ops.reference_elements import local_facets

# elements per vmap(jacfwd) batch: bounds the tangent-batched temporaries
JAC_CHUNK = 262144


class CellCtx(NamedTuple):
    phi: torch.Tensor     # (nq, nb)
    gphi: torch.Tensor    # (nq, nb, dim) physical
    w: torch.Tensor       # (nq,) = wq·|detJ|
    x: torch.Tensor       # (nq, dim) physical quadrature points
    h: torch.Tensor       # () cell diameter
    hess: torch.Tensor | None = None   # (nq, nb, dim, dim) physical
    lap: torch.Tensor | None = None    # (nq, nb) basis Laplacians


class FacetCtx(NamedTuple):
    phi: torch.Tensor
    gphi: torch.Tensor
    w: torch.Tensor
    x: torch.Tensor
    h: torch.Tensor       # () '+' cell diameter
    n: torch.Tensor       # (dim,) outward unit normal of the '+' cell
    hess: torch.Tensor | None = None
    lap: torch.Tensor | None = None


def lap_phi(ctx) -> torch.Tensor:
    """Basis Laplacian (nq, nb): the precomputed plane when the domain has
    one, else the trace of the full physical Hessian."""
    if ctx.lap is not None:
        return ctx.lap
    return torch.einsum("qbdd->qb", ctx.hess)


def _ctx_dims(ctx):
    """vmap's in_dims for a context: the trailing element axis of each
    tensor, None for an absent (None) field."""
    return type(ctx)(*(None if v is None else -1 for v in ctx))


def _hess_mode(with_hessian) -> str | None:
    if with_hessian not in (False, True, "lap"):
        raise ValueError(f"with_hessian must be False, True or 'lap', got "
                         f"{with_hessian!r}")
    return None if with_hessian is False else (
        "lap" if with_hessian == "lap" else "full")


@dataclasses.dataclass
class CellDomain:
    """Integration domain over a set of cells (element axis last)."""

    eldofsT: torch.Tensor     # (ne, nE) int64 dof ids
    JinvT: torch.Tensor       # (dim, dim, nE)
    wdetT: torch.Tensor       # (nq, nE)
    xqT: torch.Tensor         # (nq, dim, nE)
    h: torch.Tensor           # (nE,)
    phi: torch.Tensor         # (nq, nb)
    gphi_ref: torch.Tensor    # (nq, nb, dim)
    flat_eldofs_np: np.ndarray  # (nE, ne) host copy of the dof ids
    hess_ref: torch.Tensor | None = None   # (nq, nb, dim, dim)
    hess_mode: str | None = None           # None, "full" or "lap"

    @property
    def n_elem(self) -> int:
        return self.wdetT.shape[-1]

    def ctx(self, sl: slice = slice(None)) -> CellCtx:
        """Context with a trailing element axis for elements ``sl``."""
        JinvT = self.JinvT[..., sl]
        wdetT = self.wdetT[..., sl]
        gphi = torch.einsum("qbd,deE->qbeE", self.gphi_ref, JinvT)
        phi = self.phi[..., None].expand(*self.phi.shape, wdetT.shape[-1])
        hess = lap = None
        if self.hess_mode == "lap":
            # tr(Jinvᵀ Href Jinv) = Href : (Jinv Jinvᵀ) on an affine cell
            G = torch.einsum("dcE,ecE->deE", JinvT, JinvT)
            lap = torch.einsum("qbde,deE->qbE", self.hess_ref, G)
        elif self.hess_mode == "full":
            hess = torch.einsum("dcE,qbde,efE->qbcfE", JinvT, self.hess_ref,
                                JinvT)
        return CellCtx(phi, gphi, wdetT, self.xqT[..., sl], self.h[sl],
                       hess, lap)


@dataclasses.dataclass
class FacetDomain:
    """One-sided ('+') integration domain over a set of facets."""

    eldofsT: torch.Tensor     # (ne, nF) '+' cell dof ids
    phiT: torch.Tensor        # (nq, nb, nF)
    gphiT: torch.Tensor       # (nq, nb, dim, nF) physical gradients
    wT: torch.Tensor          # (nq, nF) = wq·facet measure
    xqT: torch.Tensor         # (nq, dim, nF)
    h: torch.Tensor           # (nF,) '+' cell diameter
    normalT: torch.Tensor     # (dim, nF)
    flat_eldofs_np: np.ndarray
    # (nq, nb, dim, dim, nF) physical Hessians ("full"), (nq, nb, nF)
    # Laplacians ("lap"), or None
    hessT: torch.Tensor | None = None
    hess_mode: str | None = None

    @property
    def n_elem(self) -> int:
        return self.wT.shape[-1]

    def ctx(self, sl: slice = slice(None)) -> FacetCtx:
        second = None if self.hessT is None else self.hessT[..., sl]
        return FacetCtx(self.phiT[..., sl], self.gphiT[..., sl],
                        self.wT[..., sl], self.xqT[..., sl], self.h[sl],
                        self.normalT[..., sl],
                        second if self.hess_mode == "full" else None,
                        second if self.hess_mode == "lap" else None)


def _soa(a: np.ndarray, dtype, device) -> torch.Tensor:
    """Element-leading host array -> element-last tensor on device."""
    return torch.as_tensor(
        np.ascontiguousarray(np.moveaxis(a, 0, -1)).astype(dtype),
        device=device,
    )


def build_cell_domain(space: FunctionSpace, cell_ids: np.ndarray,
                      quad_degree: int, dtype=np.float64, *, device,
                      with_hessian: bool | str = False) -> CellDomain:
    mode = _hess_mode(with_hessian)
    mesh = space.mesh
    cell_ids = np.asarray(cell_ids, dtype=np.int64)
    qp, wq = quadrature.cell_rule(mesh.dim, quad_degree)
    el = space.element
    verts = mesh.coords[mesh.cells[cell_ids]]    # (nE, dim+1, dim)
    J = np.swapaxes(verts[:, 1:, :] - verts[:, :1, :], 1, 2)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    wdet = np.abs(detJ)[:, None] * wq[None, :]
    bary = np.hstack([1 - qp.sum(1, keepdims=True), qp])
    xq = np.einsum("qv,Evd->Eqd", bary, verts)
    fl = flat_dofs(np.asarray(space.cell_dofs)[cell_ids], space.n_fields)
    return CellDomain(
        eldofsT=torch.as_tensor(np.ascontiguousarray(fl.T),
                                dtype=torch.int64, device=device),
        JinvT=_soa(Jinv, dtype, device),
        wdetT=_soa(wdet, dtype, device),
        xqT=_soa(xq, dtype, device),
        h=torch.as_tensor(mesh.diameters_of(cell_ids).astype(dtype),
                          device=device),
        phi=torch.as_tensor(el.tabulate(qp).astype(dtype), device=device),
        gphi_ref=torch.as_tensor(el.tabulate_grad(qp).astype(dtype),
                                 device=device),
        flat_eldofs_np=fl,
        hess_ref=(None if mode is None else torch.as_tensor(
            el.tabulate_hess(qp).astype(dtype), device=device)),
        hess_mode=mode,
    )


def build_facet_domain(space: FunctionSpace, facet_ids: np.ndarray,
                       quad_degree: int, dtype=np.float64, *, device,
                       with_hessian: bool | str = False) -> FacetDomain:
    """'+'-restricted facet domain: the '+' cell is the adjacent cell with
    the larger material marker (ties: slot order); a boundary facet uses its
    only cell."""
    mode = _hess_mode(with_hessian)
    mesh = space.mesh
    fd = mesh.facet_data
    facet_ids = np.asarray(facet_ids, dtype=np.int64)
    c0 = fd.facet_cells[facet_ids, 0]
    c1 = fd.facet_cells[facet_ids, 1]
    m0 = mesh.material[c0]
    m1 = np.where(c1 >= 0, mesh.material[np.maximum(c1, 0)], -(2**30))
    take1 = m1 > m0
    plus_cell = np.where(take1, c1, c0)
    plus_local = np.where(
        take1, fd.facet_local[facet_ids, 1], fd.facet_local[facet_ids, 0]
    )

    el = space.element
    lfacets = local_facets(mesh.dim)
    fqp, fwq = quadrature.facet_rule(mesh.dim, quad_degree)
    ref_pts = np.stack(
        [el.facet_to_cell_points(lf, fqp) for lf in range(len(lfacets))]
    )
    phi_tab = np.stack([el.tabulate(p) for p in ref_pts])
    gphi_tab = np.stack([el.tabulate_grad(p) for p in ref_pts])

    verts = mesh.coords[mesh.cells[plus_cell]]   # (nF, dim+1, dim)
    J = np.swapaxes(verts[:, 1:, :] - verts[:, :1, :], 1, 2)
    Jinv = np.linalg.inv(J)
    fverts = np.take_along_axis(
        verts, lfacets[plus_local][:, :, None].astype(np.int64), axis=1
    )                                            # (nF, dim, dim)
    if mesh.dim == 2:
        t = fverts[:, 1] - fverts[:, 0]
        meas = np.linalg.norm(t, axis=1)
        nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / meas[:, None]
    else:
        cr = np.cross(fverts[:, 1] - fverts[:, 0], fverts[:, 2] - fverts[:, 0])
        nn = np.linalg.norm(cr, axis=1)
        meas = 0.5 * nn
        nrm = cr / nn[:, None]
    # orient outward from the plus cell
    flip = np.einsum(
        "fd,fd->f", nrm, fverts.mean(axis=1) - verts.mean(axis=1)
    ) < 0
    nrm[flip] *= -1.0
    fbary = np.hstack([1 - fqp.sum(1, keepdims=True), fqp])
    xq = np.einsum("qv,Fvd->Fqd", fbary, fverts)
    phi = phi_tab[plus_local]
    gphi = np.einsum("Fqbd,Fde->Fqbe", gphi_tab[plus_local], Jinv)
    w = fwq[None, :] * meas[:, None]
    fl = flat_dofs(np.asarray(space.cell_dofs)[plus_cell], space.n_fields)
    second = None
    if mode is not None:
        href = np.stack([el.tabulate_hess(p) for p in ref_pts])[plus_local]
        if mode == "lap":
            G = np.einsum("Fdc,Fec->Fde", Jinv, Jinv)
            second = np.einsum("Fqbde,Fde->Fqb", href, G)
        else:
            second = np.einsum("Fdc,Fqbde,Fef->Fqbcf", Jinv, href, Jinv)
        second = _soa(second, dtype, device)
    return FacetDomain(
        eldofsT=torch.as_tensor(np.ascontiguousarray(fl.T),
                                dtype=torch.int64, device=device),
        phiT=_soa(phi, dtype, device),
        gphiT=_soa(gphi, dtype, device),
        wT=_soa(w, dtype, device),
        xqT=_soa(xq, dtype, device),
        h=torch.as_tensor(mesh.diameters_of(plus_cell).astype(dtype),
                          device=device),
        normalT=_soa(nrm, dtype, device),
        flat_eldofs_np=fl,
        hessT=second,
        hess_mode=mode,
    )


def scatter_into_multi(Y: torch.Tensor, domain, data: torch.Tensor):
    """Y (k, n_dofs) += the stacked element vectors ``data`` (k, ne·nE),
    scattered onto the domain's dofs; returns Y."""
    return Y.index_add_(1, domain.eldofsT.reshape(-1), data)


class Term(NamedTuple):
    domain: CellDomain | FacetDomain
    kernel: Callable


class Form:
    """A sum of integral terms over cell/facet domains."""

    def __init__(self, space: FunctionSpace, terms: list[Term]):
        self.space = space
        self.terms = tuple(terms)
        self.n_dofs = space.n_dofs
        self.n_fields = space.n_fields

    def _local(self, kern, nb, params, with_jac, ctx_dims):
        """vmapped per-element (jacobian, residual) of a term's kernel; the
        residual is the primal of the jacfwd evaluation. Without the
        jacobian the first slot repeats the residual (vmap maps tensors).
        ``ctx_dims``: the context's ``_ctx_dims``."""
        nf = self.n_fields

        def flat_res(uf, al, c):
            r = kern(uf.reshape(nb, nf), al, c, params).reshape(-1)
            return r, r

        def local(ul, al, c):
            uf = ul.reshape(-1)
            if with_jac:
                return jacfwd(flat_res, has_aux=True)(uf, al, c)
            return flat_res(uf, al, c)

        return vmap(local, in_dims=(-1, -1, ctx_dims), out_dims=-1)

    def _gather(self, dom, vec, sl=slice(None)):
        """(nb, n_fields, nE) local values of a dof vector."""
        ne = dom.eldofsT.shape[0]
        idx = dom.eldofsT[:, sl]
        return vec[idx].reshape(ne // self.n_fields, self.n_fields, -1)

    def _assemble(self, u, aux, params, with_jac, with_res):
        """Per-term blocks (ne, ne, nE) and/or the assembled residual, in
        element chunks of JAC_CHUNK."""
        blocks = []
        aux = aux or {}
        r = torch.zeros(self.n_dofs, dtype=u.dtype, device=u.device)
        nf = self.n_fields
        for dom, kern in self.terms:
            ne, nE = dom.eldofsT.shape
            K = (torch.zeros((ne, ne, nE), dtype=u.dtype, device=u.device)
                 if with_jac else None)
            vloc = self._local(kern, ne // nf, params, with_jac,
                               _ctx_dims(dom.ctx(slice(0, 0))))
            for s in range(0, nE, JAC_CHUNK):
                sl = slice(s, min(s + JAC_CHUNK, nE))
                al = {k: self._gather(dom, v, sl) for k, v in aux.items()}
                Kc, rl = vloc(self._gather(dom, u, sl), al, dom.ctx(sl))
                if with_jac:
                    K[..., sl] = Kc
                if with_res:
                    r.index_add_(0, dom.eldofsT[:, sl].reshape(-1),
                                 rl.reshape(-1))
            blocks.append(K)
        return blocks, r

    def jacobian_blocks(self, u: torch.Tensor, aux=None, params=None):
        """Per-term dense element Jacobians K (ne, ne, nE): forward-mode
        autodiff of each element residual kernel."""
        return self._assemble(u, aux, params, True, False)[0]

    def residual(self, u: torch.Tensor, aux=None, params=None) -> torch.Tensor:
        """Assembled residual (n_dofs,)."""
        return self._assemble(u, aux, params, False, True)[1]

    def jacobian_and_residual(self, u: torch.Tensor, aux=None, params=None):
        """(per-term blocks, assembled residual) in one pass per term: the
        primal comes out of the same jacfwd evaluation as the tangents."""
        return self._assemble(u, aux, params, True, True)

    def matvec(self, blocks, x: torch.Tensor) -> torch.Tensor:
        """The foreground operator y = A_f x from element blocks."""
        y = torch.zeros(self.n_dofs, dtype=x.dtype, device=x.device)
        for (dom, _), K in zip(self.terms, blocks):
            xe = x[dom.eldofsT]                                # (ne, nE)
            ye = (K * xe[None]).sum(dim=1)                     # (ne, nE)
            y.index_add_(0, dom.eldofsT.reshape(-1), ye.reshape(-1))
        return y

    def matvec_multi(self, blocks, X: torch.Tensor) -> torch.Tensor:
        """Stacked y = A_f x for k right-hand sides: (k, n_dofs) ->
        (k, n_dofs)."""
        k = X.shape[0]
        Y = torch.zeros((k, self.n_dofs), dtype=X.dtype, device=X.device)
        for (dom, _), K in zip(self.terms, blocks):
            xe = X[:, dom.eldofsT]                             # (k, ne, nE)
            ye = torch.einsum("abE,kbE->kaE", K, xe)
            scatter_into_multi(Y, dom, ye.reshape(k, -1))
        return Y

    def matvec_t(self, blocks, x: torch.Tensor) -> torch.Tensor:
        """The transposed foreground operator y = A_fᵀ x."""
        y = torch.zeros(self.n_dofs, dtype=x.dtype, device=x.device)
        for (dom, _), K in zip(self.terms, blocks):
            xe = x[dom.eldofsT]                                # (ne, nE)
            ye = (K * xe[:, None]).sum(dim=0)                  # (ne, nE)
            y.index_add_(0, dom.eldofsT.reshape(-1), ye.reshape(-1))
        return y


def integrate(domain, kernel, u: torch.Tensor, aux=None, params=None,
              n_fields: int = 1) -> torch.Tensor:
    """∫ kernel over a cell/facet domain; ``kernel(u_loc, aux_loc, ctx,
    params) -> scalar`` per element, u_loc (nb, n_fields). Elements go in
    chunks of JAC_CHUNK, so a context's tabulations (the 3D biharmonic's
    gradients and Laplacians of 2.6 M P2 cells) are never held whole."""
    ne, nE = domain.eldofsT.shape
    dims = _ctx_dims(domain.ctx(slice(0, 0)))
    vmapped = vmap(kernel, in_dims=(-1, -1, dims, None), out_dims=0)
    total = None
    for s in range(0, max(nE, 1), JAC_CHUNK):
        sl = slice(s, min(s + JAC_CHUNK, nE))
        idx = domain.eldofsT[:, sl]

        def gather(vec):
            return vec[idx].reshape(ne // n_fields, n_fields, -1)

        al = {k: gather(v) for k, v in (aux or {}).items()}
        part = vmapped(gather(u), al, domain.ctx(sl), params).sum()
        total = part if total is None else total + part
    return total
