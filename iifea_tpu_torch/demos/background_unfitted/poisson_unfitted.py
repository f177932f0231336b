"""2D Poisson with a background-unfitted mesh (port of
``demos/background_unfitted/poisson_unfitted.py``).

The foreground is a rotated structured square whose whole area is the
domain, its true boundary carrying the (nonsymmetric) Nitsche terms; M is
built at run time by Lagrange interpolation from a larger unrotated
background grid; the projected system is solved by host LU. Runs on the
GPU unless ``--device cpu`` is given.

    python3 -m iifea_tpu_torch.demos.background_unfitted.poisson_unfitted --n 64
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import grad, vmap


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--n', dest='n', default=16,
                   help='Number of elements in each direction.')
    p.add_argument('--ref', dest='ref', default=-1, help='Refinement level.')
    p.add_argument('--k', dest='k', default=1, help='Polynomial degree.')
    p.add_argument('--sym', dest='symmetric', default=True,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--of', dest='of', default='error_data_NC_Poisson.csv',
                   help='output file to write error data to')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


BETA = 8.0
# the reference demo fixes the nonsymmetric variant whatever --sym says
SYMMETRIC = False


def problem(args, device):
    """(form, M, cell domain, boundary domain, foreground mesh, Nel) of
    the demo's configuration."""
    from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
    from iifea_tpu_torch.mesh.generators import (
        generate_unfitted_mesh,
        transfer_matrix_simplex,
    )
    from iifea_tpu_torch.models.poisson import source_fn, u_exact_fn
    from iifea_tpu_torch.ops.assembly import (
        Form,
        Term,
        build_cell_domain,
        build_facet_domain,
    )

    ref = float(args.ref)
    Nel = int(4 * 2**ref) if ref > -1 else int(args.n)
    k = int(args.k)
    mesh_f, mesh_b = generate_unfitted_mesh(2.0, 4.0, Nel, Nel, dim=2,
                                            rotate_f=True)
    # the whole foreground is the domain
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells,
                  np.full(mesh_f.n_cells, 2, np.int32))
    V_f = FunctionSpace(mesh_f, degree=k)
    u_ex = u_exact_fn(2)
    f_fn = source_fn(u_ex)
    sgn = 1.0 if SYMMETRIC else -1.0

    qd = 2 * k
    cell_dom = build_cell_domain(V_f, np.arange(mesh_f.n_cells), qd,
                                 device=device)
    bdry = np.where(mesh_f.facet_data.facet_cells[:, 1] < 0)[0]
    bdry_dom = build_facet_domain(V_f, bdry, qd, device=device)

    def cell_kern(u_loc, aux_loc, ctx, params):
        gu = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        fx = vmap(f_fn)(ctx.x)
        r = torch.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
        return (r - torch.einsum("q,q,qb->b", ctx.w, fx, ctx.phi))[:, None]

    def bdry_kern(u_loc, aux_loc, ctx, params):
        U = u_loc[:, 0]
        uq = torch.einsum("qb,b->q", ctx.phi, U)
        gun = torch.einsum("qbd,b,d->q", ctx.gphi, U, ctx.n)
        gq = vmap(u_ex)(ctx.x)
        gphin = torch.einsum("qbd,d->qb", ctx.gphi, ctx.n)
        r = -torch.einsum("q,q,qb->b", ctx.w, gun, ctx.phi)
        r = r + sgn * torch.einsum("q,q,qb->b", ctx.w, gq - uq, gphin)
        if SYMMETRIC:
            r = r + (BETA / ctx.h) * torch.einsum("q,q,qb->b", ctx.w,
                                                  uq - gq, ctx.phi)
        return r[:, None]

    form = Form(V_f, [Term(cell_dom, cell_kern), Term(bdry_dom, bdry_kern)])
    M = transfer_matrix_simplex(mesh_b, np.asarray(V_f.node_coords),
                                degree=k, device=device)
    return form, M, cell_dom, bdry_dom, mesh_f, Nel


def error_norms(u_f, cell_dom, bdry_dom):
    """(L2, H1) of u_f − u_exact; H1 includes the boundary term ∫ e²/h."""
    from iifea_tpu_torch.models.poisson import u_exact_fn
    from iifea_tpu_torch.ops.assembly import integrate

    u_ex = u_exact_fn(2)

    def err(u_loc, ctx):
        return torch.einsum("qb,b->q", ctx.phi, u_loc[:, 0]) - vmap(u_ex)(
            ctx.x)

    def err_sq(u_loc, aux_loc, ctx, params):
        return torch.einsum("q,q->", ctx.w, err(u_loc, ctx) ** 2)

    def gerr_sq(u_loc, aux_loc, ctx, params):
        ge = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0]) - vmap(
            grad(u_ex))(ctx.x)
        return torch.einsum("q,qd->", ctx.w, ge ** 2)

    def edge_sq(u_loc, aux_loc, ctx, params):
        return torch.einsum("q,q->", ctx.w, err(u_loc, ctx) ** 2) / ctx.h

    l2 = float(integrate(cell_dom, err_sq, u_f))
    h10 = float(integrate(cell_dom, gerr_sq, u_f))
    edge = float(integrate(bdry_dom, edge_sq, u_f))
    return l2 ** 0.5, (l2 + h10 + edge) ** 0.5


def main(argv=None) -> dict:
    """Run the demo; returns the L2 and H1 error norms, Nel, and the
    projected system with its solution."""
    from iifea_tpu_torch.api import average_cell_diagonal
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp
    from iifea_tpu_torch.utils.logging import log_info

    args = parse_args(argv)
    device = torch.device(args.device)
    form, M, cell_dom, bdry_dom, mesh_f, Nel = problem(args, device)
    u0 = torch.zeros(form.n_dofs, dtype=torch.float64, device=device)
    A, b = assemble_background_system(form, u0, M)
    u_p, _ = solve_ksp(A, b, method='direct', monitor=True)
    u_f = M.mv(u_p)
    norm_L2, norm_H1 = error_norms(u_f, cell_dom, bdry_dom)

    Nitsche_type = ('Symmetric' if SYMMETRIC else 'Nonymmetric') \
        + ' Nitsche Method'
    log_info('-' * 40)
    log_info('-' * 5 + f" {Nitsche_type} " + '-' * 5)
    log_info('-' * 40)
    log_info("Average mesh size of the foreground mesh = "
             + str(average_cell_diagonal(mesh_f)))
    log_info(f"L2 norm: {norm_L2}")
    log_info(f"H1 norm: {norm_H1}")
    log_info(f"Nel: {Nel}")
    log_info('-' * 40)
    return {"L2": norm_L2, "H1": norm_H1, "Nel": Nel, "A": A, "b": b,
            "u_p": u_p, "u_f": u_f}


if __name__ == "__main__":
    main()
