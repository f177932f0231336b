"""Taylor-Green vortex on an unfitted background (port of
``demos/background_unfitted/tg_unfitted.py``).

The reference demo builds a transfer matrix and then overrides it with an
identity, so it degenerates to a fitted solve through the same VMS
pipeline; ``--identity True`` (the default) reproduces that, ``--identity
False`` runs the real runtime transfer from a coarser-covering background
grid. Runs on the GPU unless ``--device cpu`` is given.

    python3 -m iifea_tpu_torch.demos.background_unfitted.tg_unfitted --ref 1
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref', dest='ref', default='1', help='Refinement level')
    p.add_argument('--Re', dest='Re', default=100.0, help='Reynolds number.')
    p.add_argument('--T', dest='T', default=1.0, help='Time interval.')
    p.add_argument('--identity', dest='identity', default=True,
                   help='True: identity M (the reference demo\'s behaviour); '
                        'False: the runtime transfer matrix')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the error norms and the step count."""
    from iifea_tpu_torch.api import l2_project
    from iifea_tpu_torch.mesh.core import Mesh
    from iifea_tpu_torch.mesh.generators import (
        rectangle_mesh,
        transfer_matrix_simplex,
    )
    from iifea_tpu_torch.models.navier_stokes import (
        TaylorGreenProblem,
        u_exact,
    )
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.utils.logging import log_info

    args = parse_args(argv)
    ref = int(args.ref)
    Re = float(args.Re)
    T = float(args.T)
    device = torch.device(args.device)

    n = 8 * 2 ** ref
    L = 2.0
    mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n, n)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells,
                  np.full(mesh_f.n_cells, 2, np.int32))

    N = math.sqrt(mesh_f.n_cells)
    Dt_approx = 4 / N
    N_STEPS = int(np.ceil(T / Dt_approx))
    Dt = T / N_STEPS

    # the exterior facets carry the weak Dirichlet condition
    bdry = np.where(mesh_f.facet_data.facet_cells[:, 1] < 0)[0]
    n_nodes = mesh_f.n_verts
    if str2bool(args.identity):
        M = ExtractionOperator.identity(n_nodes, n_fields=3, device=device)
    else:
        mesh_b = rectangle_mesh((-2.0, -2.0), (2.0, 2.0), n, n)
        M = transfer_matrix_simplex(mesh_b, np.asarray(mesh_f.coords),
                                    n_fields=3, device=device)
    prob = TaylorGreenProblem(mesh_f, k=1, Re=Re, Dt=Dt,
                              n_bg_dofs=M.n_bg_dofs, boundary_facets=bdry,
                              device=device)
    nu = prob.nu

    def ic(x):
        return torch.cat([u_exact(x, nu, 0.0), torch.zeros_like(x[:1])])

    up_p, up_old_f = l2_project(ic, prob.space, prob.cell_dom, M)
    up_f = up_old_f
    t = 0.0
    for step in range(N_STEPS):
        log_info(f"======= Time step {step+1}/{N_STEPS} =======")
        t += 0.5 * Dt
        up_p, up_f = solve_nonlinear(
            prob.form, up_f, M, up_p,
            aux={"up_old": up_old_f}, params={"t": t},
            max_iters=10, linear_method='gmres', monitor_newton=False,
            relative_tolerance=5e-4, absolute_tolerance=1e-4,
            absolute_tolerance_res=1e-5,
        )
        up_old_f = up_f
        t += 0.5 * Dt

    norms = prob.error_norms(up_f, t)
    log_info('-' * 40)
    log_info(f"L2 velocity error: {norms['L2u']}")
    log_info(f"H1 velocity error: {norms['H1u']}")
    log_info(f"L2 pressure error: {norms['L2p']}")
    log_info(f"L2 pressure error (mean-removed): {norms['L2p0']}")
    log_info(f"H1 pressure error: {norms['H1p']}")
    log_info('-' * 40)
    return {"norms": norms, "n_steps": N_STEPS}


if __name__ == "__main__":
    main()
