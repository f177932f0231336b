"""Kirchhoff-Love shell, the flat square pinned at the immersed (diamond)
boundary under a uniform vertical load, on the reference's mesh files
(port of ``demos/pinned_shell.py``).

    python3 -m iifea_tpu_torch.demos.pinned_shell --mesh-root MESHES --ref 5

Reads ``square/Quadratic/R{ref}`` under the mesh root (P2 on the files'
Exodus node ids; ``mesh.xdmf`` needs h5py) and M (three fields) from its
``ExOp_Cons.csv``, runs ``KLShellProblem`` on the flat surface pinned at
the interface, Newton with host LU of Mᵀ A_f M, and prints the centre
displacement. Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import torch

from iifea_tpu_torch.demos.background_unfitted.pinned_shell_unfitted import (
    PROBLEM,
    flat_surface,
)

NEWTON = dict(max_iters=10, linear_method='direct', monitor_newton=False,
              monitor_linear=False, relative_tolerance=5e-4, relax_param=1.0,
              absolute_tolerance=1e-4, absolute_tolerance_res=1e-5)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref', dest='ref', default='5',
                   help='Refinement level, integers in (4,6)')
    p.add_argument('--line-search', dest='line_search', default=False,
                   action='store_true',
                   help='Backtracking line search on ||R|| inside Newton')
    p.add_argument('--ptc', dest='ptc', type=float, default=None,
                   help='Pseudo-transient continuation sigma0 (A + '
                        'sigma_k|diag A|, sigma decaying with the residual)')
    p.add_argument('--mesh-root', dest='mesh_root', default='meshes',
                   help='root of the reference mesh files')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the centre displacement, the Newton record
    (one dict of stage seconds per iteration) and the state."""
    from iifea_tpu_torch.mesh.io import read_mesh, require_mesh_dir
    from iifea_tpu_torch.models.kl_shell import KLShellProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.solvers.newton import recording
    from iifea_tpu_torch.utils.logging import log_info

    args = parse_args(argv)
    device = torch.device(args.device)
    path = require_mesh_dir(os.path.join(args.mesh_root,
                                         f"square/Quadratic/R{args.ref}"))
    prob = KLShellProblem(read_mesh(path), flat_surface, device=device,
                          **PROBLEM)
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes, n_fields=3,
        device=device)

    with recording([]) as record:
        u_p, u_f = solve_nonlinear(
            prob.form,
            torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                        device=device),
            M, torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=device),
            line_search=args.line_search, ptc_sigma0=args.ptc, **NEWTON)

    u_x, u_y, u_z = prob.evaluate(u_f, [[0.0, 0.0]])[0]
    log_info(f"Center displacement: ( {u_x} , {u_y} , {u_z} )")
    return {"disp": (float(u_x), float(u_y), float(u_z)),
            "newton_iters": len(record), "record": record, "u_p": u_p,
            "u_f": u_f, "prob": prob, "M": M}


if __name__ == "__main__":
    main()
