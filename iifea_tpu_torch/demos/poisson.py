"""2D/3D Poisson on an unfitted mesh with Nitsche BCs (port of
``demos/poisson.py``: the same flags, the same printed report and CSV line).

    python3 -m iifea_tpu_torch.demos.poisson --ref 3 --solv gmres --pc jacobi

Runs on the GPU unless ``--device cpu`` is given. Meshes are synthetic
(``--mesh-root synthetic``, the default): the reference's mesh files are
not in the repository. In 3D the solve is direct, as in the reference.
Not ported yet, and refused with a message: ``--k 2`` (P2 spaces),
``--devices`` > 1 (multi-GPU) and ``--wv`` (VTU output).
"""
from __future__ import annotations

import argparse
import sys

import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--k', dest='k', default=1,
                   help='Polynomial degree (1; 2 is not ported yet).')
    p.add_argument('--dim', dest='dimension', default=2,
                   help='Problem dimension (2 or 3).')
    p.add_argument('--ref', dest='ref', default='0',
                   help='Refinement level, integers in (0,6) for 2D, (0,4) '
                        'for 3D')
    p.add_argument('--sym', dest='symmetric', default=True,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--solv', dest='solv', default='gmres',
                   help='Linear solver')
    p.add_argument('--pc', dest='pc', default='jacobi',
                   help='Preconditioner for linear solver')
    p.add_argument('--wf', dest='wf', default=False,
                   help='write output data to file')
    p.add_argument('--of', dest='of', default='poisson_data.csv',
                   help='Destination for output data')
    p.add_argument('--wv', dest='wv', default=False,
                   help='write a VTU file (not ported yet)')
    p.add_argument('--ov', dest='ov', default='poisson_fields.vtu',
                   help='VTU output path for --wv')
    p.add_argument('--beta', dest='beta', default='10.0',
                   help='Nitsche penalty, or "auto": the smallest coercive '
                        'beta doubling from 10')
    p.add_argument('--Ex', dest='Ex', default=True,
                   help='Option to solve on the FG mesh (False: identity M)')
    p.add_argument('--devices', dest='devices', default=1, type=int,
                   help='number of GPUs (only 1 is ported)')
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help='"synthetic" for generated immersed meshes (the '
                        'reference mesh files are not in the repository)')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the error norms and the solve's info."""
    from iifea_tpu_torch.mesh.generators import (
        immersed_cube_problem,
        immersed_square_problem,
    )
    from iifea_tpu_torch.models.poisson import (
        PoissonProblem,
        select_coercive_beta,
    )
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    args = parse_args(argv)
    k = int(args.k)
    dim = int(args.dimension)
    Ex = str2bool(args.Ex)
    symmetric = str2bool(args.symmetric)
    ref = args.ref
    solver = args.solv
    if args.mesh_root != "synthetic":
        sys.exit("the reference mesh files are not in the repository; use "
                 "--mesh-root synthetic (mesh I/O: ROADMAP.md item 12e)")
    if k != 1:
        sys.exit("--k 2: P2 spaces are not ported yet (ROADMAP.md item 12d)")
    if args.devices > 1:
        sys.exit(f"--devices {args.devices}: the multi-GPU solve is not "
                 "ported yet (ROADMAP.md item 16)")
    if str2bool(args.wv):
        sys.exit("--wv: VTU output is not ported yet (ROADMAP.md item 17)")
    device = torch.device(args.device)

    if dim == 3:
        n = 6 * 2 ** int(ref)
        mesh_f, M_synth = immersed_cube_problem(n_fg=int(n * 1.19), n_bg=n,
                                                device=device)
    else:
        n = 8 * 2 ** int(ref)
        mesh_f, M_synth = immersed_square_problem(n_fg=n, n_bg=max(n // 2, 4),
                                                  device=device)

    beta_auto = str(args.beta).lower() == 'auto'
    beta_val = 10.0 if beta_auto else float(args.beta)
    prob = PoissonProblem(mesh_f, k=k, sym=symmetric, beta_value=beta_val,
                          device=device)
    M = (M_synth if Ex
         else ExtractionOperator.identity(prob.space.n_nodes, device=device))

    if beta_auto:
        if not symmetric:
            print('[poisson] --beta auto: nonsymmetric Nitsche is '
                  'penalty-free; keeping beta unused', flush=True)
        else:
            beta_sel, prob = select_coercive_beta(mesh_f, M, k=k, beta0=10.0)
            print(f'[poisson] auto-selected Nitsche beta = {beta_sel} '
                  '(smallest coercive in 10*2^j)', flush=True)

    u_f0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    dR_b, R_b = assemble_background_system(prob.form, u_f0, M)  # J du = -res
    if dim == 3:
        solver = 'direct'    # the reference solves 3D directly
    u_p, info = solve_ksp(dR_b, R_b, method=solver, pc=args.pc,
                          bfr_tol=1e-9 if not Ex else None)

    norms = prob.error_norms(M.mv(u_p))
    nitsche = ('Symmetric Nitsche Method' if symmetric
               else 'Nonsymmetric Nitsche Method')
    if str2bool(args.wf):
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{ref},{norms['H10']},{norms['L2']},{k}")
    for line in ('-' * 40, '-' * 5 + f" {nitsche} " + '-' * 5, '-' * 40,
                 f"L2 norm: {norms['L2']}", f"H10 norm: {norms['H10']}",
                 f"H1 norm: {norms['H1']}", '-' * 40):
        print(line, flush=True)
    return {"norms": norms, "info": info, "u_p": u_p}


if __name__ == "__main__":
    main()
