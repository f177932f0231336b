"""2D immersed linear elasticity (port of the synthetic mode of
``demos/linear_elasticity.py``: the same flags, the same printed report
and CSV line).

    python3 -m iifea_tpu_torch.demos.linear_elasticity --mesh-root synthetic --k 1 --ref 3

The synthetic mode solves ``ImmersedElasticityProblem`` on the generated
immersed square (n_fg = 8·2^ref, n_bg = n_fg/2) with a known lattice
background, by block-multigrid CG (``--solv cg --pc mg``, the default; the
stencil applies run on the ``stencil_mv`` kernel on a card) or by
``--pc bjacobi``/``jacobi`` on the general operator. Runs on the GPU unless
``--device cpu`` is given. Not ported yet, and refused with a message: the
Kirsch plate on the reference's mesh files (any other ``--mesh-root``) and
``--k 2`` (P2 spaces).
"""
from __future__ import annotations

import argparse
import sys
from timeit import default_timer

import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--k', dest='k', default=1,
                   help='Polynomial degree (1; 2 is not ported yet).')
    p.add_argument('--ref', dest='ref', default='0',
                   help='Refinement level, integers in (0,6)')
    p.add_argument('--lref', dest='lref', default='0',
                   help='Local refinement level, (0,2), only for k=2')
    p.add_argument('--sym', dest='symmetric', default=True,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--solv', dest='solv', default='mumps',
                   help="Linear solver ('mumps' means cg in the synthetic "
                        "mode)")
    p.add_argument('--pc', dest='pc', default=None,
                   help='Preconditioner for linear solver (default mg)')
    p.add_argument('--wf', dest='wf', default=False,
                   help='write output data to file')
    p.add_argument('--E', dest='E', default=200e9,
                   help='Youngs Modulus (Kirsch plate only)')
    p.add_argument('--nu', dest='nu', default=0.3,
                   help='Poissons ratio (Kirsch plate only)')
    p.add_argument('--of', dest='of', default='error_data.csv',
                   help='Destination for output data')
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help='"synthetic" for the generated immersed square (the '
                        'reference mesh files are not in the repository)')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the error norms, the solve's info and time."""
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    args = parse_args(argv)
    k = int(args.k)
    ref = args.ref
    symmetric = str2bool(args.symmetric)
    if args.mesh_root != "synthetic":
        sys.exit("the Kirsch plate reads the reference mesh files, which are "
                 "not in the repository; use --mesh-root synthetic (mesh "
                 "I/O: ROADMAP.md item 12e)")
    if k != 1:
        sys.exit("--k 2: P2 spaces are not ported yet (ROADMAP.md item 12d)")
    device = torch.device(args.device)

    n = 8 * 2 ** int(ref)
    n_bg = max(n // 2, 4)
    mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n_bg, degree=k,
                                        n_fields=2, device=device)
    prob = ImmersedElasticityProblem(mesh_f, k=k, sym=symmetric,
                                     device=device)
    solv = 'cg' if args.solv == 'mumps' else args.solv
    pc = 'mg' if args.pc is None else args.pc

    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    dR_b, R_b = assemble_background_system(prob.form, u0, M)
    start = default_timer()
    u_p, info = solve_ksp(dR_b, R_b, method=solv, pc=pc, rtol=1e-10,
                          lattice_shape=(n_bg + 1, n_bg + 1), n_fields=2,
                          monitor=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = default_timer() - start
    norms = prob.error_norms(M.mv(u_p))

    if str2bool(args.wf):
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{ref},{norms['L2']},{norms['H10']},{t_solve},synthetic")
    for line in ('-' * 40,
                 f"Synthetic immersed elasticity (n_fg={n}, n_bg={n_bg}, "
                 f"solv={solv}, pc={pc})",
                 f"Time for solve_linear: {t_solve}",
                 f"relative L2 norm: {norms['L2']}",
                 f"relative H10 norm: {norms['H10']}",
                 '-' * 40):
        print(line, flush=True)
    return {"norms": norms, "info": info, "u_p": u_p, "t_solve": t_solve}


if __name__ == "__main__":
    main()
