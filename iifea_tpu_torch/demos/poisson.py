"""2D/3D Poisson on an unfitted mesh with Nitsche BCs (port of
``demos/poisson.py``: the same flags, the same printed report and CSV line).

    python3 -m iifea_tpu_torch.demos.poisson --ref 3 --solv gmres --pc jacobi

Runs on the GPU unless ``--device cpu`` is given. Meshes are synthetic
(``--mesh-root synthetic``, the default): the reference's mesh files are
not in the repository. In 3D the solve is direct, as in the reference.
``--k 2`` runs P2 foreground and background spaces (2D; the synthetic 3D
meshes are linear, as in the reference). ``--wv True`` writes the
foreground solution, the exact field and their difference to the VTU file
``--ov``. ``--devices N`` (N > 1) runs the JAX demo's SPMD path: N ranks
(``parallel.sharding.launch``), each building the problem on its device
and solving the cell-sharded system (``ShardedProjectedSystem``, one
all-reduce per apply) by Jacobi-CG to rtol 1e-8, whatever ``--solv`` says;
``--backend`` is nccl on cuda (one rank per card) and gloo on the CPU, and
``--backend gloo`` puts N ranks on one card:

    python3 -m iifea_tpu_torch.demos.poisson --ref 2 --devices 2 --device cpu
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
                   help='Polynomial degree (1 or 2).')
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
                   help='write the solution fields to a VTU file for '
                        'ParaView')
    p.add_argument('--ov', dest='ov', default='poisson_fields.vtu',
                   help='VTU output path for --wv')
    p.add_argument('--beta', dest='beta', default='10.0',
                   help='Nitsche penalty, or "auto": the smallest coercive '
                        'beta doubling from 10')
    p.add_argument('--Ex', dest='Ex', default=True,
                   help='Option to solve on the FG mesh (False: identity M)')
    p.add_argument('--devices', dest='devices', default=1, type=int,
                   help='number of ranks of the SPMD solve (Jacobi-CG on '
                        'the cell-sharded system)')
    p.add_argument('--backend', dest='backend', default=None,
                   help='torch.distributed backend of --devices > 1: nccl '
                        '(the default on cuda, one rank per card) or gloo '
                        '(the default on the CPU; on cuda, several ranks '
                        'on one card)')
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help='"synthetic" for generated immersed meshes (the '
                        'reference mesh files are not in the repository)')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def build_problem(args, device, log: bool = True):
    """(mesh, problem, extraction) of the parsed flags on ``device``."""
    from iifea_tpu_torch.mesh.generators import (
        immersed_cube_problem,
        immersed_square_problem,
    )
    from iifea_tpu_torch.models.poisson import (
        PoissonProblem,
        select_coercive_beta,
    )
    from iifea_tpu_torch.ops.extraction import ExtractionOperator

    k = int(args.k)
    symmetric = str2bool(args.symmetric)
    if int(args.dimension) == 3:
        n = 6 * 2 ** int(args.ref)
        mesh_f, M_synth = immersed_cube_problem(n_fg=int(n * 1.19), n_bg=n,
                                                device=device)
    else:
        n = 8 * 2 ** int(args.ref)
        mesh_f, M_synth = immersed_square_problem(n_fg=n, n_bg=max(n // 2, 4),
                                                  degree=k, device=device)

    beta_auto = str(args.beta).lower() == 'auto'
    beta_val = 10.0 if beta_auto else float(args.beta)
    prob = PoissonProblem(mesh_f, k=k, sym=symmetric, beta_value=beta_val,
                          device=device)
    M = (M_synth if str2bool(args.Ex)
         else ExtractionOperator.identity(prob.space.n_nodes, device=device))

    if beta_auto:
        if not symmetric:
            if log:
                print('[poisson] --beta auto: nonsymmetric Nitsche is '
                      'penalty-free; keeping beta unused', flush=True)
        else:
            beta_sel, prob = select_coercive_beta(mesh_f, M, k=k, beta0=10.0)
            if log:
                print(f'[poisson] auto-selected Nitsche beta = {beta_sel} '
                      '(smallest coercive in 10*2^j)', flush=True)
    return mesh_f, prob, M


def spmd_rank(mesh, argv):
    """One rank of ``--devices N``: the demo's problem built on this
    rank's device, then the JAX demo's SPMD step (cells sharded,
    background vector replicated, Jacobi-CG to rtol 1e-8)."""
    from iifea_tpu_torch.parallel.sharding import ShardedProjectedSystem

    args = parse_args(argv)
    _, prob, M = build_problem(args, mesh.device, log=False)
    system = ShardedProjectedSystem(prob.form, M, mesh)
    step = system.make_step(rtol=1e-8, atol=1e-9, max_it=100000)
    u_p, info = step(torch.zeros(M.n_bg_dofs, dtype=torch.float64,
                                 device=mesh.device))
    return {"u_p": u_p, "info": info, "route": mesh.route,
            "collectives": mesh.collectives}


def main(argv=None) -> dict:
    """Run the demo; returns the error norms and the solve's info (with
    ``--devices N`` also ``ranks``, every rank's result)."""
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.parallel import sharding
    from iifea_tpu_torch.solvers.ksp import _print_monitor, solve_ksp

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
    if k not in (1, 2):
        sys.exit(f"--k {k}: the polynomial degree is 1 or 2")
    if dim == 3 and k != 1:
        sys.exit("synthetic 3D meshes are linear (k=1)")
    device = torch.device(args.device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if args.devices > 1:
        try:
            sharding.check_backend(backend, args.devices, device)
        except ValueError as e:
            sys.exit(f"--devices {args.devices}: {e}")

    mesh_f, prob, M = build_problem(args, device)
    ranks = None
    if args.devices > 1:
        argv = list(sys.argv[1:] if argv is None else argv)
        ranks = sharding.launch(spmd_rank, args.devices, backend,
                                args=(argv,), device=device)
        print(f"[poisson] SPMD solve over {args.devices} ranks "
              f"({ranks[0]['route']})", flush=True)
        u_p, info = ranks[0]["u_p"].to(device), ranks[0]["info"]
        _print_monitor(info)
    else:
        u_f0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                           device=device)
        dR_b, R_b = assemble_background_system(prob.form, u_f0, M)
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
    if str2bool(args.wv):
        from torch.func import vmap

        from iifea_tpu_torch.utils.fieldio import write_vtu

        u_f = M.mv(u_p)
        u_ex = vmap(prob.u_ex)(torch.as_tensor(
            prob.space.node_coords, dtype=u_f.dtype, device=u_f.device))
        write_vtu(args.ov, prob.space,
                  point_data={"u": u_f, "u_exact": u_ex, "error": u_f - u_ex},
                  cell_data={"material": mesh_f.material})
        print(f"wrote fields to {args.ov}", flush=True)
    for line in ('-' * 40, '-' * 5 + f" {nitsche} " + '-' * 5, '-' * 40,
                 f"L2 norm: {norms['L2']}", f"H10 norm: {norms['H10']}",
                 f"H1 norm: {norms['H1']}", '-' * 40):
        print(line, flush=True)
    return {"norms": norms, "info": info, "u_p": u_p, "ranks": ranks}


if __name__ == "__main__":
    main()
