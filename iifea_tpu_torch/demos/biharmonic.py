"""2D/3D biharmonic with Nitsche BCs on a quadratic B-spline background
(port of the synthetic mode of ``demos/biharmonic.py``: the same flags, the
same printed report and CSV line).

    python3 -m iifea_tpu_torch.demos.biharmonic --ref 2
    python3 -m iifea_tpu_torch.demos.biharmonic --dim 3 --ref 0

The synthetic mode generates the rotated immersed square (cube) in a P2
triangle (tetrahedron) foreground on nested grids (n_bg = 2^(ref+4) − 1
spans a side in 2D, 2^(ref+3) − 1 in 3D; n_fg = 2·n_bg) and extracts it to
the C1 quadratic B-spline lattice (n_bg + 2)^dim; the fourth-order system
is solved by MG-preconditioned GMRES on the radius-3 stencil
(``solve_ksp(pc='mg', stencil_radius=3)``: on a card the hand kernels' f64
radius-3 instances, 2D or 3D). ``--solv direct`` or ``mumps`` means GMRES
there, as in the reference. Under a mesh root, the reference's files
``square`` or ``cube``/``Quadratic/R{ref}`` (P2 on their Exodus node ids, M
from ``ExOp_Cons.csv``; ``mesh.xdmf`` needs h5py), solved as the reference
demo does: host SuperLU in 2D, defect-correction Newton on SuperLU in 3D
(their background is no lattice). Runs on the GPU unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dim', dest='dimension', default=2,
                   help='Problem dimension (2 or 3).')
    p.add_argument('--ref', dest='ref', default='3',
                   help='Refinement level, (0,6) 2D, (0,4) 3D')
    p.add_argument('--sym', dest='symmetric', default=False,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--solv', dest='solv', default='gmres',
                   help='Linear solver')
    p.add_argument('--pc', dest='pc', default='jacobi',
                   help='Preconditioner for linear solver (the synthetic '
                        'mode always runs mg)')
    p.add_argument('--wf', dest='wf', default=False,
                   help='write output data to file')
    p.add_argument('--of', dest='of', default='biharmonic_error.csv',
                   help='output data file')
    p.add_argument('--b', dest='beta_val', default=5, help='Beta penalty')
    p.add_argument('--a', dest='alpha_val', default=5, help='alpha penalty')
    p.add_argument('--ft', dest='ft', default=1e-5,
                   help='cell volume filtering tolerance')
    p.add_argument('--snap', dest='snap', default=False,
                   help='snap the staircase cut onto the exact rotated '
                        'square')
    p.add_argument('--mms', dest='mms', default='reference',
                   choices=('reference', 'steep'),
                   help="manufactured solution: 'reference' is the "
                        "reference's own (2D cos(0.05 pi x + 0.1) "
                        "cos(0.05 pi y + 0.1), 3D the wavelength-2 "
                        "cosines); 'steep' the wavelength-2 cosines "
                        "cos(pi x_d + 0.5) in any dimension")
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help='root of the reference mesh files (square/..., '
                        'cube/...), or "synthetic" for the generated '
                        'immersed square or cube')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def steep_u_exact(x: torch.Tensor) -> torch.Tensor:
    """The wavelength-2 cosines Π_d cos(π x_d + 0.5), in x's dimension."""
    out = torch.cos(math.pi * x[0] + 0.5)
    for d in range(1, x.shape[0]):
        out = out * torch.cos(math.pi * x[d] + 0.5)
    return out


def main(argv=None) -> dict:
    """Run the demo; returns the error norms, the solve's info and the
    background solution."""
    from iifea_tpu_torch.mesh.generators import (
        immersed_cube_bspline_problem,
        immersed_square_bspline_problem,
    )
    from iifea_tpu_torch.mesh.io import read_mesh, require_mesh_dir
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp
    from iifea_tpu_torch.solvers.newton import solve_newtons_linear

    args = parse_args(argv)
    dim = int(args.dimension)
    if dim not in (2, 3):
        sys.exit(f"--dim {args.dimension}: the problem dimension is 2 or 3")
    ref = args.ref
    device = torch.device(args.device)

    lattice_shape = None
    if args.mesh_root != "synthetic":
        path = require_mesh_dir(os.path.join(
            args.mesh_root, 'square' if dim == 2 else 'cube',
            f"Quadratic/R{ref}"))
        mesh_f = read_mesh(path)
        dim = mesh_f.dim
    # nested grids (n_fg = 2·n_bg): every foreground cell sees one
    # polynomial piece of the spline, as in the reference demo
    elif dim == 3:
        n_bg = 2 ** (int(ref) + 3) - 1
        mesh_f, M, lattice_shape = immersed_cube_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg, device=device)
    else:
        n_bg = 2 ** (int(ref) + 4) - 1
        mesh_f, M, lattice_shape = immersed_square_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg, snap_boundary=str2bool(args.snap),
            device=device)
    prob = BiharmonicProblem(
        mesh_f, sym=str2bool(args.symmetric),
        beta_value=float(args.beta_val), alpha_value=float(args.alpha_val),
        filter_tol=float(args.ft),
        u_exact=steep_u_exact if args.mms == 'steep' else None,
        device=device)
    if lattice_shape is None:
        M = ExtractionOperator.from_exop_csv(
            os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes,
            device=device)

    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    info = None
    if lattice_shape is not None:
        dR_b, R_b = assemble_background_system(prob.form, u0, M)
        solv = ('gmres' if args.solv in ('gmres', 'direct', 'mumps')
                else args.solv)
        u_p, info = solve_ksp(dR_b, R_b, method=solv, pc='mg', rtol=1e-10,
                              lattice_shape=lattice_shape, stencil_radius=3,
                              monitor=True)
        u_f = M.mv(u_p)
    elif dim == 3:
        # defect correction against the finite-precision blow-up of the
        # fourth-order system, as the reference demo does
        u_p, u_f = solve_newtons_linear(
            prob.form, u0, M,
            torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=device),
            max_iters=20, relative_tolerance=1e-12, linear_method='direct')
    else:
        dR_b, R_b = assemble_background_system(prob.form, u0, M)
        u_p, info = solve_ksp(dR_b, R_b, method='direct', monitor=True)
        u_f = M.mv(u_p)
    norms = prob.error_norms(u_f)

    if str2bool(args.wf):
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{ref},{norms['L2_rel']},{norms['H1_rel']},"
                    f"{norms['H2_rel']},{args.alpha_val},{args.beta_val}")
    for line in ('-' * 40,
                 f"L2 norm: {norms['L2']}",
                 f"H1 norm: {norms['H1']}",
                 f"H2 norm: {norms['H2']}",
                 f"relative L2 norm: {norms['L2_rel']}",
                 f"relative H1 norm: {norms['H1_rel']}",
                 f"relative H2 norm: {norms['H2_rel']}",
                 '-' * 40):
        print(line, flush=True)
    return {"norms": norms, "info": info, "u_p": u_p}


if __name__ == "__main__":
    main()
