"""2D linear elasticity (port of ``demos/linear_elasticity.py``: the same
flags, the same printed report and CSV lines).

    python3 -m iifea_tpu_torch.demos.linear_elasticity --mesh-root MESHES --k 2 --ref 3 --lref 1
    python3 -m iifea_tpu_torch.demos.linear_elasticity --mesh-root synthetic --k 1 --ref 3

With a mesh root, the Kirsch plate (``ElasticityProblem``) on the
reference's files: ``hole_in_plate/Linear/R{ref}`` for --k 1,
``hole_in_plate/Quadratic/FG_R{lref}/R{ref}`` for --k 2 (whose hole and
plate materials are swapped back), M from the directory's ``ExOp_Cons.csv``
(``mesh.xdmf`` needs h5py). ``--solv mumps`` (the default) or ``direct`` is
host SuperLU; any Krylov method with ``--pc jacobi`` or ``asm`` runs on the
device (the files' background is no lattice, so ``mg`` is refused). It
prints the stress error norm and appends ``ref,norm,t_solve,t_extract``
with ``--wf True``. ``kirsch(mesh, M, args, device)`` is that branch on a
mesh and M already in hand.

The synthetic mode solves ``ImmersedElasticityProblem`` on the generated
immersed square (n_fg = 8·2^ref, n_bg = n_fg/2) with a known lattice
background, by block-multigrid CG (``--solv cg --pc mg``, the default; the
stencil applies run on the ``stencil_mv`` kernel on a card) or by
``--pc bjacobi``/``jacobi`` on the general operator. ``--k 2`` puts P2
spaces on both meshes; a P2 simplex background is no lattice, so its
default is ``--pc bjacobi`` and ``--pc mg`` is refused (the reference's
demo fails there on the lattice's size). Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
from timeit import default_timer

import numpy as np
import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--k', dest='k', default=1,
                   help='Polynomial degree (1 or 2).')
    p.add_argument('--ref', dest='ref', default='0',
                   help='Refinement level, integers in (0,6)')
    p.add_argument('--lref', dest='lref', default='0',
                   help='Local refinement level, (0,2), only for k=2')
    p.add_argument('--sym', dest='symmetric', default=True,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--solv', dest='solv', default='mumps',
                   help="Linear solver: mumps/direct is host SuperLU ("
                        "'mumps' means cg in the synthetic mode)")
    p.add_argument('--pc', dest='pc', default=None,
                   help='Preconditioner for linear solver (synthetic: '
                        'default mg, bjacobi for --k 2; mesh files: jacobi '
                        'or asm)')
    p.add_argument('--wf', dest='wf', default=False,
                   help='write output data to file')
    p.add_argument('--E', dest='E', default=200e9,
                   help='Youngs Modulus (Kirsch plate only)')
    p.add_argument('--nu', dest='nu', default=0.3,
                   help='Poissons ratio (Kirsch plate only)')
    p.add_argument('--of', dest='of', default='error_data.csv',
                   help='Destination for output data')
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help='root of the reference mesh files (hole_in_plate/'
                        '...), or "synthetic" for the generated immersed '
                        'square')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def plate_path(mesh_root: str, k: int, ref, lref) -> str:
    """The Kirsch plate's mesh directory of the reference's layout."""
    root = os.path.join(mesh_root, "hole_in_plate")
    if k == 1:
        return os.path.join(root, f"Linear/R{ref}")
    return os.path.join(root, f"Quadratic/FG_R{lref}/R{ref}")


def flip_materials(mesh):
    """The quadratic plate files mark the hole 2 and the plate 1: swap."""
    from iifea_tpu_torch.mesh.core import Mesh

    m = mesh.material
    flipped = np.where(m == 1, 2, np.where(m == 2, 1, m))
    return Mesh(mesh.coords, mesh.cells, flipped, mesh.cell_nodes)


def kirsch(mesh, M, args, device, t_extract: float = 0.0) -> dict:
    """The Kirsch plate on ``mesh`` (plate cells of material 2) with the
    extraction ``M`` (two fields): assemble, solve by ``args.solv`` and
    ``args.pc``, print the report, append the CSV line with --wf True.
    Returns the stress error norm, the solve's info and seconds, the
    background solution, the problem and its stage seconds (assembly,
    to_scipy and direct_solve for a direct solve, stress_norm)."""
    from iifea_tpu_torch.models.elasticity import ElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp
    from iifea_tpu_torch.utils.logging import log_info
    from iifea_tpu_torch.utils.profiling import Timings, timed

    device = torch.device(device)
    symmetric = str2bool(args.symmetric)
    stages = Timings()
    prob = ElasticityProblem(mesh, k=int(args.k), E=float(args.E),
                             nu=float(args.nu), sym=symmetric, device=device)
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    with timed(stages, "assembly"):
        dR_b, R_b = assemble_background_system(prob.form, u0, M)
    start = default_timer()
    u_p, info = solve_ksp(dR_b, R_b, method=args.solv, pc=args.pc,
                          monitor=True, timings=stages)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = default_timer() - start
    with timed(stages, "stress_norm"):
        norm = prob.stress_error_norm(M.mv(u_p))

    if str2bool(args.wf):
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{args.ref},{norm},{t_solve},{t_extract}")
    nitsche = ('Symmetric Nitsche Method' if symmetric
               else 'Nonsymmetric Nitsche Method')
    log_info('-' * 40)
    log_info('-' * 5 + f" {nitsche} " + '-' * 5)
    log_info('-' * 40)
    log_info(f"Time for creating M: {t_extract}")
    log_info(f"Time for solve_linear: {t_solve}")
    log_info(f"Extraction error norm: {norm}")
    log_info('-' * 40)
    return {"norm": norm, "info": info, "u_p": u_p, "t_solve": t_solve,
            "t_extract": t_extract, "prob": prob, "A": dR_b, "b": R_b,
            "stage_seconds": dict(stages)}


def main(argv=None) -> dict:
    """Run the demo; returns the synthetic mode's error norms, the solve's
    info and time, or the Kirsch plate's (``kirsch``)."""
    args = parse_args(argv)
    k = int(args.k)
    if k not in (1, 2):
        sys.exit(f"--k {k}: the polynomial degree is 1 or 2")
    device = torch.device(args.device)
    if args.mesh_root == "synthetic":
        return synthetic(args, device)
    if args.pc == 'mg':
        sys.exit("--pc mg: the mesh files' background is no lattice; use "
                 "--solv mumps or --pc jacobi or asm")
    from iifea_tpu_torch.mesh.core import FunctionSpace
    from iifea_tpu_torch.mesh.io import read_mesh, require_mesh_dir
    from iifea_tpu_torch.ops.extraction import ExtractionOperator

    path = require_mesh_dir(plate_path(args.mesh_root, k, args.ref,
                                       args.lref))
    mesh_f = read_mesh(path)
    if k == 2:
        mesh_f = flip_materials(mesh_f)
    start = default_timer()
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"),
        FunctionSpace(mesh_f, degree=k).n_nodes, n_fields=2, device=device)
    return kirsch(mesh_f, M, args, device, default_timer() - start)


def synthetic(args, device) -> dict:
    """The synthetic mode: the immersed square on a lattice background."""
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    k = int(args.k)
    ref = args.ref
    symmetric = str2bool(args.symmetric)
    if k == 2 and args.pc == 'mg':
        sys.exit("--k 2 --pc mg: a P2 simplex background is no lattice; use "
                 "--pc bjacobi or jacobi")

    n = 8 * 2 ** int(ref)
    n_bg = max(n // 2, 4)
    mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n_bg, degree=k,
                                        n_fields=2, device=device)
    prob = ImmersedElasticityProblem(mesh_f, k=k, sym=symmetric,
                                     device=device)
    solv = 'cg' if args.solv == 'mumps' else args.solv
    pc = ('mg' if k == 1 else 'bjacobi') if args.pc is None else args.pc

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
