"""2D Taylor-Green vortex, VMS-stabilised unsteady Navier-Stokes (port of
the synthetic mode of ``demos/tg_vortex.py``: the same flags, the same
printed report and CSV line).

    python3 -m iifea_tpu_torch.demos.tg_vortex --k 1 --ref 2 \\
        --mesh-root synthetic --solv gmres --pc mg --pin-pressure True

Synthetic mode: ``TaylorGreenProblem`` on the generated immersed square
(n_fg = 8·2^ref, n_bg = n_fg/2) with three fields per node, midpoint steps
of Dt ≈ 4/sqrt(cells) up to --T, every step a Newton solve; with
``--pc mg`` each linearised solve runs three-field block multigrid on the
(n_bg+1)² lattice (the stencil kernels on a card). Runs on the GPU unless
``--device cpu`` is given. Under a mesh root, the reference's files
``square/Linear/R{ref}`` (``square/Quadratic/R{ref}`` for --k 2), M from
their ``ExOp_Cons.csv`` (``mesh.xdmf`` needs h5py); their background is no
lattice, so ``--pc mg`` is refused there. ``--ckpt`` checkpoints are the
JAX demo's files (the state is the ``up_p``/``up_old_f`` pair), so a run
resumes across the two packages; ``--wv`` writes
``tg_results/fields.pvd``.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--k', dest='k', default=1,
                   help='Polynomial degree (1 or 2).')
    p.add_argument('--ref', dest='ref', default='0',
                   help='Refinement level, integers in (0,6) for 2D')
    p.add_argument('--Re', dest='Re', default=100.0, help='Reynolds number.')
    p.add_argument('--T', dest='T', default=1.0,
                   help='Length of time interval to consider.')
    p.add_argument('--sym', dest='symmetric', default=False,
                   help='True for symmetric Nitsche; False for nonsymmetric')
    p.add_argument('--wf', dest='wf', default=False,
                   help='write output to file')
    p.add_argument('--of', dest='of', default='error_data_tg.csv',
                   help='output file to write error data to')
    p.add_argument('--solv', dest='solv', default='gmres',
                   help='Linear solver for the Newton updates')
    p.add_argument('--pc', dest='pc', default='jacobi',
                   help="Preconditioner; 'mg' = block geometric multigrid "
                        "on the background lattice")
    p.add_argument('--ckpt', dest='ckpt', default=None,
                   help='Checkpoint directory: resume from latest, save '
                        'every --ckpt-every steps')
    p.add_argument('--ckpt-every', dest='ckpt_every', default=10,
                   help='Checkpoint interval in time steps')
    p.add_argument('--line-search', dest='line_search', default=False,
                   action='store_true',
                   help='Backtracking line search on ||R|| inside Newton')
    p.add_argument('--ptc', dest='ptc', type=float, default=None,
                   help='Pseudo-transient continuation sigma0: each Newton '
                        'solve uses A + sigma_k|diag A|')
    p.add_argument('--bfr', dest='bfr', type=float, default=None,
                   help='basis-function-removal diagonal tolerance')
    p.add_argument('--pin-pressure', dest='pin_pressure', default=False,
                   help="Pin one supported pressure dof (removes the "
                        "enclosed-flow constant-pressure null mode; "
                        "recommended with --pc mg)")
    p.add_argument('--mesh-root', dest='mesh_root', default='synthetic',
                   help="root of the reference mesh files (square/...), or "
                        "'synthetic' for a generated immersed square on a "
                        "lattice background (enables --pc mg)")
    p.add_argument('--wv', dest='wv', default=False,
                   help='write a ParaView velocity/pressure series '
                        '(tg_results/fields.pvd), one snapshot per '
                        '--wv-every steps')
    p.add_argument('--wv-every', dest='wv_every', default=1,
                   help='snapshot interval in time steps for --wv')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def pressure_pin(prob, M, up_f, up_old_f, t: float = 0.0) -> np.ndarray:
    """The background pressure dof (field 2 of the field-blocked layout)
    with the largest diagonal of the operator at time t (the demo takes
    t = 0, before the first step). An extraction weight alone is not
    enough: a dof M references can still have a zero diagonal when the
    foreground dofs it feeds lie outside the integration domain, and
    pinning such a dead dof leaves the constant-pressure mode in place."""
    from iifea_tpu_torch.ops.projection import BackgroundOperator

    blocks0 = prob.form.jacobian_blocks(up_f, {"up_old": up_old_f},
                                        {"t": t})
    d0 = BackgroundOperator(prob.form, blocks0, M).diag().cpu().numpy()
    nn = M.n_bg_dofs // 3
    return np.array([2 * nn + int(np.argmax(d0[2 * nn:]))])


def step_kwargs(args, lattice_shape, zero_ids) -> dict:
    """``solve_nonlinear``'s settings for one time step: the reference
    demo's Newton tolerances, with the linear solver, preconditioner and
    globalisation the flags ask for."""
    return dict(
        max_iters=10,
        linear_method=args.solv,
        linear_pc=args.pc,
        lattice_shape=lattice_shape if args.pc == 'mg' else None,
        n_fields=3,
        bfr_tol=args.bfr,
        zero_ids=zero_ids,
        monitor_newton=True,
        monitor_linear=False,
        relative_tolerance=5e-4,
        relax_param=1.0,
        absolute_tolerance=1e-4,
        absolute_tolerance_res=1e-5,
        line_search=args.line_search,
        ptc_sigma0=args.ptc,
    )


def main(argv=None) -> dict:
    """Run the demo; returns the error norms, the step count and the final
    state."""
    from iifea_tpu_torch.api import l2_project
    from iifea_tpu_torch.mesh.core import FunctionSpace
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.mesh.io import read_mesh, require_mesh_dir
    from iifea_tpu_torch.models.navier_stokes import (
        TaylorGreenProblem,
        u_exact,
    )
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.utils.logging import log_info

    args = parse_args(argv)
    k = int(args.k)
    ref = args.ref
    Re_num = float(args.Re)
    T = float(args.T)
    symmetric = str2bool(args.symmetric)
    device = torch.device(args.device)

    if args.mesh_root == "synthetic":
        n = 8 * 2 ** int(ref)
        n_bg = max(n // 2, 4)
        mesh_f, M = immersed_square_problem(n_fg=n, n_bg=n_bg, degree=k,
                                            n_fields=3, device=device)
        lattice_shape = (n_bg + 1, n_bg + 1)
        fileName = "synthetic"
    else:
        if args.pc == 'mg':
            sys.exit("--pc mg: the mesh files' background is no lattice; "
                     "use --pc jacobi")
        deg = 'Linear' if k == 1 else 'Quadratic'
        path = os.path.join(args.mesh_root, f"square/{deg}/R{ref}")
        fileName = os.path.join(require_mesh_dir(path), "ExOp_Cons.csv")
        mesh_f = read_mesh(path)
        M = ExtractionOperator.from_exop_csv(
            fileName, FunctionSpace(mesh_f, degree=k).n_nodes, n_fields=3,
            device=device)
        lattice_shape = None

    # midpoint steps, space-time quasi-uniformity
    N = math.sqrt(mesh_f.n_cells)
    Dt_approx = 4 / N
    N_STEPS = int(np.ceil(T / Dt_approx))
    Dt = T / N_STEPS
    prob = TaylorGreenProblem(mesh_f, k=k, Re=Re_num, Dt=Dt, sym=symmetric,
                              n_bg_dofs=M.n_bg_dofs, device=device)
    nu = prob.nu

    def ic_expr(x):
        return torch.cat([u_exact(x, nu, 0.0), torch.zeros_like(x[:1])])

    up_p, up_old_f = l2_project(ic_expr, prob.space, prob.cell_dom, M)
    up_f = up_old_f

    zero_ids = None
    if str2bool(args.pin_pressure):
        zero_ids = pressure_pin(prob, M, up_f, up_old_f)

    t = 0.0
    start_step = 0
    if args.ckpt:
        from iifea_tpu_torch.utils.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        resumed = load_checkpoint(args.ckpt, device=device)
        if resumed is not None:
            start_step, state, meta = resumed
            up_p = state["up_p"]
            up_f = up_old_f = state["up_old_f"]
            t = float(meta["t"])
            log_info(f">>> Resumed from {args.ckpt} at step {start_step}, "
                     f"t = {t}")

    series = None
    if str2bool(args.wv):
        from iifea_tpu_torch.utils.fieldio import PVDSeries

        series = PVDSeries("tg_results/fields.pvd")

        def write_fields(time, u_field):
            # foreground dofs are node-interleaved (u, v, p) triples
            f = u_field.detach().cpu().numpy().reshape(-1, 3)
            series.write(time, prob.space,
                         point_data={"velocity": f[:, :2],
                                     "pressure": f[:, 2]},
                         cell_data={"material": mesh_f.material})

        write_fields(t, up_f)

    kw = step_kwargs(args, lattice_shape, zero_ids)
    for step in range(start_step, N_STEPS):
        log_info(f"======= Time step {step+1}/{N_STEPS} =======")
        t += 0.5 * Dt
        up_p, up_f = solve_nonlinear(prob.form, up_f, M, up_p,
                                     aux={"up_old": up_old_f},
                                     params={"t": t}, **kw)
        up_old_f = up_f
        t += 0.5 * Dt
        if series is not None and (step + 1) % int(args.wv_every) == 0:
            write_fields(t, up_f)
        if args.ckpt and (step + 1) % int(args.ckpt_every) == 0:
            save_checkpoint(args.ckpt, step + 1,
                            {"up_p": up_p, "up_old_f": up_old_f},
                            meta={"t": t})

    norms = prob.error_norms(up_f, t)
    if str2bool(args.wf):
        with open(args.of, 'a') as f:
            f.write("\n")
            f.write(f"{ref},{norms['L2u']},{norms['H1u']},{norms['L2p']},"
                    f"{norms['H1p']},{k},{fileName},{Re_num},{N_STEPS}")

    log_info('-' * 40)
    log_info(f"L2 velocity error: {norms['L2u']}")
    log_info(f"H1 velocity error: {norms['H1u']}")
    log_info(f"L2 pressure error: {norms['L2p']}")
    log_info(f"L2 pressure error (mean-removed): {norms['L2p0']}")
    log_info(f"H1 pressure error: {norms['H1p']}")
    log_info('-' * 40)
    return {"norms": norms, "n_steps": N_STEPS, "t": t, "Dt": Dt,
            "up_p": up_p, "up_f": up_f, "prob": prob, "M": M,
            "step_kwargs": kw}


if __name__ == "__main__":
    main()
