"""Kirchhoff-Love shell: the cut 'bent tab' under a uniform follower
pressure raised over ``--steps`` load steps, on the reference's mesh files
(port of ``demos/cut_shell.py``: the same flags and tracker-point CSVs).

    python3 -m iifea_tpu_torch.demos.cut_shell --mesh-root MESHES --ref 5

Reads ``bent_tab/FG_R{lref}/R{ref}`` under the mesh root (P2 on the files'
Exodus node ids; ``mesh.xdmf`` needs h5py) and M (three fields) from its
``ExOp_Cons.csv``; the midsurface is F = [ξ0, ξ1, ½(1−ξ0²)], the block's
boundary pinned; Newton with host LU of Mᵀ A_f M in every load step. It
prints, per load step, the displacement of the three tracker points
(circle tip, wing top and bottom corners), and with ``--of True`` writes
their histories to ``bent_shell_results/*.csv``. ``--ckpt DIR`` resumes
from and saves checkpoints (the JAX demo's files), ``--wv True`` writes
``bent_shell_results/disp.pvd`` on the mapped midsurface. Runs on the GPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from iifea_tpu_torch.demos.background_unfitted.cut_shell_unfitted import (
    PROBLEM,
    T_MAX,
    bent_tab_surface,
)

# tracker points of the reference demo
TRACKERS = {"circle_tip": [0.0, -0.25],
            "wing_top_corner": [-0.2, -math.sqrt(0.5 ** 2 - 0.2 ** 2)],
            "wing_bottom_corner": [-0.2, -1.0]}


def str2bool(v):
    return str(v) not in ("False", "false", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref', dest='ref', default='3',
                   help='Refinement level, integers in (3,6)')
    p.add_argument('--lref', dest='lref', default='0',
                   help='Local refinement level, integers in (0,2)')
    p.add_argument('--of', dest='of', default='False',
                   help='Output result files')
    p.add_argument('--steps', dest='steps', default=100,
                   help='Number of load steps (reference: 100)')
    p.add_argument('--ckpt', dest='ckpt', default=None,
                   help='Checkpoint directory: resume from latest, save '
                        'every --ckpt-every load steps')
    p.add_argument('--ckpt-every', dest='ckpt_every', default=10,
                   help='Checkpoint interval in load steps')
    p.add_argument('--wv', dest='wv', default=False,
                   help='write a ParaView displacement series '
                        '(bent_shell_results/disp.pvd) on the mapped '
                        'midsurface, one snapshot per load step')
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
    """Run the demo; returns the tracker histories ({name: (steps, 3)}),
    per load step the Newton record (one dict of stage seconds per
    iteration), and the state."""
    from torch.func import vmap

    from iifea_tpu_torch.mesh.io import read_mesh, require_mesh_dir
    from iifea_tpu_torch.models.kl_shell import KLShellProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.solvers.newton import recording
    from iifea_tpu_torch.utils.logging import log_info

    args = parse_args(argv)
    device = torch.device(args.device)
    n_steps = int(args.steps)
    path = require_mesh_dir(os.path.join(
        args.mesh_root, f"bent_tab/FG_R{args.lref}/R{args.ref}"))
    mesh_f = read_mesh(path)
    prob = KLShellProblem(mesh_f, bent_tab_surface, device=device, **PROBLEM)
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes, n_fields=3,
        device=device)

    delta_t = T_MAX / float(n_steps)
    t = 0.0
    u_p = torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=device)
    u_f = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    hist = {name: np.zeros((n_steps, 3)) for name in TRACKERS}

    start_step = 0
    if args.ckpt:
        from iifea_tpu_torch.utils.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        resumed = load_checkpoint(args.ckpt, device=device)
        if resumed is not None:
            start_step, state, meta = resumed
            u_p, u_f = state["u_p"], state["u_f"]
            ns = min(start_step, n_steps)
            for name, key in zip(TRACKERS, ("tip_hist", "top_hist",
                                            "bot_hist")):
                hist[name][:ns] = state[key].cpu().numpy()[:ns]
            t = float(meta["t"])
            log_info(f">>> Resumed from {args.ckpt} at load step "
                     f"{start_step}, t = {t}")

    series = None
    if str2bool(args.wv):
        from iifea_tpu_torch.utils.fieldio import PVDSeries

        series = PVDSeries("bent_shell_results/disp.pvd")
        # the mapped 3D midsurface as the geometry (the mesh is 2D)
        surf_pts = vmap(bent_tab_surface)(torch.as_tensor(
            prob.space.node_coords, dtype=torch.float64)).numpy()

    log_info(">>> Solving load steps...")
    steps = []
    for i in range(start_step, n_steps):
        log_info(f"------- Step: {i+1} , t = {t} -------")
        with recording([]) as record:
            u_p, u_f = solve_nonlinear(
                prob.form, u_f, M, u_p, params={"t": t}, max_iters=100,
                linear_method='direct', monitor_newton=False,
                line_search=args.line_search, ptc_sigma0=args.ptc)
        steps.append(record)
        t += delta_t
        for name, point in TRACKERS.items():
            hist[name][i] = prob.evaluate(u_f, [point])[0]
            log_info(f"{name}: ( {hist[name][i][0]} , {hist[name][i][1]} "
                     f", {hist[name][i][2]} )")
        if series is not None:
            series.write(t, prob.space, point_data={"disp": u_f},
                         cell_data={"material": mesh_f.material},
                         points=surf_pts)
        if args.ckpt and (i + 1) % int(args.ckpt_every) == 0:
            save_checkpoint(args.ckpt, i + 1,
                            {"u_p": u_p, "u_f": u_f,
                             "tip_hist": hist["circle_tip"],
                             "top_hist": hist["wing_top_corner"],
                             "bot_hist": hist["wing_bottom_corner"]},
                            meta={"t": t})

    if str2bool(args.of):
        os.makedirs("bent_shell_results", exist_ok=True)
        for name, h in hist.items():
            np.savetxt(f"bent_shell_results/{name}.csv", h, delimiter=",",
                       header="d0,d1,d2", comments="")

    u_x, u_y, u_z = hist["circle_tip"][-1]
    log_info(f"Displacement at tip of tab: ( {u_x} , {u_y} , {u_z} )")
    return {"tip": (float(u_x), float(u_y), float(u_z)), "hist": hist,
            "newton_iters": [len(s) for s in steps], "record": steps,
            "u_p": u_p, "u_f": u_f, "prob": prob, "M": M}


if __name__ == "__main__":
    main()
