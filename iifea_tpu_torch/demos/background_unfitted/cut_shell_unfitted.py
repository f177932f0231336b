"""Cut Kirchhoff-Love shell with an explicit B-spline background (port of
``demos/background_unfitted/cut_shell_unfitted.py``).

The trimmed 'bent tab' (unit square minus big circle minus lower
rectangle, plus small circle and upper neck) is the immersed block of a
structured P2 mesh of [−1, 1]²; the midsurface is F = [ξ0, ξ1, ½(1−ξ0²)];
the background is the native quadratic B-spline space. A follower pressure
raised over ``--steps`` load steps, the edges x = ±1 pinned; Newton with
host LU of Mᵀ A_f M. Runs on the GPU unless ``--device cpu`` is given.

    python3 -m iifea_tpu_torch.demos.background_unfitted.cut_shell_unfitted --ref 4 --steps 10
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref', dest='ref', default='4', help='Refinement level')
    p.add_argument('--p', dest='p', default=2, help='B-spline degree')
    p.add_argument('--steps', dest='steps', default=10,
                   help='Load steps (reference: 100)')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def tab_material(x, y):
    """Block (2) or not (1) of points (x, y): the trimmed geometry."""
    r2 = x**2 + y**2
    mat = np.ones_like(x, dtype=np.int32)
    cut = (r2 < 0.25) | ((y < 0) & (np.abs(x) < 0.2) & (r2 >= 0.25))
    keep = (r2 < 0.0625) | ((r2 >= 0.0625) & (r2 < 0.25) & (y > 0)
                            & (np.abs(x) < 0.1))
    mat[cut] = 0
    mat[cut & keep] = 1
    return np.where(mat > 0, 2, 1).astype(np.int32)


def tab_mesh(n: int):
    from iifea_tpu_torch.mesh.core import Mesh
    from iifea_tpu_torch.mesh.generators import rectangle_mesh

    mesh_f = rectangle_mesh((-1.0, -1.0), (1.0, 1.0), n, n)
    cent = mesh_f.cell_coords.mean(1)
    return Mesh(mesh_f.coords, mesh_f.cells,
                tab_material(cent[:, 0], cent[:, 1]))


def bent_tab_surface(xi):
    return torch.stack([xi[0], xi[1], 0.5 * (1.0 - xi[0] ** 2)])


PROBLEM = dict(E=3e4, nu=0.3, h_th=0.03, pressure=2.0, pin_alpha=1e5,
               pin_mode="boundary", pin_alpha_scale="hmin", use_jvol=True)
NEWTON = dict(max_iters=100, linear_method='direct', monitor_newton=False)
T_MAX = 1.0


def main(argv=None) -> dict:
    """Run the demo; returns the tip displacement, per load step the
    Newton record (one dict of stage seconds per iteration), and the stage
    seconds."""
    from iifea_tpu_torch.mesh.bspline import BSplineSpace2D
    from iifea_tpu_torch.models.kl_shell import KLShellProblem
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.solvers.newton import recording
    from iifea_tpu_torch.utils.logging import log_info
    from iifea_tpu_torch.utils.profiling import Timings, timed

    args = parse_args(argv)
    ref, p, n_steps = int(args.ref), int(args.p), int(args.steps)
    device = torch.device(args.device)
    stages = Timings()

    with timed(stages, "setup"):
        n = 8 * 2 ** ref
        prob = KLShellProblem(tab_mesh(n), bent_tab_surface, device=device,
                              **PROBLEM)
        spline = BSplineSpace2D(p, (max(n // 2, 4),) * 2, (-1.0, -1.0),
                                (1.0, 1.0))
        M = spline.transfer_matrix(np.asarray(prob.space.node_coords),
                                   n_fields=3, device=device)
    log_info(f"B-spline background: {spline.ncp} control net; "
             f"fg {prob.space.n_dofs} dofs")

    delta_t = T_MAX / float(n_steps)
    t = 0.0
    u_p = torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=device)
    u_f = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    steps = []
    with timed(stages, "newton"):
        for i in range(n_steps):
            log_info(f"------- Step: {i+1} , t = {t} -------")
            with recording([]) as record:
                u_p, u_f = solve_nonlinear(prob.form, u_f, M, u_p,
                                           params={"t": t}, **NEWTON)
            steps.append(record)
            t += delta_t

    tip = prob.evaluate(u_f, [[0.0, -0.25]])[0]
    log_info(f"Displacement at tip of tab: ( {tip[0]} , {tip[1]} , "
             f"{tip[2]} )")
    return {"tip": tuple(float(v) for v in tip),
            "newton_iters": [len(s) for s in steps], "record": steps,
            "stage_seconds": dict(stages), "u_p": u_p, "u_f": u_f,
            "prob": prob, "M": M}


if __name__ == "__main__":
    main()
