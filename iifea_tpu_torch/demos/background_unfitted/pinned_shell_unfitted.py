"""Pinned Kirchhoff-Love shell with an explicit B-spline background (port of
``demos/background_unfitted/pinned_shell_unfitted.py``).

The foreground is a structured P2 mesh of [−1, 1]² whose block is the
45°-rotated square (the diamond of half-diagonal 1/√2); the background is
the native quadratic B-spline space, with extraction by basis evaluation
at the foreground nodes. A fixed areal load on a flat shell pinned along
the immersed boundary; Newton with host LU of Mᵀ A_f M. Runs on the GPU
unless ``--device cpu`` is given.

    python3 -m iifea_tpu_torch.demos.background_unfitted.pinned_shell_unfitted --ref 4
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ref', dest='ref', default='4',
                   help='Refinement level (foreground 8·2^ref cells per edge)')
    p.add_argument('--p', dest='p', default=2, help='B-spline degree')
    p.add_argument('--device', dest='device', default='cuda',
                   help='torch device: cuda (default) or cpu')
    return p.parse_args(argv)


def flat_surface(xi):
    return torch.stack([xi[0], xi[1], torch.zeros_like(xi[0])])


def diamond_mesh(n: int):
    """[−1, 1]² in n × n squares, the cells whose centroid lies in the
    diamond |x| + |y| ≤ 1 marked as the block (material 2)."""
    from iifea_tpu_torch.mesh.core import Mesh
    from iifea_tpu_torch.mesh.generators import rectangle_mesh

    mesh_f = rectangle_mesh((-1.0, -1.0), (1.0, 1.0), n, n)
    cent = mesh_f.cell_coords.mean(1)
    half = 1.0 / math.sqrt(2.0)
    inside = (np.abs(cent[:, 0]) + np.abs(cent[:, 1])) <= half * math.sqrt(2.0)
    return Mesh(mesh_f.coords, mesh_f.cells,
                np.where(inside, 2, 1).astype(np.int32))


# the problem's constants and the Newton settings of the reference demo
PROBLEM = dict(E=4.8e5, nu=0.38, h_th=0.1, areal_force=90.0, pin_alpha=1e6,
               pin_mode="interface", pin_alpha_scale="h_facet",
               use_jvol=False)
NEWTON = dict(max_iters=20, linear_method='direct', monitor_newton=True,
              relative_tolerance=5e-4, absolute_tolerance=1e-4,
              absolute_tolerance_res=1e-5)


def main(argv=None) -> dict:
    """Run the demo; returns the centre displacement, the Newton record
    (one dict of stage seconds per iteration) and the stage seconds."""
    from iifea_tpu_torch.mesh.bspline import BSplineSpace2D
    from iifea_tpu_torch.models.kl_shell import KLShellProblem
    from iifea_tpu_torch.solvers import solve_nonlinear
    from iifea_tpu_torch.solvers.newton import recording
    from iifea_tpu_torch.utils.logging import log_info
    from iifea_tpu_torch.utils.profiling import Timings, timed

    args = parse_args(argv)
    ref, p = int(args.ref), int(args.p)
    device = torch.device(args.device)
    stages = Timings()

    with timed(stages, "setup"):
        n = 8 * 2 ** ref
        prob = KLShellProblem(diamond_mesh(n), flat_surface, device=device,
                              **PROBLEM)
        spline = BSplineSpace2D(p, (max(n // 2, 4),) * 2, (-1.0, -1.0),
                                (1.0, 1.0))
        M = spline.transfer_matrix(np.asarray(prob.space.node_coords),
                                   n_fields=3, device=device)
    log_info(f"B-spline background: {spline.ncp} control net, "
             f"{M.n_bg_dofs} dofs; fg {prob.space.n_dofs} dofs")

    with timed(stages, "newton"), recording([]) as record:
        u_p, u_f = solve_nonlinear(
            prob.form,
            torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                        device=device),
            M, torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=device),
            **NEWTON)

    u_x, u_y, u_z = prob.evaluate(u_f, [[0.0, 0.0]])[0]
    log_info(f"Center displacement: ( {u_x} , {u_y} , {u_z} )")
    return {"disp": (float(u_x), float(u_y), float(u_z)),
            "newton_iters": len(record), "record": record,
            "stage_seconds": dict(stages), "u_p": u_p, "u_f": u_f,
            "prob": prob, "M": M}


if __name__ == "__main__":
    main()
