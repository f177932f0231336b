#!/usr/bin/env python3
"""The 3D cubic (radius-4) cycles' iterations, and the 3D biharmonic's host
set-up of two checkouts, on one card.

    python3 tests/compare_cubic3.py --iters 14,30
        the 3D cubic biharmonic (``immersed_cube_bspline_problem(n_fg=2·n_bg,
        n_bg, bg_degree=3)``) at each n_bg by ``solve_ksp(gmres, pc='mg',
        stencil_radius=4)``, the f64 route to 1e-10 (at most 40,000
        iterations) and the f32 mixed route (at most 3,000), then the
        three-field cubic elasticity on the 9³ net to 1e-10 with its
        foreground field against host SuperLU's: iterations, seconds,
        residual reached, error norms, one JSON line each;
    python3 tests/compare_cubic3.py --setup-trees PARENT_DIR,.
        the host set-up of ``chip_smoke.py``'s ``biharmonic3`` phase
        (n_bg = 63) per stage, each checkout in a process of its own, in
        turns (A, B, B, A); PARENT_DIR is a ``git archive`` of another
        commit in a git-ignored directory such as ``build/parent``.

Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iters(n_bgs):
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from iifea_tpu_torch.solvers import ksp

    gpu = torch.device("cuda", 0)
    for n_bg in n_bgs:
        prob, M, shape, A, b, secs, _ = cs.build_biharmonic3(n_bg, gpu, 3)
        for mixed, cap in ((False, 40000), (True, 3000)):
            (u, info), dt = cs.sync_time(lambda: cs.bh_solve(
                A, b, shape, radius=4, mixed=mixed, max_it=cap))
            print(json.dumps({
                "problem": "biharmonic3", "n_bg": n_bg, "mixed": mixed,
                "max_it": cap, "iters": int(info.iters), "seconds": dt,
                "rel_residual": cs.rel_residual(A, b, u),
                "error_norms": prob.error_norms(M.mv(u)),
                "setup_seconds": secs}), flush=True)
        del prob, M, A, b
        torch.cuda.empty_cache()
    prob, M, shape, A, b, _ = cs.bspline_elasticity(6, "cuda", 3, 3)
    (u, info), dt = cs.sync_time(lambda: cs.bspline_el_solve(
        A, b, shape, 3, radius=4, max_it=100000))
    u_lu, _ = ksp.solve_ksp(A, b, method="direct", monitor=False)
    field = cs.field_norms(prob, M, u_lu)[1]
    print(json.dumps({
        "problem": "elasticity3", "n_bg": 6, "iters": int(info.iters),
        "seconds": dt, "rel_residual": cs.rel_residual(A, b, u),
        "field_rel_diff_lu": field(u - u_lu) / field(u_lu)}), flush=True)


def setup_one(tree):
    """The set-up of one checkout, in this process (``--setup-one``)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    t = time.perf_counter()
    _, _, _, _, _, secs, mem = cs.build_biharmonic3(63, torch.device("cuda",
                                                                    0))
    print(json.dumps({"tree": tree, "seconds_total": time.perf_counter() - t,
                      "seconds": secs, **mem}), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--iters"] and len(args) == 2:
        iters([int(v) for v in args[1].split(",")])
    elif args[:1] == ["--setup-trees"] and len(args) == 2:
        a, b = args[1].split(",")
        for tree in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--setup-one",
                 tree], capture_output=True, text=True)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("{")]
            print(lines[-1] if lines else json.dumps(
                {"tree": tree, "error": out.stderr[-2000:]}), flush=True)
    elif args[:1] == ["--setup-one"] and len(args) == 2:
        setup_one(args[1])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
