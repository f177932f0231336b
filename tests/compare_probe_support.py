#!/usr/bin/env python3
"""Time the stacked application behind the coloured general probe on a
card, in turns: ``BackgroundOperator.mv_multi`` (the extraction M gathered
and scattered on the form's support rows only) against the same product
over every foreground row, ``M.rmv_multi(form.matvec_multi(blocks,
M.mv_multi(X)))``, on the 3D biharmonic's operator (``demos/biharmonic.py
--dim 3``'s problem) at each ``--n-bg``. Prints one JSON line per size: the
support's rows against the foreground's, the median seconds of each form
for ``--cols`` probe columns, and their largest difference relative to the
largest entry.

    python3 tests/compare_probe_support.py [--n-bg 31,63] [--cols 2]
        [--pairs 3] [--device cuda]

Imports no JAX.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from iifea_tpu_torch.mesh.generators import (  # noqa: E402
    immersed_cube_bspline_problem,
)
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem  # noqa: E402
from iifea_tpu_torch.ops.projection import (  # noqa: E402
    assemble_background_system,
)
from iifea_tpu_torch.ops.stencil import _combs  # noqa: E402


def timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n-bg", default="31,63")
    p.add_argument("--cols", type=int, default=2)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    device = torch.device(args.device)
    for n_bg in map(int, args.n_bg.split(",")):
        mesh, M, shape = immersed_cube_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg, device=device)
        prob = BiharmonicProblem(mesh, device=device)
        A, _ = assemble_background_system(
            prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                                   device=device), M)
        # colours from the middle of the 343 (a corner colour may miss the
        # block on a small net)
        X = _combs(shape, 3, torch.float64, device)[171:171 + args.cols]

        def every_row():
            return M.rmv_multi(prob.form.matvec_multi(A.blocks,
                                                      M.mv_multi(X)))

        (rows, _, _), t_support = timed(A.support, device)
        times = {"support": [], "every_row": []}
        for _ in range(args.pairs):
            for name, fn in (("support", lambda: A.mv_multi(X)),
                             ("every_row", every_row)):
                out, dt = timed(fn, device)
                times[name].append(dt)
                if name == "support":
                    y_support = out
                else:
                    y_all = out
        diff = float((y_support - y_all).abs().max()
                     / y_all.abs().max().clamp_min(1e-300))
        print(json.dumps({
            "n_bg": n_bg, "device": str(device),
            "card": (torch.cuda.get_device_name(0)
                     if device.type == "cuda" else None),
            "columns": args.cols, "support_rows": int(rows.numel()),
            "foreground_rows": M.n_fg_dofs,
            "support_build_seconds": t_support,
            "seconds": {k: sorted(v)[len(v) // 2] for k, v in times.items()},
            "runs": times, "max_rel_diff": diff}), flush=True)
        del A, M, prob, mesh, X, y_support, y_all
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
