#!/usr/bin/env python3
"""The coarse pseudo-inverse's arithmetic against the CG iteration count on
a single-level hierarchy, where the coarsest level's dense Newton–Schulz
pseudo-inverse (``ops/multigrid._pinv``) is the whole preconditioner.

For the 3D immersed Poisson problem at ``--n-bg`` (default 8: one 9³ level)
through ``BinnedLatticeSolver`` on ``--device``, prints one JSON line with

* the coarse matrix's size, largest and smallest nonzero singular values
  (host f64 SVD);
* for the Newton–Schulz iteration run in f32 and in f64 (the result cast to
  f32): ‖X − X_ref‖/‖X_ref‖ against the f64 iterate, the projector defect
  ‖A X A − A‖/‖A‖ measured in f64, and the f32 MG-PCG iterations of the
  solver's refinement loop to a 1e-10 f64 residual with that coarse
  inverse;
* the iterations of the same solve on the host, for comparison;
* with ``--sweep``, the same for 24 … 60 Newton–Schulz steps in each
  arithmetic (``sweep``: [dtype, steps, CG iterations, max|X|]).

Run on the card:   python3 tests/compare_coarse_pinv.py --device cuda
and on the host:   python3 tests/compare_coarse_pinv.py --device cpu
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from iifea_tpu_torch.mesh.generators import immersed_cube_problem  # noqa: E402
from iifea_tpu_torch.models.poisson import PoissonProblem  # noqa: E402
from iifea_tpu_torch.ops import multigrid  # noqa: E402
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver  # noqa: E402


def build(n_bg: int, device):
    n_fg = int(n_bg * 1.26) // 2 * 2
    mesh, M = immersed_cube_problem(n_fg=n_fg, n_bg=n_bg, device=device)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=device)
    return BinnedLatticeSolver(prob, M, (n_bg + 1,) * 3, device=device)


def dense_matrix(S) -> torch.Tensor:
    """The coarsest operator as ``_dense_inverse3`` forms it."""
    A = S.mv_ref(torch.eye(S.n, dtype=S.dtype, device=S.device)).T
    d = torch.diagonal(A)
    return A + torch.diag((d.abs() == 0).to(A.dtype))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-bg", type=int, default=8)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)

    solver = build(args.n_bg, dev)
    b64, Kc, Kf = solver.assemble()
    bound = solver.bind(Kc, Kf)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    if len(mg.levels) != 1:
        raise SystemExit(f"n_bg={args.n_bg} gives {len(mg.levels)} levels; "
                         "the single-level case needs n_bg <= 8")
    A32 = dense_matrix(S32)
    A64 = A32.to(torch.float64)
    sv = torch.linalg.svdvals(A64.cpu())
    nz = sv[sv > 1e-12 * sv[0]]
    X_ref = multigrid._pinv(A64, dtype=torch.float64)
    out = {"device": str(dev), "n_bg": args.n_bg, "n": S32.n,
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "sigma_max": float(sv[0]), "sigma_min_nonzero": float(nz[-1]),
           "rank": int(len(nz)), "cond": float(sv[0] / nz[-1])}
    for name, dt in (("newton_schulz_f32", torch.float32),
                     ("newton_schulz_f64", torch.float64)):
        X = multigrid._pinv(A32, dtype=dt)              # an f32 matrix
        X64 = X.to(torch.float64)
        mg.coarse_inv = X
        _, relres, iters = solver.refine(S32, mg, bound, b64, 1e-10)
        out[name] = {
            "rel_diff_to_f64": float(torch.linalg.matrix_norm(X64 - X_ref)
                                     / torch.linalg.matrix_norm(X_ref)),
            "projector_defect": float(
                torch.linalg.matrix_norm(A64 @ X64 @ A64 - A64)
                / torch.linalg.matrix_norm(A64)),
            "cg_iters": iters, "rel_residual": relres}
    if args.sweep:
        out["sweep"] = []
        for dt in (torch.float32, torch.float64):
            for steps in (24, 32, 36, 40, 44, 50, 60):
                mg.coarse_inv = multigrid._pinv(A32, iters=steps, dtype=dt)
                _, relres, iters = solver.refine(S32, mg, bound, b64, 1e-10)
                out["sweep"].append([str(dt), steps, iters,
                                     float(mg.coarse_inv.abs().max())])
    if dev.type != "cpu":
        _, info = build(args.n_bg, torch.device("cpu")).solve(rtol=1e-10)
        out["host_solve"] = info
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
