"""Preconditioned conjugate gradients (port of ``cg`` in
``iifea_tpu/solvers/krylov.py``).

Iterations run in chunks of ``check_every``; the residual norm is read back
to the host once per chunk (the only host sync of the loop), so a solve may
run up to check_every − 1 iterations past the tolerance. Convergence test:
‖r‖ ≤ max(rtol·‖b‖, atol).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveInfo(NamedTuple):
    """iters: iterations run (a multiple of check_every); resnorm: final
    ‖r‖; converged: resnorm ≤ tol; history: ‖r‖ at each check."""

    iters: int
    resnorm: float
    converged: bool
    history: list


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       minv: Callable | None = None, rtol: float = 1e-8, atol: float = 1e-9,
       max_it: int = 10000, check_every: int = 8):
    minv = minv or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(rtol * float(torch.linalg.vector_norm(b)), atol)
    chunk = max(int(check_every), 1)

    r = b - matvec(x)
    z = minv(r)
    p = z
    rz = torch.dot(r, z)
    it = 0
    rn = float(torch.linalg.vector_norm(r))
    history = [rn]
    while rn > tol and it < max_it:
        for _ in range(chunk):
            Ap = matvec(p)
            pAp = torch.dot(p, Ap)
            # guard division blowups when a chunk over-iterates a solved
            # system; the selects stay on the device (no sync)
            alpha = torch.where(pAp != 0, rz / torch.where(pAp != 0, pAp, 1.0),
                                0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = minv(r)
            rz_new = torch.dot(r, z)
            beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1.0),
                               0.0)
            p = z + beta * p
            rz = rz_new
        it += chunk
        rn = float(torch.linalg.vector_norm(r))
        history.append(rn)
    return x, SolveInfo(it, rn, rn <= tol, history)
