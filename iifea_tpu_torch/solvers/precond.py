"""Pointwise Jacobi preconditioning (port of ``jacobi`` in
``iifea_tpu/solvers/precond.py``). The point-block Jacobi and restricted
additive Schwarz preconditioners wait for the block workloads (ROADMAP.md
item 13)."""
from __future__ import annotations

import torch


def jacobi(diag: torch.Tensor, guard: float = 0.0):
    """PCJACOBI. Diagonal entries with |d| ≤ guard (unsupported background
    basis functions) are replaced by 1, so they act as identity rows."""
    inv = 1.0 / torch.where(diag.abs() > guard, diag, torch.ones_like(diag))

    def minv(x):
        return inv * x

    return minv
