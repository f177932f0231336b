"""Basis-function removal (BFR) as a mask (port of
``iifea_tpu/solvers/trim.py``).

Background basis functions whose projected diagonal is ≤ bfr_tol (a signed
comparison, as the reference's ``D.getValue(ind) <= bfr_tol``) become
identity rows; their rhs entry becomes 0 or a target value. The operator
applies ``where(mask, x, A x)`` (``BackgroundOperator.with_trim``).
"""
from __future__ import annotations

import torch


def trim_mask_from_diag(diag: torch.Tensor, bfr_tol: float) -> torch.Tensor:
    return diag <= bfr_tol


def mask_from_ids(ids, n: int, device="cuda") -> torch.Tensor:
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.as_tensor(ids, dtype=torch.int64, device=device)] = True
    return mask


def apply_trim_rhs(b: torch.Tensor, mask: torch.Tensor,
                   target=None) -> torch.Tensor:
    tgt = torch.zeros_like(b) if target is None else target
    return torch.where(mask, tgt, b)
