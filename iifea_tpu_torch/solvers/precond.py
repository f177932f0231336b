"""Pointwise and point-block Jacobi preconditioning (port of ``jacobi`` and
``block_jacobi`` in ``iifea_tpu/solvers/precond.py``). Restricted additive
Schwarz (``pc='asm'``) is not ported yet (ROADMAP.md item 13b)."""
from __future__ import annotations

import torch


def jacobi(diag: torch.Tensor, guard: float = 0.0):
    """PCJACOBI. Diagonal entries with |d| ≤ guard (unsupported background
    basis functions) are replaced by 1, so they act as identity rows."""
    inv = 1.0 / torch.where(diag.abs() > guard, diag, torch.ones_like(diag))

    def minv(x):
        return inv * x

    return minv


def block_jacobi(diag_blocks: torch.Tensor):
    """Point-block Jacobi (PCBJACOBI): ``diag_blocks`` (m, nf, nf) are the
    per-node field-coupling blocks; vectors are field-blocked, so a length
    nf·m vector reshapes to (nf, m).

    Zero diagonal entries (unsupported nodes) are patched to 1 before the
    inversion; a block whose inverse still fails (singular, or a non-finite
    entry) falls back to its diagonal inverse, as in the reference."""
    nf = diag_blocks.shape[-1]
    d = torch.diagonal(diag_blocks, dim1=1, dim2=2)           # (m, nf)
    safe_d = torch.where(d.abs() > 0, d, torch.ones_like(d))
    patched = diag_blocks.clone()
    torch.diagonal(patched, dim1=1, dim2=2).copy_(safe_d)
    inv, info = torch.linalg.inv_ex(patched)
    eye = torch.eye(nf, dtype=diag_blocks.dtype, device=diag_blocks.device)
    ok = (info == 0) & torch.isfinite(inv).all(dim=(1, 2))
    inv = torch.where(ok[:, None, None], inv, eye * (1.0 / safe_d)[:, :, None])

    def minv(x):
        xb = x.reshape(nf, -1)                                # [field, node]
        return torch.einsum("nab,bn->an", inv, xb).reshape(-1)

    return minv
