"""Galerkin projection onto the background basis, A_b = Mᵀ A_f M (port of
``BackgroundOperator.mv`` in ``iifea_tpu/ops/projection.py``).

Matrix-free: A_b x = Mᵀ(A_f(M x)), composed from the extraction ELL ops and
the element-block matvec. This is the exact operator of the projected
system, which the 3D lattice solve refines its f64 residual against.
"""
from __future__ import annotations

import torch

from iifea_tpu_torch.ops.assembly import Form
from iifea_tpu_torch.ops.extraction import ExtractionOperator


class BackgroundOperator:
    """The linearized background operator Mᵀ A_f M from element blocks.

    Both scatters (``Form.matvec`` onto foreground dofs and ``M.rmv`` onto
    background dofs) are ``index_add_``: on CUDA the order in which several
    contributions add onto one dof is not fixed, so ``mv`` may differ in the
    last bits of f64 from run to run."""

    def __init__(self, form: Form, blocks: list[torch.Tensor],
                 M: ExtractionOperator):
        self.form = form
        self.blocks = blocks
        self.M = M
        self.n = M.n_bg_dofs

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.M.rmv(self.form.matvec(self.blocks, self.M.mv(x)))
