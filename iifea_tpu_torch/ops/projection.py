"""Galerkin projection onto the background basis, A_b = Mᵀ A_f M (port of
``iifea_tpu/ops/projection.py``).

Matrix-free: A_b x = Mᵀ(A_f(M x)), composed from the extraction ELL ops and
the element-block matvec. What needs explicit structure:

* the exact diagonal of A_b (Jacobi preconditioning, BFR trimming) and
  its per-node field blocks (point-block Jacobi), computed on the device
  per element block in chunks;
* the explicit A_b as a host scipy CSR matrix for the sparse direct solve.

``assemble_background_system`` linearizes a Form around a foreground state
and returns (A_b, b_b): the solver front-end's entry point.
"""
from __future__ import annotations

import numpy as np
import torch

from iifea_tpu_torch.ops.assembly import Form
from iifea_tpu_torch.ops.extraction import ExtractionOperator


class BackgroundOperator:
    """The linearized background operator Mᵀ A_f M from element blocks,
    optionally BFR-trimmed and shifted.

    With a trim mask t, application reproduces PETSc ``zeroRows``: trimmed
    rows become identity rows, other rows keep their (untrimmed) column
    entries. ``shift`` (n_bg,) applies A + diag(shift); trim overrides shift
    on trimmed rows.

    The scatters (``Form.matvec`` onto foreground dofs, ``M.rmv`` onto
    background dofs, the diagonal's) are ``index_add_``: on CUDA their order
    is not fixed, so f64 results may differ in the last bits from run to
    run."""

    def __init__(self, form: Form, blocks: list[torch.Tensor],
                 M: ExtractionOperator, trim_mask: torch.Tensor | None = None,
                 shift: torch.Tensor | None = None):
        self.form = form
        self.blocks = blocks
        self.M = M
        self.n = M.n_bg_dofs
        self.trim_mask = trim_mask
        self.shift = shift
        self._support = None

    def support(self):
        """(rows, idx, val): the foreground dofs the form's terms touch, in
        ascending order, and M's ELL planes on them ((kmax, len(rows))
        each); built once per operator. A stacked application needs M on
        those rows only: a foreground larger than the block (the 3D
        biharmonic's 16.2 M P2 nodes against the 3.6 M of its block
        cells) would otherwise gather and scatter every row."""
        if self._support is None:
            rows = torch.unique(torch.cat([
                dom.eldofsT.reshape(-1) for dom, _ in self.form.terms]))
            self._support = (rows, self.M.idxT[:, rows].contiguous(),
                             self.M.valT[:, rows].contiguous())
        return self._support

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        y = self.M.rmv(self.form.matvec(self.blocks, self.M.mv(x)))
        if self.shift is not None:
            y = y + self.shift * x
        if self.trim_mask is not None:
            y = torch.where(self.trim_mask, x, y)
        return y

    def mv_multi(self, X: torch.Tensor) -> torch.Tensor:
        """Stacked application to k vectors, (k, n_bg) -> (k, n_bg): one
        gather, element product and scatter for all of them (the stencil
        probe's path). M and Mᵀ run on the rows of ``support`` only: the
        form reads and writes no other foreground dof, so the result is
        that of ``M.rmv_multi(form.matvec_multi(blocks, M.mv_multi(X)))``
        up to rounding (the scatter skips exact zeros; the slot sums of the
        gather may group differently)."""
        rows, idx, val = self.support()
        k = X.shape[0]
        U_rows = (val[None] * X[:, idx]).sum(dim=1)
        U = torch.zeros((k, self.form.n_dofs), dtype=U_rows.dtype,
                        device=U_rows.device)
        U[:, rows] = U_rows
        R = self.form.matvec_multi(self.blocks, U)[:, rows]
        data = (val[None] * R[:, None, :]).reshape(k, -1)
        Y = torch.zeros((k, self.n), dtype=data.dtype, device=data.device)
        Y.index_add_(1, idx.reshape(-1), data)
        if self.shift is not None:
            Y = Y + self.shift[None, :] * X
        if self.trim_mask is not None:
            Y = torch.where(self.trim_mask[None, :], X, Y)
        return Y

    def mv_t(self, x: torch.Tensor) -> torch.Tensor:
        """Transpose application (condition estimation). With trimming, the
        transpose of the row substitution zeroes the trimmed columns of Aᵀ
        and keeps unit diagonals."""
        xi = (x if self.trim_mask is None
              else torch.where(self.trim_mask, 0.0, x))
        y = self.M.rmv(self.form.matvec_t(self.blocks, self.M.mv(xi)))
        if self.shift is not None:
            y = y + self.shift * xi
        if self.trim_mask is not None:
            y = y + torch.where(self.trim_mask, x, 0.0)
        return y

    def with_trim(self, mask) -> "BackgroundOperator":
        return self._like(mask, self.shift)

    def with_shift(self, shift) -> "BackgroundOperator":
        """A + diag(shift) (pseudo-transient continuation)."""
        return self._like(self.trim_mask, shift)

    def _like(self, trim_mask, shift) -> "BackgroundOperator":
        """This operator with another trim mask and shift; the support is
        shared."""
        out = BackgroundOperator(self.form, self.blocks, self.M, trim_mask,
                                 shift)
        out._support = self._support
        return out

    # -- exact diagonal -------------------------------------------------------

    def diag(self, chunk: int = 65536) -> torch.Tensor:
        """diag(Mᵀ A_f M), exact, block-wise on the device.

        For an element block K (ne, ne) with extraction rows (idx, val) of
        its dofs ((km, ne) each), the contribution to diag[j] is
        Σ_{a,k,b,l} val[k,a] K[a,b] val[l,b] [idx[k,a]=j][idx[l,b]=j]: per
        chunk of elements, one batched compare of the index planes, one
        contraction and one ``index_add_``."""
        d = torch.zeros(self.n, dtype=self.blocks[0].dtype,
                        device=self.blocks[0].device)
        for (dom, _), K in zip(self.form.terms, self.blocks):
            midx, mval = self.M.row_blocks(dom.eldofsT)   # (km, ne, nE)
            for s in range(0, K.shape[-1], chunk):
                ic = midx[..., s:s + chunk]
                vc = mval[..., s:s + chunk].to(K.dtype)
                eq = (ic[:, :, None, None, :]
                      == ic[None, None, :, :, :]).to(K.dtype)
                T = torch.einsum("abE,KaLbE,LbE->KaE",
                                 K[..., s:s + chunk], eq, vc) * vc
                d.index_add_(0, ic.reshape(-1), T.reshape(-1))
        if self.shift is not None:
            d = d + self.shift
        if self.trim_mask is not None:
            d = torch.where(self.trim_mask, 1.0, d)
        return d

    def block_diag(self, n_fields: int, chunk: int = 65536) -> torch.Tensor:
        """Per-node (nf, nf) diagonal blocks of Mᵀ A_f M, exact: the block
        at node j holds A_b[j + fa·m, j + fb·m] (field-blocked background
        dofs, m nodes). ``diag``'s element-block reduction with the dof
        equality split into node equality and a pair of field masks.
        Returns (m, nf, nf); a trimmed (node, field) row becomes the
        identity row of its block."""
        nf = int(n_fields)
        if self.n % nf:
            raise ValueError(f"{self.n} dofs do not split into {nf} fields")
        m = self.n // nf
        K0 = self.blocks[0]
        out = torch.zeros((nf, nf, m), dtype=K0.dtype, device=K0.device)
        for (dom, _), K in zip(self.form.terms, self.blocks):
            midx, mval = self.M.row_blocks(dom.eldofsT)   # (km, ne, nE)
            for s in range(0, K.shape[-1], chunk):
                node = midx[..., s:s + chunk] % m
                fld = midx[..., s:s + chunk] // m
                vc = mval[..., s:s + chunk].to(K.dtype)
                eqn = (node[:, :, None, None, :]
                       == node[None, None, :, :, :]).to(K.dtype)
                Kc = K[..., s:s + chunk]
                for fa in range(nf):
                    va = torch.where(fld == fa, vc, 0.0)
                    for fb in range(nf):
                        vb = torch.where(fld == fb, vc, 0.0)
                        T = torch.einsum("abE,KaLbE,LbE->KaE", Kc, eqn,
                                         vb) * va
                        out[fa, fb].index_add_(0, node.reshape(-1),
                                               T.reshape(-1))
        blocks = out.permute(2, 0, 1)                     # (m, nf, nf)
        eye = torch.eye(nf, dtype=K0.dtype, device=K0.device)
        if self.shift is not None:
            sh = self.shift.reshape(nf, m).T              # (m, nf)
            blocks = blocks + sh[:, :, None] * eye
        if self.trim_mask is not None:
            tm = self.trim_mask.reshape(nf, m).T          # (m, nf)
            blocks = torch.where(tm[:, :, None], eye[None], blocks)
        return blocks.contiguous()

    # -- explicit export (direct-solver path) ---------------------------------

    def to_scipy(self):
        """Explicit A_b as a host scipy CSR matrix, Mᵀ A_f M (the reference's
        PtAP), for the sparse direct solve."""
        import scipy.sparse as sp

        n_fg = self.form.n_dofs
        A_f = sp.csr_matrix((n_fg, n_fg))
        for (dom, _), K in zip(self.form.terms, self.blocks):
            fl = dom.flat_eldofs_np                       # (nE, ne)
            ne = fl.shape[1]
            rows = np.repeat(fl, ne, axis=1).ravel()
            cols = np.tile(fl, (1, ne)).ravel()
            Kel = np.moveaxis(K.cpu().numpy(), -1, 0)     # (nE, ne, ne)
            A_f = A_f + sp.coo_matrix((Kel.ravel(), (rows, cols)),
                                      shape=(n_fg, n_fg)).tocsr()
        Msp = self.M.to_scipy()
        A_b = (Msp.T @ A_f @ Msp).tocsr()
        if self.shift is not None:
            A_b = (A_b + sp.diags(self.shift.cpu().numpy())).tocsr()
        if self.trim_mask is not None:
            A_b = _zero_rows_scipy(
                A_b, np.flatnonzero(self.trim_mask.cpu().numpy()))
        return A_b


def _zero_rows_scipy(A, rows):
    """PETSc MatZeroRows semantics: zero the rows, put 1 on the diagonal."""
    A = A.tolil()
    for r in rows:
        A.rows[r] = [int(r)]
        A.data[r] = [1.0]
    return A.tocsr()


def assemble_background_system(form: Form, u_f: torch.Tensor,
                               M: ExtractionOperator, aux=None, params=None,
                               rhs_sign: float = -1.0):
    """Linear system of the linearization around ``u_f``:
    A_b = Mᵀ (dR/du) M and b_b = Mᵀ (rhs_sign · R(u_f)). rhs_sign = −1 solves
    J du = −R (the demos); +1 is Newton's J du = R, u −= du. Blocks and
    residual come from one jacfwd pass per term; everything lives on
    ``u_f``'s device."""
    blocks, res = form.jacobian_and_residual(u_f, aux, params)
    return BackgroundOperator(form, blocks, M), M.rmv(rhs_sign * res)
