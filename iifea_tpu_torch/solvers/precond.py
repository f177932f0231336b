"""Pointwise and point-block Jacobi and restricted additive Schwarz
preconditioning (port of ``jacobi``, ``block_jacobi`` and
``AdditiveSchwarz`` in ``iifea_tpu/solvers/precond.py``)."""
from __future__ import annotations

import numpy as np
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


class AdditiveSchwarz:
    """Restricted additive Schwarz with overlapping dense patch solves (the
    reference's PCASM role: overlap-1 subdomains, per-subdomain LU), for
    backgrounds without lattice structure, where pc='mg' does not apply.

    Patches are built once on the host from the explicit projected CSR
    (greedy breadth-first aggregation into cores of ``core_size`` dofs,
    grown by ``overlap`` adjacency layers), their dense sub-blocks inverted
    explicitly, and the tables moved to ``device``. The apply is batched
    device work:

        gather r into (P, w) patch slabs
      -> one batched (P, w, w) x (P, w) product against the stored inverses
      -> restricted scatter-add (each dof is owned by exactly one core, so
         overlap regions are never double-counted)

    Unsupported dofs (zero operator rows) bypass the patches and act as
    identity, the ``jacobi``/trim convention. The scatter is an
    ``index_add_``: on CUDA its order is not fixed, but every dof receives
    one nonzero contribution (its owner's), so the result does not depend
    on it."""

    def __init__(self, A_csr, core_size: int = 64, overlap: int = 1,
                 dtype=None, device="cuda"):
        import scipy.sparse as sp

        A = sp.csr_matrix(A_csr)
        n = A.shape[0]
        G = (A != 0)                       # symmetrised adjacency pattern
        G = (G + G.T).tocsr()
        diag = np.abs(A.diagonal())
        off = np.asarray(np.abs(A).sum(axis=1)).ravel() - diag
        alive = (diag > 0) | (off > 0)

        indptr, indices = G.indptr, G.indices
        owner = np.full(n, -1, dtype=np.int64)
        cores = []
        for seed in range(n):
            if owner[seed] >= 0 or not alive[seed]:
                continue
            core = [seed]
            owner[seed] = len(cores)
            frontier = [seed]
            while frontier and len(core) < core_size:
                nxt = []
                for u in frontier:
                    for v in indices[indptr[u]:indptr[u + 1]]:
                        if owner[v] < 0 and alive[v]:
                            owner[v] = len(cores)
                            core.append(v)
                            nxt.append(v)
                            if len(core) >= core_size:
                                break
                    if len(core) >= core_size:
                        break
                frontier = nxt
            cores.append(np.asarray(core, dtype=np.int64))

        patches = []
        for core in cores:
            patch = core
            for _ in range(overlap):
                nbrs = np.unique(np.concatenate([
                    indices[indptr[u]:indptr[u + 1]] for u in patch
                ]))
                patch = np.union1d(patch, nbrs[alive[nbrs]])
            patches.append(patch)

        P = len(patches)
        w = max((len(p) for p in patches), default=1)
        idx = np.full((P, w), n, dtype=np.int64)     # n = dummy pad slot
        own = np.zeros((P, w), dtype=A.dtype)
        inv = np.zeros((P, w, w), dtype=A.dtype)
        for p, patch in enumerate(patches):
            k = len(patch)
            idx[p, :k] = patch
            own[p, :k] = (owner[patch] == p)
            Ap = A[np.ix_(patch, patch)].toarray()
            # dead rows inside the patch halo -> identity (jacobi convention)
            dd = np.abs(np.diagonal(Ap)) + np.abs(Ap).sum(axis=1)
            dead_rows = np.where(dd == 0)[0]
            Ap[dead_rows, dead_rows] = 1.0
            full = np.eye(w, dtype=A.dtype)  # pad slots -> identity
            full[:k, :k] = Ap
            try:
                inv[p] = np.linalg.inv(full)
            except np.linalg.LinAlgError:
                inv[p] = np.linalg.pinv(full)

        def t(a):
            return torch.as_tensor(a, device=device)

        dtype = dtype or t(own).dtype
        self.n = n
        self.idx = t(idx)
        self.own = t(own).to(dtype)
        self.inv = t(inv).to(dtype)
        self.passthrough = t((~alive).astype(A.dtype)).to(dtype)
        self.n_patches = P
        self.width = w

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        rp = torch.cat([r, r.new_zeros(1)])
        y = torch.einsum("pij,pj->pi", self.inv, rp[self.idx]) * self.own
        z = r.new_zeros(self.n + 1).index_add_(0, self.idx.reshape(-1),
                                               y.reshape(-1))[:self.n]
        return z + self.passthrough * r
