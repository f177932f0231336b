"""The extraction operator M (background -> foreground interpolation).

Port of ``iifea_tpu/ops/extraction.py``. The host copy is row-major ELL
(``idx_np``/``val_np``, (n_fg, kmax)); the device copy is slot-major
(kmax, n_fg). ``mv`` is a gather and weighted slot sum; ``rmv`` is an f64
``index_add_`` (on CUDA its order of accumulation onto a repeated
background dof is not fixed, so results may differ in the last bits from
run to run). The ``*_multi`` variants take stacked (k, n) vectors, the
right-hand-side axis first. ``to_scipy`` exports M as a host CSR matrix for
the direct solve.

Multi-field layout, as in the reference: foreground dofs interleave fields
(node·n_fields + field), background dofs are field-blocked
(node + field·m, m background nodes).
"""
from __future__ import annotations

import numpy as np
import torch


class ExtractionOperator:
    """Sparse M of shape (n_fg_dofs, n_bg_dofs) in ELL form."""

    def __init__(self, idx, val, n_bg_dofs: int, device="cuda"):
        self.idx_np = np.asarray(idx)
        self.val_np = np.asarray(val)
        self.n_bg_dofs = int(n_bg_dofs)
        self.n_fg_dofs = int(self.idx_np.shape[0])
        self.device = torch.device(device)
        self.idxT = torch.as_tensor(
            np.ascontiguousarray(self.idx_np.T), dtype=torch.int64,
            device=self.device,
        )
        self.valT = torch.as_tensor(
            np.ascontiguousarray(self.val_np.T), device=self.device
        )

    @classmethod
    def from_triples(cls, fg_nodes, bg_nodes, weights, n_fg_nodes: int,
                     n_bg_nodes: int | None = None, n_fields: int = 1,
                     dtype=np.float64, *,
                     device="cuda") -> "ExtractionOperator":
        """Build M from 0-based (fg_node, bg_node, weight) triples; a
        duplicate (fg, bg) pair keeps its last weight. Scalar triples are
        replicated across ``n_fields`` fields in the multi-field layout."""
        fg_nodes = np.asarray(fg_nodes, dtype=np.int64)
        bg_nodes = np.asarray(bg_nodes, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        m = int(bg_nodes.max()) + 1 if n_bg_nodes is None else int(n_bg_nodes)

        key = fg_nodes * (m + 1) + bg_nodes
        _, last_index = np.unique(key[::-1], return_index=True)
        keep = len(key) - 1 - last_index
        fg_nodes, bg_nodes, weights = (fg_nodes[keep], bg_nodes[keep],
                                       weights[keep])

        counts = np.bincount(fg_nodes, minlength=n_fg_nodes)
        kmax = max(int(counts.max()) if len(counts) else 1, 1)
        idx = np.zeros((n_fg_nodes * n_fields, kmax), dtype=np.int32)
        val = np.zeros((n_fg_nodes * n_fields, kmax), dtype=dtype)
        order = np.argsort(fg_nodes, kind="stable")
        fg_s, bg_s, w_s = fg_nodes[order], bg_nodes[order], weights[order]
        pos = np.zeros(len(fg_s), dtype=np.int64)
        if len(fg_s):
            new_row = np.ones(len(fg_s), dtype=bool)
            new_row[1:] = fg_s[1:] != fg_s[:-1]
            pos = np.arange(len(fg_s)) - np.maximum.accumulate(
                np.where(new_row, np.arange(len(fg_s)), 0)
            )
        for f in range(n_fields):
            idx[fg_s * n_fields + f, pos] = bg_s + f * m
            val[fg_s * n_fields + f, pos] = w_s
        return cls(idx, val, m * n_fields, device)

    @classmethod
    def identity(cls, n_nodes: int, n_fields: int = 1, dtype=np.float64, *,
                 device="cuda") -> "ExtractionOperator":
        """Identity extraction: the fitted-FEM path (``--Ex False``)."""
        n = n_nodes * n_fields
        return cls(np.arange(n, dtype=np.int32)[:, None],
                   np.ones((n, 1), dtype=dtype), n, device)

    def mv(self, u_b: torch.Tensor) -> torch.Tensor:
        """u_f = M u_b."""
        return (self.valT * u_b[self.idxT]).sum(dim=0)

    def rmv(self, r_f: torch.Tensor) -> torch.Tensor:
        """r_b = Mᵀ r_f."""
        data = (self.valT * r_f[None, :]).reshape(-1)
        out = torch.zeros(self.n_bg_dofs, dtype=data.dtype,
                          device=self.device)
        return out.index_add_(0, self.idxT.reshape(-1), data)

    def mv_multi(self, U: torch.Tensor) -> torch.Tensor:
        """(k, n_bg) -> (k, n_fg)."""
        return (self.valT[None] * U[:, self.idxT]).sum(dim=1)

    def rmv_multi(self, R: torch.Tensor) -> torch.Tensor:
        """(k, n_fg) -> (k, n_bg)."""
        k = R.shape[0]
        data = (self.valT[None] * R[:, None, :]).reshape(k, -1)
        out = torch.zeros((k, self.n_bg_dofs), dtype=data.dtype,
                          device=self.device)
        return out.index_add_(1, self.idxT.reshape(-1), data)

    def row_blocks(self, eldofsT: torch.Tensor):
        """ELL planes of the foreground dof ids (ne, nE): (idx, val), each
        (kmax, ne, nE)."""
        return self.idxT[:, eldofsT], self.valT[:, eldofsT]

    def to_scipy(self):
        """Host CSR copy of M (n_fg, n_bg) for the direct solve."""
        import scipy.sparse as sp

        rows = np.repeat(np.arange(self.n_fg_dofs), self.idx_np.shape[1])
        return sp.coo_matrix(
            (self.val_np.ravel(), (rows, self.idx_np.ravel())),
            shape=(self.n_fg_dofs, self.n_bg_dofs),
        ).tocsr()
