"""The extraction operator M (background -> foreground interpolation).

Port of ``iifea_tpu/ops/extraction.py``. The host copy is row-major ELL
(``idx_np``/``val_np``, (n_fg, kmax)); the device copy is slot-major
(kmax, n_fg). Built from tensors (the B-spline extraction's, made on the
device), M transposes them where they lie and makes its host copy only
when asked for it. ``mv`` is a gather and weighted slot sum; ``rmv`` is the
transpose's fixed-order sum (``ops/segment.SegmentSum``, built on first
use: each background dof's entries sorted once), so its f64 result is the
same on every run. The ``*_multi`` variants take stacked (k, n) vectors, the
right-hand-side axis first. ``to_scipy`` exports M as a host CSR matrix for
the direct solve. ``from_exop_csv`` reads M from the reference's extraction
files.

Multi-field layout, as in the reference: foreground dofs interleave fields
(node·n_fields + field), background dofs are field-blocked
(node + field·m, m background nodes).
"""
from __future__ import annotations

import numpy as np
import torch

from iifea_tpu_torch.ops.segment import SegmentSum


class ExtractionOperator:
    """Sparse M of shape (n_fg_dofs, n_bg_dofs) in ELL form."""

    def __init__(self, idx, val, n_bg_dofs: int, device="cuda"):
        """``idx``, ``val``: the (n_fg, kmax) ELL arrays, numpy or torch."""
        self.n_bg_dofs = int(n_bg_dofs)
        self.n_fg_dofs = int(idx.shape[0])
        self.device = torch.device(device)
        # numpy inputs are kept as given for the host views below
        on_host = not isinstance(idx, torch.Tensor)
        self._idx_np = np.asarray(idx) if on_host else None
        self._val_np = np.asarray(val) if on_host else None
        if on_host:
            idx = torch.from_numpy(np.ascontiguousarray(self._idx_np))
            val = torch.from_numpy(np.ascontiguousarray(self._val_np))
        self._idx_dtype = idx.dtype
        self.idxT = idx.T.to(self.device, torch.int64).contiguous()
        self.valT = val.T.to(self.device).contiguous()
        self._tsum = None
        self._scipy = None

    @property
    def idx_np(self) -> np.ndarray:
        """Host (n_fg, kmax) column ids, in the dtype M was built with."""
        if self._idx_np is None:
            self._idx_np = np.ascontiguousarray(
                self.idxT.T.to(self._idx_dtype).cpu().numpy())
        return self._idx_np

    @property
    def val_np(self) -> np.ndarray:
        """Host (n_fg, kmax) weights."""
        if self._val_np is None:
            self._val_np = np.ascontiguousarray(self.valT.T.cpu().numpy())
        return self._val_np

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
    def from_exop_csv(cls, paths, n_fg_nodes: int, n_fields: int = 1,
                      dtype=np.float64, *,
                      device="cuda") -> "ExtractionOperator":
        """M from the reference's ``ExOp_Cons.csv`` triples (one path or a
        list, concatenated). The files' ids are 1-based and the foreground
        ones are node ids (Exodus ids for P2), so both map to id − 1; rows
        with foreground id 0 are dropped."""
        from iifea_tpu_torch.mesh.io import read_exop_triples

        tri = read_exop_triples(paths)
        fg = tri[:, 0].astype(np.int64) - 1
        bg = tri[:, 1].astype(np.int64) - 1
        ok = fg >= 0
        return cls.from_triples(fg[ok], bg[ok], tri[ok, 2], n_fg_nodes,
                                n_fields=n_fields, dtype=dtype, device=device)

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

    def _transpose(self) -> SegmentSum:
        """Mᵀ's fixed-order sum over the nonzero weights, built once."""
        if self._tsum is None:
            self._tsum = SegmentSum(self.idxT, self.n_bg_dofs,
                                    keep=self.valT != 0)
        return self._tsum

    def rmv(self, r_f: torch.Tensor) -> torch.Tensor:
        """r_b = Mᵀ r_f."""
        return self._transpose()((self.valT * r_f[None, :]).reshape(-1))

    def mv_multi(self, U: torch.Tensor) -> torch.Tensor:
        """(k, n_bg) -> (k, n_fg)."""
        return (self.valT[None] * U[:, self.idxT]).sum(dim=1)

    def rmv_multi(self, R: torch.Tensor) -> torch.Tensor:
        """(k, n_fg) -> (k, n_bg)."""
        k = R.shape[0]
        return self._transpose()(
            (self.valT[None] * R[:, None, :]).reshape(k, -1))

    def row_blocks(self, eldofsT: torch.Tensor):
        """ELL planes of the foreground dof ids (ne, nE): (idx, val), each
        (kmax, ne, nE)."""
        return self.idxT[:, eldofsT], self.valT[:, eldofsT]

    def to_scipy(self, transpose: bool = False):
        """Host CSR copy of M (n_fg, n_bg), or of Mᵀ, for the direct solve;
        built once (callers do not modify it)."""
        if self._scipy is None:
            import scipy.sparse as sp

            rows = np.repeat(np.arange(self.n_fg_dofs), self.idx_np.shape[1])
            Msp = sp.coo_matrix(
                (self.val_np.ravel(), (rows, self.idx_np.ravel())),
                shape=(self.n_fg_dofs, self.n_bg_dofs),
            ).tocsr()
            self._scipy = (Msp, Msp.T.tocsr())
        return self._scipy[1 if transpose else 0]
