"""Lattice-binned reducers for 2D lattice backgrounds (port of
``iifea_tpu/ops/lattice_bin.py``).

At setup each foreground element is binned by a base background cell, the
min lattice corner over its extraction targets. Element diameters are below
the background spacing, so every target sits at a static offset
δ ∈ {0..2}² from its base, and the index structure becomes per-(slot, cell)
tables (host numpy, then tensors on ``device``):

  val_b  (ne, km, L, nc) f64    extraction weight of a contribution slot
  kappa  (ne, km, L, nc) int64  offset class 3·δi + δj (0..8; 0 where the
                                weight is 0)
  perm   (L, nc)         int64  element id + 1 (0 = padding)

Dense terms (the cell term) use the bounding box of their occupied cells as
a row-major slot grid and place by slices; sparse-touch terms (the
interface facets) use a compact list of occupied cells and place through
``rows9``, the lattice row of each cell for each of the 9 offsets.

Every reduction here is deterministic: sums over slots are masked tensor
sums, slice placements are ordered adds, and the compact ``index_add_``
placements scatter rows that are unique within one offset class (one add
per row per call), so no f64 result depends on the order of atomics.

The weights are f64 and the GPU computes in native f64, so the double-float
(hi, lo) tables of the reference are not needed.
"""
from __future__ import annotations

import numpy as np
import torch


class LatticeBinError(ValueError):
    """Raised when a term cannot be lattice-binned."""


class LatticeBinnedTerm2D:
    """One form term's binned tables on an (nx1, ny1) lattice."""

    def __init__(self, val_b, kappa, perm, shape, meta, cells=None,
                 rows9=None, bbox=None):
        self.val_b = val_b          # (ne, km, L, nc) f64
        self.kappa = kappa          # (ne, km, L, nc) int64
        self.perm = perm            # (L, nc) int64, element id + 1
        self.cells = cells          # None (dense) or (nc,) cell ids
        self.rows9 = rows9          # compact: (9, nc) lattice rows
        self.shape = tuple(shape)
        self.meta = meta            # (ne, km, L, nc)
        self.bbox = bbox            # dense: (bi0, bj0, bcx, bcy)

    # -- host construction ----------------------------------------------------

    @staticmethod
    def build(flat_eldofs: np.ndarray, M, shape, radius: int = 2, *,
              device) -> "LatticeBinnedTerm2D":
        """flat_eldofs: (nE, ne) foreground dof ids of the term's elements;
        M: scalar ExtractionOperator; shape: (nx1, ny1) lattice.

        A term that touches fewer than 1/4 of the cells is binned compact.
        Raises LatticeBinError if an element's targets leave the {0..2}²
        offset window.
        """
        if radius != 2:
            raise LatticeBinError("lattice binning implemented for radius 2")
        nx1, ny1 = shape
        if M.n_bg_dofs != nx1 * ny1:
            raise LatticeBinError("extraction is not scalar on this lattice")
        eldofs = np.asarray(flat_eldofs, dtype=np.int64)   # (nE, ne)
        nE, ne = eldofs.shape
        km = M.idx_np.shape[1]
        tidx = M.idx_np[eldofs]                            # (nE, ne, km)
        tval = M.val_np[eldofs].astype(np.float64)
        valid = tval != 0.0
        ti = tidx // ny1
        tj = tidx - ti * ny1
        big = np.int64(1) << 40
        bi = np.where(valid, ti, big).min(axis=(1, 2))
        bj = np.where(valid, tj, big).min(axis=(1, 2))
        has = valid.any(axis=(1, 2))
        bi = np.clip(bi, 0, max(nx1 - 3, 0))
        bj = np.clip(bj, 0, max(ny1 - 3, 0))
        di = ti - bi[:, None, None]
        dj = tj - bj[:, None, None]
        in_win = ((di >= 0) & (di <= 2) & (dj >= 0) & (dj <= 2)) | ~valid
        spilled = has & ~in_win.all(axis=(1, 2))
        if spilled.any():
            raise LatticeBinError(
                f"{int(spilled.sum())} elements exceed the lattice stencil "
                "window (foreground elements wider than the background "
                "spacing)"
            )
        use = np.flatnonzero(has)
        ncy = ny1 - 2
        cell = (bi[use] * ncy + bj[use]).astype(np.int64)

        if np.unique(cell).size < ((nx1 - 2) * ncy) // 4:
            cells_occ, cell = np.unique(cell, return_inverse=True)
            nc = cells_occ.size
            bbox = None
        else:
            bi_u, bj_u = bi[use], bj[use]
            bi0 = int(bi_u.min()) if use.size else 0
            bj0 = int(bj_u.min()) if use.size else 0
            bcx = (int(bi_u.max()) - bi0 + 1) if use.size else 1
            bcy = (int(bj_u.max()) - bj0 + 1) if use.size else 1
            nc = bcx * bcy
            cell = ((bi_u - bi0) * bcy + (bj_u - bj0)).astype(np.int64)
            cells_occ = None
            bbox = (bi0, bj0, bcx, bcy)
        nc = max(nc, 1)

        counts = np.bincount(cell, minlength=nc)
        L = max(int(counts.max()) if counts.size else 0, 1)
        order = np.argsort(cell, kind="stable")
        cell_s = cell[order]
        starts = np.zeros(nc, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        slot = np.arange(cell.size, dtype=np.int64) - starts[cell_s]

        perm = np.zeros((L, nc), dtype=np.int64)
        perm[slot, cell_s] = use[order] + 1
        src = use[order]
        val_t = np.zeros((ne, km, L, nc), dtype=np.float64)
        kap_t = np.zeros((ne, km, L, nc), dtype=np.int64)
        val_t[:, :, slot, cell_s] = np.moveaxis(
            np.where(valid[src], tval[src], 0.0), 0, -1
        )
        # invalid targets (weight 0) take class 0 so kappa is a valid index
        kap_t[:, :, slot, cell_s] = np.moveaxis(
            np.where(valid[src], di[src] * 3 + dj[src], 0), 0, -1
        )
        rows9 = None
        if cells_occ is not None:
            base_i = cells_occ // ncy
            base_j = cells_occ - base_i * ncy
            rows9 = torch.as_tensor(np.stack([
                (base_i + d // 3) * ny1 + base_j + d % 3 for d in range(9)
            ]), device=device)
            cells_occ = torch.as_tensor(cells_occ, device=device)
        return LatticeBinnedTerm2D(
            torch.as_tensor(val_t, device=device),
            torch.as_tensor(kap_t, device=device),
            torch.as_tensor(perm, device=device),
            shape, meta=(ne, km, L, nc), cells=cells_occ, rows9=rows9,
            bbox=bbox,
        )

    # -- binding --------------------------------------------------------------

    def bind_blocks(self, K: torch.Tensor) -> torch.Tensor:
        """Element blocks (ne, ne, nE) -> binned (ne, ne, L, nc) layout
        (padding slots 0)."""
        ne, _, L, nc = self.meta
        rows = K.reshape(ne * ne, -1).T                    # (nE, ne²)
        rows = torch.cat([rows.new_zeros(1, ne * ne), rows], dim=0)
        return rows[self.perm.reshape(-1)].T.reshape(ne, ne, L, nc)

    def bind_static(self, arr: torch.Tensor) -> torch.Tensor:
        """Per-element data (..., nE) -> slot layout (..., L, nc)."""
        pad = arr.new_zeros(arr.shape[:-1] + (1,))
        return torch.cat([pad, arr], dim=-1)[..., self.perm]

    # -- reductions onto the lattice --------------------------------------------

    def _classes(self, V: torch.Tensor) -> torch.Tensor:
        """(9, nc) per-offset-class sums Σ_{a,ka,l} V·[κ==d] over slots."""
        return torch.stack([
            (V * (self.kappa == d)).sum(dim=(0, 1, 2)) for d in range(9)
        ])

    def _place(self, out9: torch.Tensor) -> torch.Tensor:
        """Place the 9 per-cell offset-class planes onto the lattice."""
        nx1, ny1 = self.shape
        if self.cells is None:
            bi0, bj0, bcx, bcy = self.bbox
            Y = out9.new_zeros(nx1, ny1)
            for d in range(9):
                di, dj = bi0 + d // 3, bj0 + d % 3
                Y[di:di + bcx, dj:dj + bcy] += out9[d].reshape(bcx, bcy)
            return Y.reshape(-1)
        Y = out9.new_zeros(nx1 * ny1)
        for d in range(9):
            Y.index_add_(0, self.rows9[d], out9[d])   # unique within a class
        return Y

    def _sources(self, x: torch.Tensor) -> torch.Tensor:
        """(9, nc): x at each cell's 9 window nodes."""
        if self.cells is None:
            bi0, bj0, bcx, bcy = self.bbox
            x2 = x.reshape(self.shape)
            return torch.stack([
                x2[bi0 + d // 3:bi0 + d // 3 + bcx,
                   bj0 + d % 3:bj0 + d % 3 + bcy].reshape(-1)
                for d in range(9)
            ])
        return x[self.rows9]

    def project_rhs(self, r_el: torch.Tensor) -> torch.Tensor:
        """b = Mᵀ_term r: bound element vectors (ne, L, nc) onto the lattice."""
        return self._place(self._classes(self.val_b * r_el[:, None]))

    def apply(self, Kb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = (Mᵀ A_term M) x on the bound blocks (ne, ne, L, nc)."""
        ne, km, L, nc = self.meta
        sel = torch.gather(self._sources(x), 0,
                           self.kappa.reshape(-1, nc)).reshape(ne, km, L, nc)
        xe = (self.val_b * sel).sum(dim=1)                   # (ne, L, nc)
        ye = (Kb * xe[None]).sum(dim=1)                      # (ne, L, nc)
        return self.project_rhs(ye)

    # -- direct stencil assembly ----------------------------------------------

    def _congruence(self, Kb: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """G[d1, d2, n] = Σ_{l,a,b} E[a,d1]·Kb[a,b]·E[b,d2] over the slots of
        cells lo..hi, with E[b,d] = Σ_kb val_b[b,kb]·[κ==d]."""
        val = self.val_b[..., lo:hi]
        kap = self.kappa[..., lo:hi]
        Kc = Kb[..., lo:hi]
        E = torch.stack([(val * (kap == d)).sum(dim=1) for d in range(9)],
                        dim=1)                                # (ne, 9, L, n)
        G = Kb.new_empty(9, 9, hi - lo)
        for d2 in range(9):
            T = (Kc * E[None, :, d2]).sum(dim=1)              # (ne, L, n)
            G[:, d2] = (E * T[:, None]).sum(dim=(0, 2))
        return G

    def stencil_planes_bound(self, Kb: torch.Tensor,
                             slab_bytes: float = 2.0e9) -> torch.Tensor:
        """Stencil planes (25, nx1, ny1) of Mᵀ A_term M assembled directly
        from the bound blocks: the window congruence G, then 81 placements
        at lattice offset δ(d2) − δ(d1).

        Dense terms stream bbox row slabs of at most ``slab_bytes`` of
        temporaries; compact terms assemble in one pass."""
        ne, km, L, nc = self.meta
        nx1, ny1 = self.shape
        r, m = 2, 5                    # binned terms are radius 2
        planes = Kb.new_zeros(m * m, nx1, ny1)

        def offsets():
            for d1 in range(9):
                for d2 in range(9):
                    oi = d2 // 3 - d1 // 3
                    oj = d2 % 3 - d1 % 3
                    yield d1, d2, (oi + r) * m + (oj + r)

        if self.cells is not None:
            G = self._congruence(Kb, 0, nc)
            flat = planes.view(m * m, -1)
            for d1, d2, k in offsets():
                flat[k].index_add_(0, self.rows9[d1], G[d1, d2])
            return planes

        bi0, bj0, bcx, bcy = self.bbox
        # temporaries per slot: E (ne·9), masked weights (ne·km), K·E
        # (ne²), E·T (ne·9) and T (ne)
        per_x = bcy * L * Kb.element_size() * (
            ne * 9 + ne * km + ne * ne + ne * 9 + ne
        )
        slab = max(1, min(int(slab_bytes // max(per_x, 1)), bcx))
        for r0 in range(0, bcx, slab):
            n_x = min(slab, bcx - r0)
            G = self._congruence(Kb, r0 * bcy, (r0 + n_x) * bcy)
            for d1, d2, k in offsets():
                i0 = bi0 + d1 // 3 + r0
                j0 = bj0 + d1 % 3
                planes[k, i0:i0 + n_x, j0:j0 + bcy] += G[d1, d2].reshape(
                    n_x, bcy)
        return planes


def build_binned_projection(form, M, shape, radius: int = 2, *,
                            device) -> list[LatticeBinnedTerm2D]:
    """Binned tables for every term of a scalar form (host, setup-time)."""
    if form.n_fields != 1:
        raise LatticeBinError("lattice binning covers scalar fields")
    return [
        LatticeBinnedTerm2D.build(dom.flat_eldofs_np, M, shape, radius,
                                  device=device)
        for dom, _ in form.terms
    ]


def stencil_planes_binned_bound(reducers, bound) -> torch.Tensor:
    """Direct stencil planes (25, nx1, ny1) from bound blocks, summed over
    terms."""
    C = reducers[0].stencil_planes_bound(bound[0])
    for red, Kb in zip(reducers[1:], bound[1:]):
        C = C + red.stencil_planes_bound(Kb)
    return C


def stencil_planes_binned(reducers, blocks) -> torch.Tensor:
    """Direct stencil planes from per-term element blocks (bind, then
    assemble)."""
    return stencil_planes_binned_bound(
        reducers, [red.bind_blocks(K) for red, K in zip(reducers, blocks)]
    )


def project_rhs_binned(reducers, r_els) -> torch.Tensor:
    """b = Σ_terms Mᵀ_term r_el (f64)."""
    y = reducers[0].project_rhs(r_els[0])
    for red, r in zip(reducers[1:], r_els[1:]):
        y = y + red.project_rhs(r)
    return y


def apply_binned(reducers, bound, x: torch.Tensor) -> torch.Tensor:
    """y = A_b x summed over terms (f64 residual operator)."""
    y = reducers[0].apply(bound[0], x)
    for red, Kb in zip(reducers[1:], bound[1:]):
        y = y + red.apply(Kb, x)
    return y
