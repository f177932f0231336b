"""Cell-window Galerkin projection (port of ``iifea_tpu/ops/cell_window.py``:
``CellWindowTerm.build``, ``window_planes``, ``build_window_projection`` and
``stencil_planes_windows``).

Every foreground element binned to background cell c (the min lattice
corner over its extraction targets) touches only the 3^dim lattice nodes of
the {0..2}^dim window anchored at c. With E_l ∈ R^{ne×w} (w = 3^dim) the
element's extraction rows in window-class columns, the projected operator
restricted to the window is

    G_c = Σ_{l in cell c}  E_lᵀ K_l E_l          (w × w per cell),

and the stencil coefficients follow by placement: row class d1 and column
class d2 contribute G_c[d1, d2] to plane δ(d2) − δ(d1) at lattice row
bbox_start + c + δ(d1).

Tables (host numpy binning, then built on ``device``), cell-major so that a
slab of cells is a contiguous slice (the JAX package keeps them slot-major,
(ne, km, L, nc)):

  val_b  (nc, L, ne, km) f64   extraction weight of a contribution slot
  kappa  (nc, L, ne, km) int8  window class Σ δ_d·3^(dim-1-d), δ ∈ {0..2}
                               (0 where the weight is 0)
  perm   (nc, L)         int64 element id + 1 (0 = padding)

Cells use the dense layout of the bounding box of the occupied cells,
row-major, x slowest. The dense slot depth L is the maximum occupancy (no
``l_cap`` split and no spill tables: they exist in the JAX package to fit a
16 GB TPU; at n_bg=104 the uncapped tables take 9.2 GB of the 80 GB card).
The stencil is radius 2, the radius the {0..2}^dim window implies.

``window_planes`` streams bbox x-slabs through E build (one scatter_add_
over the classes of each slot's targets; a target's class is unique within
its row, so the adds never collide) → K E (batched 4×4 products) →
Eᵀ(K E) (``torch.bmm``, contraction over L·ne) into a (w², nc) buffer,
then places the w² rows with shifted slice adds. Every sum is an ordered
tensor reduction: the planes are deterministic.
"""
from __future__ import annotations

import numpy as np
import torch

from iifea_tpu_torch.ops.lattice_bin import LatticeBinError


def _class_offsets(dim: int) -> np.ndarray:
    """(w, dim) int offsets of window class k (mixed-radix base 3)."""
    ks = np.arange(3 ** dim)
    out = np.zeros((ks.size, dim), dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        out[:, d] = ks % 3
        ks = ks // 3
    return out


class CellWindowTerm:
    """One form term's window tables on an n-D lattice."""

    def __init__(self, val_b, kappa, perm, shape, meta, bbox):
        self.val_b = val_b               # (nc, L, ne, km)
        self.kappa = kappa               # (nc, L, ne, km) int8
        self.perm = perm                 # (nc, L) int64
        self.shape = tuple(shape)
        self.meta = meta                 # (ne, km, L, nc)
        self.bbox = bbox                 # (starts tuple, sizes tuple)

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def w(self) -> int:
        return 3 ** self.dim

    def nbytes(self) -> dict:
        """Device bytes of each table."""
        return {name: t.numel() * t.element_size()
                for name, t in (("val_b", self.val_b), ("kappa", self.kappa),
                                ("perm", self.perm))}

    # -- host construction ----------------------------------------------------

    @staticmethod
    def build(flat_eldofs: np.ndarray, M, shape, *,
              device) -> "CellWindowTerm":
        """flat_eldofs: (nE, ne) foreground dof ids of the term's elements;
        M: scalar ExtractionOperator; shape: lattice (n1+1, ..., nd+1).

        Raises LatticeBinError if any element's extraction targets exceed
        the {0..2}^dim window (elements wider than the background spacing).
        """
        shape = tuple(int(s) for s in shape)
        dim = len(shape)
        if M.n_bg_dofs != int(np.prod(shape)):
            raise LatticeBinError("extraction is not scalar on this lattice")
        eldofs = np.asarray(flat_eldofs, dtype=np.int64)     # (nE, ne)
        nE, ne = eldofs.shape
        km = M.idx_np.shape[1]
        tidx = M.idx_np[eldofs].astype(np.int64)             # (nE, ne, km)
        tval = M.val_np[eldofs].astype(np.float64)
        valid = tval != 0.0

        # lattice coordinates of the targets (row-major ids)
        coords = []
        rem = tidx
        for d in range(dim - 1, 0, -1):
            coords.append(rem % shape[d])
            rem = rem // shape[d]
        coords.append(rem)
        coords = coords[::-1]
        del tidx, rem

        big = np.int64(1) << 40
        base = []
        for d in range(dim):
            bd = np.where(valid, coords[d], big).min(axis=(1, 2))
            base.append(np.clip(bd, 0, max(shape[d] - 3, 0)))
        has = valid.any(axis=(1, 2))
        kap = np.zeros((nE, ne, km), dtype=np.int8)
        in_win = np.ones_like(valid)
        for d in range(dim):
            delta = coords[d] - base[d][:, None, None]
            in_win &= ((delta >= 0) & (delta <= 2)) | ~valid
            kap = kap * 3 + np.clip(delta, 0, 2).astype(np.int8)
        del coords
        kap[~valid] = 0
        spilled = has & ~in_win.all(axis=(1, 2))
        if spilled.any():
            raise LatticeBinError(
                f"{int(spilled.sum())} elements exceed the lattice stencil "
                "window (foreground elements wider than the background "
                "spacing)"
            )
        use = np.flatnonzero(has)

        # bbox-cropped dense cell layout
        starts, sizes = [], []
        for d in range(dim):
            bu = base[d][use]
            s0 = int(bu.min()) if use.size else 0
            starts.append(s0)
            sizes.append((int(bu.max()) - s0 + 1) if use.size else 1)
        nc = max(int(np.prod(sizes)), 1)
        cell = np.zeros(use.size, dtype=np.int64)
        for d in range(dim):
            cell = cell * sizes[d] + (base[d][use] - starts[d])

        counts = np.bincount(cell, minlength=nc)
        L = max(int(counts.max()) if counts.size else 0, 1)
        order = np.argsort(cell, kind="stable")
        cell_s = cell[order]
        cstarts = np.zeros(nc, dtype=np.int64)
        np.cumsum(counts[:-1], out=cstarts[1:])
        slot = np.arange(cell.size, dtype=np.int64) - cstarts[cell_s]
        src = use[order]

        # dense tables filled on the device from the compact slot lists
        dev = torch.device(device)
        ci = torch.as_tensor(cell_s, device=dev)
        si = torch.as_tensor(slot, device=dev)
        val_t = torch.zeros((nc, L, ne, km), dtype=torch.float64, device=dev)
        val_t[ci, si] = torch.as_tensor(
            np.where(valid[src], tval[src], 0.0), device=dev)
        kap_t = torch.zeros((nc, L, ne, km), dtype=torch.int8, device=dev)
        kap_t[ci, si] = torch.as_tensor(kap[src], device=dev)
        perm = torch.zeros((nc, L), dtype=torch.int64, device=dev)
        perm[ci, si] = torch.as_tensor(src + 1, device=dev)
        return CellWindowTerm(val_t, kap_t, perm, shape,
                              meta=(ne, km, L, nc),
                              bbox=(tuple(starts), tuple(sizes)))

    # -- window assembly --------------------------------------------------------

    def _congruence(self, rows: torch.Tensor, lo: int, hi: int):
        """(w², n) window operators G of cells lo..hi, row-major (d1, d2)."""
        ne, km, L, _ = self.meta
        w, n = self.w, hi - lo
        E = self.val_b.new_zeros(n, L, ne, w)
        E.scatter_add_(3, self.kappa[lo:hi].long(), self.val_b[lo:hi])
        Kc = rows[self.perm[lo:hi]].view(n, L, ne, ne)
        T = torch.matmul(Kc, E)                              # (n, L, ne, w)
        G = torch.bmm(E.view(n, L * ne, w).transpose(1, 2),
                      T.view(n, L * ne, w))                  # (n, w, w)
        return G.view(n, w * w).T

    def window_planes(self, K_el: torch.Tensor,
                      slab_bytes: float = 4e9) -> torch.Tensor:
        """Radius-2 stencil planes (5^dim, *shape) of Mᵀ A_term M, f64, from
        the term's COMPACT element blocks ``K_el`` (ne, ne, nE).

        Phase 1 streams bbox x-slabs (at most ``slab_bytes`` of E/T
        workspace each) into a (w², nc) window-operator buffer; phase 2
        places its w² rows onto the planes, one shifted slice add each."""
        ne, km, L, nc = self.meta
        w, dim = self.w, self.dim
        radius, m = 2, 5
        starts, sizes = self.bbox
        dt = self.val_b.dtype
        esz = self.val_b.element_size()
        rows = K_el.to(dt).reshape(ne * ne, -1).T
        rows = torch.cat([rows.new_zeros(1, ne * ne), rows], dim=0)

        sx = sizes[0]
        rest = int(np.prod(sizes[1:]))
        # per bbox x-row: int64 classes, gathered K, E and K·E, G twice
        per_x = rest * (L * (ne * km * 8 + ne * ne * esz + 2 * ne * w * esz)
                        + 2 * w * w * esz)
        slab = max(1, min(int(slab_bytes // max(per_x, 1)), sx))
        Gbuf = self.val_b.new_empty(w * w, nc)
        for x0 in range(0, sx, slab):
            lo, hi = x0 * rest, min(x0 + slab, sx) * rest
            Gbuf[:, lo:hi] = self._congruence(rows, lo, hi)

        planes = self.val_b.new_zeros((m ** dim,) + self.shape)
        offs = _class_offsets(dim)
        for d1 in range(w):
            at = [starts[d] + int(offs[d1, d]) for d in range(dim)]
            region = tuple(slice(a, a + s) for a, s in zip(at, sizes))
            for d2 in range(w):
                k = 0
                for d in range(dim):
                    k = k * m + int(offs[d2, d] - offs[d1, d]) + radius
                planes[(k,) + region] += Gbuf[d1 * w + d2].view(sizes)
        return planes


def build_window_projection(form, M, shape, *,
                            device) -> list[CellWindowTerm]:
    """Cell-window tables for every term of a scalar form (setup-time)."""
    if form.n_fields != 1:
        raise LatticeBinError("cell-window binning covers scalar fields")
    return [
        CellWindowTerm.build(dom.flat_eldofs_np, M, shape, device=device)
        for dom, _ in form.terms
    ]


def stencil_planes_windows(reducers, K_els, slab_bytes: float = 4e9):
    """Stencil planes of Mᵀ A M summed over the form's terms, from COMPACT
    per-term element blocks (ne, ne, nE)."""
    C = None
    for red, K in zip(reducers, K_els):
        Ct = red.window_planes(K, slab_bytes=slab_bytes)
        C = Ct if C is None else C.add_(Ct)
    return C
