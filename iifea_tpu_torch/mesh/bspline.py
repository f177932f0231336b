"""B-spline background spaces and extraction generation (numpy copy of
``iifea_tpu/mesh/bspline.py``).

A tensor-product B-spline space on uniform open knot vectors, and the
interpolation-based extraction operator M whose rows are the spline basis
functions evaluated at foreground node coordinates (the structure of the
reference's extraction files, whose weights are such basis values). Basis
evaluation is vectorized Cox-de Boor over all points at once. Control
points are numbered row-major, (i·ncp_y + j)[·ncp_z + k], the layout of
the stencil operators.
"""
from __future__ import annotations

import numpy as np
import torch

from iifea_tpu_torch.ops.extraction import ExtractionOperator


def uniform_open_knots(degree: int, n_elems: int, a: float, b: float):
    """Open (clamped) uniform knot vector with n_elems spans on [a, b]."""
    interior = np.linspace(a, b, n_elems + 1)
    return np.concatenate(
        [np.full(degree, a), interior, np.full(degree, b)]
    )


def find_spans(knots: np.ndarray, degree: int, x: np.ndarray) -> np.ndarray:
    """Knot span index per evaluation point (vectorized)."""
    n = len(knots) - degree - 1  # number of basis functions
    spans = np.searchsorted(knots, x, side="right") - 1
    return np.clip(spans, degree, n - 1)


def basis_values(knots: np.ndarray, degree: int, x: np.ndarray):
    """Nonzero B-spline basis values at points x.

    Returns (spans (np,), vals (np, degree+1)): basis functions
    spans-degree ... spans are nonzero with the given values (Cox-de Boor
    recursion, vectorized over points).
    """
    x = np.asarray(x, dtype=np.float64)
    spans = find_spans(knots, degree, x)
    npts = len(x)
    vals = np.zeros((npts, degree + 1))
    left = np.zeros((npts, degree + 1))
    right = np.zeros((npts, degree + 1))
    vals[:, 0] = 1.0
    for j in range(1, degree + 1):
        left[:, j] = x - knots[spans + 1 - j]
        right[:, j] = knots[spans + j] - x
        saved = np.zeros(npts)
        for r in range(j):
            denom = right[:, r + 1] + left[:, j - r]
            temp = np.where(denom != 0, vals[:, r] / np.where(denom != 0, denom, 1), 0.0)
            vals[:, r] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        vals[:, j] = saved
    return spans, vals


class BSplineSpace2D:
    """Tensor-product B-spline space on a rectangle."""

    def __init__(self, degree: int, n_elems: tuple[int, int],
                 lo: tuple[float, float], hi: tuple[float, float]):
        self.degree = int(degree)
        self.n_elems = tuple(n_elems)
        self.lo, self.hi = tuple(lo), tuple(hi)
        self.knots = [
            uniform_open_knots(degree, n_elems[d], lo[d], hi[d])
            for d in range(2)
        ]
        self.ncp = tuple(len(k) - degree - 1 for k in self.knots)
        self.n_dofs = self.ncp[0] * self.ncp[1]

    def greville_points(self) -> np.ndarray:
        """Greville abscissae (control-point parameter locations)."""
        p = self.degree
        pts = []
        for d in range(2):
            k = self.knots[d]
            pts.append(
                np.array([k[i + 1:i + p + 1].mean() for i in range(self.ncp[d])])
            )
        X, Y = np.meshgrid(pts[0], pts[1], indexing="ij")
        return np.stack([X.ravel(), Y.ravel()], axis=1)

    def transfer_matrix(self, points: np.ndarray, n_fields: int = 1,
                        tol: float = 1e-12, dtype=np.float64, *,
                        device="cuda") -> ExtractionOperator:
        """Extraction M on ``device``: rows = spline basis evaluated at the
        given points. Points outside the parametric rectangle get zero
        rows."""
        return _transfer_matrix(self, points, n_fields, tol, dtype, device)


class BSplineSpace3D:
    """Tensor-product B-spline space on a box (the 3D analog of
    BSplineSpace2D)."""

    def __init__(self, degree: int, n_elems: tuple[int, int, int],
                 lo: tuple[float, float, float],
                 hi: tuple[float, float, float]):
        self.degree = int(degree)
        self.n_elems = tuple(n_elems)
        self.lo, self.hi = tuple(lo), tuple(hi)
        self.knots = [
            uniform_open_knots(degree, n_elems[d], lo[d], hi[d])
            for d in range(3)
        ]
        self.ncp = tuple(len(k) - degree - 1 for k in self.knots)
        self.n_dofs = self.ncp[0] * self.ncp[1] * self.ncp[2]

    def transfer_matrix(self, points: np.ndarray, n_fields: int = 1,
                        tol: float = 1e-12, dtype=np.float64, *,
                        device="cuda") -> ExtractionOperator:
        """Extraction M on ``device``: rows = spline basis evaluated at the
        given points. Column ordering is row-major (i·ncp_y + j)·ncp_z + k,
        the layout StencilOperator3D expects."""
        return _transfer_matrix(self, points, n_fields, tol, dtype, device)


# points per pass of ``_transfer_matrix``: bounds its (points, (p+1)^dim)
# temporaries (27 weights of 2^20 points: 226 MB per f64 or int64 array)
POINT_CHUNK = 2 ** 20


def _transfer_matrix(space, points, n_fields, tol, dtype, device):
    """Extraction M of a tensor-product spline space: row q holds the
    (p+1)^dim basis values of the spans at point q, zero rows outside the
    box, entries below 1e-14 dropped. Written straight into M's ELL arrays
    (a row's kept entries in column order, zero-padded to the longest row),
    ``POINT_CHUNK`` points at a time: the layout of
    ``ExtractionOperator.from_triples`` on these triples, whose sorts of
    every (point, weight) pair held several 437 M-entry arrays at once on
    the 3D biharmonic's 16.2 M P2 nodes. A point's columns ascend with its
    local index (the spans' indices ascend along every axis), so the kept
    entries are already in that order. The per-axis basis values come from
    numpy; their tensor products, the drop and the compaction run in torch
    on ``device`` (the 3D biharmonic's 437 M weights took 48 s in numpy on
    one host core), each value the same product in the same order as the
    numpy form's, so M is bitwise the same on every device. M takes the
    arrays as they lie: its device copy is transposed there, and its host
    copy made only if asked for."""
    points = np.asarray(points, dtype=np.float64)
    npts, dim = points.shape[0], len(space.ncp)
    p = space.degree
    m = p + 1
    k = m ** dim
    nbg = space.n_dofs
    dev = torch.device(device)
    tdt = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    idx = torch.zeros((npts * n_fields, k), dtype=torch.int32, device=dev)
    val = torch.zeros((npts * n_fields, k), dtype=tdt, device=dev)
    slot = torch.arange(k, device=dev)
    kmax = 1
    for s in range(0, npts, POINT_CHUNK):
        pts = points[s:s + POINT_CHUNK]
        c = len(pts)
        inside = np.ones(c, dtype=bool)
        w = torch.ones((c, 1), dtype=torch.float64, device=dev)
        cols = torch.zeros((c, 1), dtype=torch.int64, device=dev)
        for d in range(dim):
            inside &= (pts[:, d] >= space.lo[d] - tol) & (
                pts[:, d] <= space.hi[d] + tol)
            xc = np.clip(pts[:, d], space.lo[d], space.hi[d])
            sd, vd = basis_values(space.knots[d], p, xc)
            vd = torch.from_numpy(vd).to(dev)
            w = (w[:, :, None] * vd[:, None, :]).reshape(c, -1)
            i_d = torch.from_numpy(sd).to(dev)[:, None] - p + torch.arange(
                m, device=dev)
            cols = (cols[:, :, None] * space.ncp[d]
                    + i_d[:, None, :]).reshape(c, -1)
        keep = (w.abs() > 1e-14) & torch.from_numpy(inside).to(dev)[:, None]
        count = keep.sum(dim=1)
        if c:
            kmax = max(kmax, int(count.max()))
        # kept entries first, in column order; the rest of a row zero
        order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
        live = slot < count[:, None]
        w = torch.where(live, torch.gather(w, 1, order), 0.0).to(tdt)
        cols = torch.gather(cols, 1, order)
        rows = slice(s * n_fields, (s + c) * n_fields)
        for f in range(n_fields):
            idx[rows][f::n_fields] = torch.where(live, cols + f * nbg,
                                                 0).to(torch.int32)
            val[rows][f::n_fields] = w
    return ExtractionOperator(idx[:, :kmax], val[:, :kmax], nbg * n_fields,
                              device)
