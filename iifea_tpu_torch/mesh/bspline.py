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
        points = np.asarray(points, dtype=np.float64)
        npts = len(points)
        p = self.degree
        inside = np.ones(npts, dtype=bool)
        for d in range(2):
            inside &= (points[:, d] >= self.lo[d] - tol) & (
                points[:, d] <= self.hi[d] + tol
            )
        xc = np.clip(points[:, 0], self.lo[0], self.hi[0])
        yc = np.clip(points[:, 1], self.lo[1], self.hi[1])
        sx, vx = basis_values(self.knots[0], p, xc)
        sy, vy = basis_values(self.knots[1], p, yc)
        # tensor product: (p+1)^2 weights per point
        wij = vx[:, :, None] * vy[:, None, :]           # (np, p+1, p+1)
        ix = (sx[:, None] - p + np.arange(p + 1))       # (np, p+1)
        iy = (sy[:, None] - p + np.arange(p + 1))
        cols = (ix[:, :, None] * self.ncp[1] + iy[:, None, :]).reshape(npts, -1)
        w = wij.reshape(npts, -1)
        rows = np.repeat(np.arange(npts), (p + 1) ** 2)
        keep = (np.abs(w).reshape(-1) > 1e-14) & np.repeat(inside, (p + 1) ** 2)
        return ExtractionOperator.from_triples(
            rows[keep], cols.reshape(-1)[keep], w.reshape(-1)[keep],
            n_fg_nodes=npts, n_bg_nodes=self.n_dofs, n_fields=n_fields,
            dtype=dtype, device=device,
        )


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
        points = np.asarray(points, dtype=np.float64)
        npts = len(points)
        p = self.degree
        inside = np.ones(npts, dtype=bool)
        for d in range(3):
            inside &= (points[:, d] >= self.lo[d] - tol) & (
                points[:, d] <= self.hi[d] + tol
            )
        sv = []
        for d in range(3):
            xc = np.clip(points[:, d], self.lo[d], self.hi[d])
            sv.append(basis_values(self.knots[d], p, xc))
        (sx, vx), (sy, vy), (sz, vz) = sv
        m = p + 1
        wijk = vx[:, :, None, None] * vy[:, None, :, None] \
            * vz[:, None, None, :]                          # (np, m, m, m)
        ix = sx[:, None] - p + np.arange(m)
        iy = sy[:, None] - p + np.arange(m)
        iz = sz[:, None] - p + np.arange(m)
        cols = (
            (ix[:, :, None, None] * self.ncp[1] + iy[:, None, :, None])
            * self.ncp[2] + iz[:, None, None, :]
        ).reshape(npts, -1)
        w = wijk.reshape(npts, -1)
        rows = np.repeat(np.arange(npts), m ** 3)
        keep = (np.abs(w).reshape(-1) > 1e-14) & np.repeat(inside, m ** 3)
        return ExtractionOperator.from_triples(
            rows[keep], cols.reshape(-1)[keep], w.reshape(-1)[keep],
            n_fg_nodes=npts, n_bg_nodes=self.n_dofs, n_fields=n_fields,
            dtype=dtype, device=device,
        )
