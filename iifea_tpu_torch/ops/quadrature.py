"""Quadrature on the reference triangle, tetrahedron and interval (numpy
copy of the low-degree part of ``iifea_tpu/ops/quadrature.py``).

Weights sum to the reference measure: 1/2 for the triangle, 1/6 for the
tetrahedron, 1 for [0, 1]. 3D facet rules are rescaled to sum to 1: the
physical facet measure (½‖a×b‖) is applied separately.
"""
from __future__ import annotations

import numpy as np


def _perm3(a: float, b: float) -> np.ndarray:
    """The 3 permutations (a,a),(b,a),(a,b) in barycentric (a,a,b=1-2a)."""
    return np.array([[a, a], [b, a], [a, b]])


def triangle_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric Gauss rules on the unit triangle (Dunavant family),
    degree ≤ 4."""
    d = max(int(degree), 1)
    if d == 1:
        pts = np.array([[1 / 3, 1 / 3]])
        wts = np.array([0.5])
    elif d == 2:
        pts = _perm3(1 / 6, 2 / 3)
        wts = np.full(3, 1 / 6)
    elif d == 3:
        pts = np.vstack([[[1 / 3, 1 / 3]], _perm3(0.2, 0.6)])
        wts = 0.5 * np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])
    elif d == 4:
        a1, w1 = 0.445948490915965, 0.223381589678011
        a2, w2 = 0.091576213509771, 0.109951743655322
        pts = np.vstack([_perm3(a1, 1 - 2 * a1), _perm3(a2, 1 - 2 * a2)])
        wts = 0.5 * np.array([w1] * 3 + [w2] * 3)
    else:
        raise ValueError(f"triangle rules up to degree 4, got {degree}")
    return pts, wts


def _tet_perm4(a: float) -> np.ndarray:
    """4 barycentric permutations of (b,a,a,a) mapped to (x,y,z), b=1-3a."""
    b = 1.0 - 3.0 * a
    return np.array([[a, a, a], [b, a, a], [a, b, a], [a, a, b]])


def tet_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Keast rules on the unit tetrahedron, degree ≤ 3."""
    d = max(int(degree), 1)
    if d == 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        wts = np.array([1 / 6])
    elif d == 2:
        pts = _tet_perm4(0.138196601125011)     # (5 - sqrt(5)) / 20
        wts = np.full(4, 1 / 24)
    elif d == 3:
        pts = np.vstack([[[0.25, 0.25, 0.25]], _tet_perm4(1 / 6)])
        wts = np.array([-2 / 15] + [3 / 40] * 4)
    else:
        raise ValueError(f"tetrahedron rules up to degree 3, got {degree}")
    return pts, wts


def interval_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0, 1] exact to the given degree; pts shape (n, 1)."""
    n = max((int(degree) + 2) // 2, 1)
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0))[:, None], 0.5 * w


def cell_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    if dim not in (2, 3):
        raise ValueError(f"the port covers 2D and 3D cells, got dim={dim}")
    return triangle_rule(degree) if dim == 2 else tet_rule(degree)


def facet_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    if dim not in (2, 3):
        raise ValueError(f"the port covers 2D and 3D facets, got dim={dim}")
    if dim == 2:
        return interval_rule(degree)
    pts, wts = triangle_rule(degree)
    return pts, wts * 2.0
