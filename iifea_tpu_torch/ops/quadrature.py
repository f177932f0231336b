"""Quadrature on the reference triangle and interval (numpy copy of the 2D
part of ``iifea_tpu/ops/quadrature.py``).

Weights sum to the reference measure: 1/2 for the triangle, 1 for [0, 1].
"""
from __future__ import annotations

import numpy as np


def _perm3(a: float, b: float) -> np.ndarray:
    """The 3 permutations (a,a),(b,a),(a,b) in barycentric (a,a,b=1-2a)."""
    return np.array([[a, a], [b, a], [a, b]])


def triangle_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric Gauss rules on the unit triangle, degree ≤ 2."""
    d = max(int(degree), 1)
    if d == 1:
        pts = np.array([[1 / 3, 1 / 3]])
        wts = np.array([0.5])
    elif d == 2:
        pts = _perm3(1 / 6, 2 / 3)
        wts = np.full(3, 1 / 6)
    else:
        raise ValueError(f"triangle rules up to degree 2, got {degree}")
    return pts, wts


def interval_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0, 1] exact to the given degree; pts shape (n, 1)."""
    n = max((int(degree) + 2) // 2, 1)
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0))[:, None], 0.5 * w


def cell_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    if dim != 2:
        raise ValueError(f"the port covers 2D cells, got dim={dim}")
    return triangle_rule(degree)


def facet_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    if dim != 2:
        raise ValueError(f"the port covers 2D facets, got dim={dim}")
    return interval_rule(degree)
