"""Quadrature on the reference triangle, tetrahedron and interval (numpy
copy of ``iifea_tpu/ops/quadrature.py``).

Every rule integrates exactly up to its stated polynomial degree; weights
sum to the reference measure: 1/2 for the triangle, 1/6 for the
tetrahedron, 1 for [0, 1]. 3D facet rules are rescaled to sum to 1: the
physical facet measure (½‖a×b‖) is applied separately.
"""
from __future__ import annotations

import numpy as np


def _perm3(a: float, b: float) -> np.ndarray:
    """The 3 permutations (a,a),(b,a),(a,b) in barycentric (a,a,b=1-2a)."""
    return np.array([[a, a], [b, a], [a, b]])


def triangle_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric Gauss rules on the unit triangle (Dunavant family)."""
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
    elif d == 5:
        a1, w1 = 0.470142064105115, 0.132394152788506
        a2, w2 = 0.101286507323456, 0.125939180544827
        pts = np.vstack(
            [[[1 / 3, 1 / 3]], _perm3(a1, 1 - 2 * a1), _perm3(a2, 1 - 2 * a2)]
        )
        wts = 0.5 * np.array([0.225] + [w1] * 3 + [w2] * 3)
    elif d <= 6:
        a1, w1 = 0.249286745170910, 0.116786275726379
        a2, w2 = 0.063089014491502, 0.050844906370207
        a3, b3, w3 = 0.310352451033785, 0.636502499121399, 0.082851075618374
        g3 = 1.0 - a3 - b3
        six = np.array(
            [[a3, b3], [b3, a3], [a3, g3], [g3, a3], [b3, g3], [g3, b3]]
        )
        pts = np.vstack([_perm3(a1, 1 - 2 * a1), _perm3(a2, 1 - 2 * a2), six])
        wts = 0.5 * np.array([w1] * 3 + [w2] * 3 + [w3] * 6)
    else:
        # tensor-product fallback via Duffy transform (exact to high degree)
        n = (d + 2) // 2 + 1
        x, wx = np.polynomial.legendre.leggauss(n)
        x = 0.5 * (x + 1.0)
        wx = 0.5 * wx
        X, Y = np.meshgrid(x, x, indexing="ij")
        WX, WY = np.meshgrid(wx, wx, indexing="ij")
        u, v = X.ravel(), Y.ravel()
        pts = np.stack([u, v * (1 - u)], axis=1)
        wts = (WX * WY).ravel() * (1 - u)
    return pts, wts


def _tet_perm4(a: float) -> np.ndarray:
    """4 barycentric permutations of (b,a,a,a) mapped to (x,y,z), b=1-3a."""
    b = 1.0 - 3.0 * a
    return np.array([[a, a, a], [b, a, a], [a, b, a], [a, a, b]])


def tet_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Keast rules on the unit tetrahedron."""
    d = max(int(degree), 1)
    if d == 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        wts = np.array([1 / 6])
    elif d == 2:
        a = 0.138196601125011  # (5 - sqrt(5)) / 20
        pts = _tet_perm4(a)
        wts = np.full(4, 1 / 24)
    elif d == 3:
        pts = np.vstack([[[0.25, 0.25, 0.25]], _tet_perm4(1 / 6)])
        wts = np.array([-2 / 15] + [3 / 40] * 4)
    elif d <= 5:
        # Keast 14-point rule, degree 5
        a1, w1 = 0.0927352503108912, 0.0734930431163619 / 6
        a2, w2 = 0.3108859192633005, 0.1126879257180162 / 6
        a3, w3 = 0.0455037041256497, 0.0425460207770812 / 6
        # 6 edge-midpoint-like points (a3, a3, 0.5-a3 pattern)
        b3 = 0.5 - a3
        six = np.array(
            [
                [a3, a3, b3], [a3, b3, a3], [b3, a3, a3],
                [a3, b3, b3], [b3, a3, b3], [b3, b3, a3],
            ]
        )
        pts = np.vstack([_tet_perm4(a1), _tet_perm4(a2), six])
        wts = np.array([w1] * 4 + [w2] * 4 + [w3] * 6)
    else:
        # Duffy-transform tensor fallback
        n = (d + 3) // 2 + 1
        x, wx = np.polynomial.legendre.leggauss(n)
        x = 0.5 * (x + 1.0)
        wx = 0.5 * wx
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        WX, WY, WZ = np.meshgrid(wx, wx, wx, indexing="ij")
        u, v, w = X.ravel(), Y.ravel(), Z.ravel()
        pts = np.stack([u, v * (1 - u), w * (1 - u) * (1 - v)], axis=1)
        wts = (WX * WY * WZ).ravel() * (1 - u) ** 2 * (1 - v)
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
    """Rule on the reference facet simplex (interval in 2D, triangle in 3D).

    3D facet weights are rescaled so they sum to 1: the physical facet measure
    is applied separately as |det| of the facet mapping (area = 0.5 * |cross|),
    keeping the engine uniform across dimensions.
    """
    if dim not in (2, 3):
        raise ValueError(f"the port covers 2D and 3D facets, got dim={dim}")
    if dim == 2:
        return interval_rule(degree)
    pts, wts = triangle_rule(degree)
    return pts, wts * 2.0
