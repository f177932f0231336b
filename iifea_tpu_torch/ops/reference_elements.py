"""P1 Lagrange reference triangle and tetrahedron (numpy copy of the part of
``iifea_tpu/ops/reference_elements.py`` the lattice paths use).

Local node order is the vertex order; facet i is opposite vertex i.
"""
from __future__ import annotations

import numpy as np

# Facets of the reference triangle (edges) and tetrahedron (triangles);
# facet i is opposite vertex i.
TRI_FACETS = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int32)
TET_FACETS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int32
)


def local_facets(dim: int) -> np.ndarray:
    """The reference cell's facet table for a 2D or 3D simplex."""
    return TRI_FACETS if dim == 2 else TET_FACETS


def simplex_vertices(dim: int) -> np.ndarray:
    return np.vstack([np.zeros(dim), np.eye(dim)])


class ReferenceElement:
    """P1 Lagrange basis on the unit triangle or tetrahedron: values and
    reference gradients (constant)."""

    def __init__(self, dim: int = 2, degree: int = 1):
        if dim not in (2, 3) or degree != 1:
            raise ValueError(
                f"the port covers the P1 triangle and tetrahedron, got "
                f"dim={dim} degree={degree}"
            )
        self.dim = dim
        self.degree = degree
        self.node_coords = simplex_vertices(dim)
        self.n_nodes = dim + 1

    def tabulate(self, points: np.ndarray) -> np.ndarray:
        """Basis values (barycentric coordinates), shape (n_points, dim+1)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        lam0 = 1.0 - points.sum(axis=1, keepdims=True)
        return np.hstack([lam0, points])

    def tabulate_grad(self, points: np.ndarray) -> np.ndarray:
        """Reference gradients, shape (n_points, dim+1, dim)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        dlam = np.vstack([-np.ones((1, self.dim)), np.eye(self.dim)])
        return np.broadcast_to(
            dlam, (points.shape[0],) + dlam.shape
        ).copy()

    def facet_to_cell_points(self, local_facet: int,
                             fpts: np.ndarray) -> np.ndarray:
        """Map points on the reference facet simplex (interval [0, 1] in 2D,
        unit triangle in 3D) to cell-reference coordinates on facet
        ``local_facet`` (vertex order of TRI_FACETS / TET_FACETS)."""
        fv = simplex_vertices(self.dim)[local_facets(self.dim)[local_facet]]
        fpts = np.atleast_2d(np.asarray(fpts, dtype=np.float64))
        bary = np.hstack([1.0 - fpts.sum(axis=1, keepdims=True), fpts])
        return bary @ fv
