"""P1 and P2 Lagrange reference triangle and tetrahedron (numpy copy of
``iifea_tpu/ops/reference_elements.py``).

Local node order: the vertices, then (P2) the edge midpoints in the Exodus
midside order (0,1),(1,2),(2,0) on the triangle and
(0,1),(1,2),(2,0),(0,3),(1,3),(2,3) on the tetrahedron. Facet i is opposite
vertex i.
"""
from __future__ import annotations

import numpy as np

# Edges of the reference triangle / tetrahedron in Exodus midside order.
TRI_EDGES = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int32)
TET_EDGES = np.array(
    [[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]], dtype=np.int32
)

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


def _bary(points: np.ndarray) -> np.ndarray:
    """Barycentric coordinates (n, dim+1) of reference-cell points (n, dim)."""
    return np.hstack([1.0 - points.sum(axis=1, keepdims=True), points])


def _dbary(dim: int) -> np.ndarray:
    """d(lambda_i)/d(xi_j), shape (dim+1, dim)."""
    return np.vstack([-np.ones((1, dim)), np.eye(dim)])


class ReferenceElement:
    """P1/P2 Lagrange basis on the unit triangle or tetrahedron: values,
    reference gradients and reference Hessians."""

    def __init__(self, dim: int = 2, degree: int = 1):
        if dim not in (2, 3) or degree not in (1, 2):
            raise ValueError(
                f"the port covers P1 and P2 triangles and tetrahedra, got "
                f"dim={dim} degree={degree}"
            )
        self.dim = dim
        self.degree = degree
        verts = simplex_vertices(dim)
        self.edges = TRI_EDGES if dim == 2 else TET_EDGES
        if degree == 1:
            self.node_coords = verts
        else:
            mids = 0.5 * (verts[self.edges[:, 0]] + verts[self.edges[:, 1]])
            self.node_coords = np.vstack([verts, mids])
        self.n_nodes = self.node_coords.shape[0]

    def tabulate(self, points: np.ndarray) -> np.ndarray:
        """Basis values, shape (n_points, n_nodes)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        lam = _bary(points)
        if self.degree == 1:
            return lam
        nv = self.dim + 1
        vals = np.empty((points.shape[0], self.n_nodes))
        vals[:, :nv] = lam * (2.0 * lam - 1.0)
        for e, (i, j) in enumerate(self.edges):
            vals[:, nv + e] = 4.0 * lam[:, i] * lam[:, j]
        return vals

    def tabulate_grad(self, points: np.ndarray) -> np.ndarray:
        """Reference gradients, shape (n_points, n_nodes, dim)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        dlam = _dbary(self.dim)
        n, nv = points.shape[0], self.dim + 1
        if self.degree == 1:
            return np.broadcast_to(dlam, (n, nv, self.dim)).copy()
        lam = _bary(points)
        grads = np.empty((n, self.n_nodes, self.dim))
        grads[:, :nv, :] = (4.0 * lam - 1.0)[:, :, None] * dlam[None, :, :]
        for e, (i, j) in enumerate(self.edges):
            grads[:, nv + e, :] = 4.0 * (
                lam[:, i, None] * dlam[None, j, :]
                + lam[:, j, None] * dlam[None, i, :]
            )
        return grads

    def tabulate_hess(self, points: np.ndarray) -> np.ndarray:
        """Reference Hessians, shape (n_points, n_nodes, dim, dim): zero for
        P1, constant for P2 (the biharmonic's second derivatives)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        dlam = _dbary(self.dim)
        nv = self.dim + 1
        hess = np.zeros((points.shape[0], self.n_nodes, self.dim, self.dim))
        if self.degree == 1:
            return hess
        for v in range(nv):
            hess[:, v] = 4.0 * np.outer(dlam[v], dlam[v])
        for e, (i, j) in enumerate(self.edges):
            hess[:, nv + e] = 4.0 * (np.outer(dlam[i], dlam[j])
                                     + np.outer(dlam[j], dlam[i]))
        return hess

    def facet_to_cell_points(self, local_facet: int,
                             fpts: np.ndarray) -> np.ndarray:
        """Map points on the reference facet simplex (interval [0, 1] in 2D,
        unit triangle in 3D) to cell-reference coordinates on facet
        ``local_facet`` (vertex order of TRI_FACETS / TET_FACETS)."""
        fv = simplex_vertices(self.dim)[local_facets(self.dim)[local_facet]]
        fpts = np.atleast_2d(np.asarray(fpts, dtype=np.float64))
        bary = np.hstack([1.0 - fpts.sum(axis=1, keepdims=True), fpts])
        return bary @ fv
