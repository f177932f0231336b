"""Mesh and function-space core (numpy copy of ``iifea_tpu/mesh/core.py``
for P1 triangle and tetrahedron meshes).

Host-side frozen numpy arrays: node ids are dof ids. The unique-facet
extraction is numpy only (no native library), done with one stable sort of
the sorted facet vertex tuples, so it stays fast at tens of millions of
(cell, facet) incidences.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from iifea_tpu_torch.ops.reference_elements import (
    ReferenceElement,
    local_facets,
)


@dataclasses.dataclass(frozen=True)
class FacetData:
    """Unique facets (edges in 2D, triangles in 3D) of a simplex mesh.

    facet_cells[f] = (c0, c1) adjacent cells, c1 = -1 on the boundary.
    facet_local[f] = local facet index of f within c0 / c1 (-1 if none).
    """

    facets: np.ndarray       # (n_facets, dim) vertex ids (sorted within row)
    facet_cells: np.ndarray  # (n_facets, 2) int32
    facet_local: np.ndarray  # (n_facets, 2) int32


class Mesh:
    """An immutable simplex mesh (triangles in 2D, tetrahedra in 3D)."""

    def __init__(self, coords: np.ndarray, cells: np.ndarray,
                 material: np.ndarray | None = None):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.dim = self.coords.shape[1]
        if self.dim not in (2, 3) or self.cells.shape[1] != self.dim + 1:
            raise ValueError(
                "the port covers triangle (2D) and tetrahedron (3D) meshes, "
                f"got {self.cells.shape[1]} vertices per cell in {self.dim}D"
            )
        self.n_cells = self.cells.shape[0]
        self.n_verts = self.coords.shape[0]
        if material is None:
            material = np.zeros(self.n_cells, dtype=np.int32)
        self.material = np.asarray(material).astype(np.int32)

    # -- geometry -----------------------------------------------------------

    @cached_property
    def cell_coords(self) -> np.ndarray:
        """(n_cells, dim+1, dim) vertex coordinates per cell."""
        return self.coords[self.cells]

    @cached_property
    def cell_diameters(self) -> np.ndarray:
        """UFL CellDiameter: max vertex-pair distance per cell."""
        return self.diameters_of(np.arange(self.n_cells))

    @cached_property
    def cell_volumes(self) -> np.ndarray:
        x = self.cell_coords
        det = np.linalg.det(x[:, 1:, :] - x[:, :1, :])
        return np.abs(det) / (2.0 if self.dim == 2 else 6.0)

    def hmax(self) -> float:
        return float(self.cell_diameters.max())

    def diameters_of(self, cell_ids: np.ndarray) -> np.ndarray:
        """``cell_diameters[cell_ids]`` without the whole-mesh temporaries
        (a (n_cells, 4, 4, 3) f64 array is 5 GB at 13M tetrahedra)."""
        x = self.coords[self.cells[np.asarray(cell_ids, dtype=np.int64)]]
        d = x[:, :, None, :] - x[:, None, :, :]
        return np.sqrt((d * d).sum(-1)).max(axis=(1, 2))

    # -- topology -----------------------------------------------------------

    @cached_property
    def facet_data(self) -> FacetData:
        """Unique facets, numbered in order of first appearance in the
        (cell, local facet) scan, the order of the reference's native mesh
        library; that first incidence takes slot 0, the last later one
        slot 1."""
        lf = local_facets(self.dim)
        nlf, nfv = lf.shape
        tup = np.sort(self.cells[:, lf].reshape(-1, nfv), axis=1)
        order = _stable_row_order(tup, self.n_verts)
        ts = tup[order]
        first = np.ones(order.size, dtype=bool)
        first[1:] = (ts[1:] != ts[:-1]).any(axis=1)
        del ts
        n_facets = int(first.sum())
        # renumber the sorted facets by their first incidence
        first_pos = order[first]
        rank = np.empty(n_facets, dtype=np.int64)
        rank[np.argsort(first_pos)] = np.arange(n_facets)
        fid = rank[np.cumsum(first) - 1]
        facet_cells = np.full((n_facets, 2), -1, dtype=np.int32)
        facet_local = np.full((n_facets, 2), -1, dtype=np.int32)
        slot = np.where(first, 0, 1)
        facet_cells[fid, slot] = (order // nlf).astype(np.int32)
        facet_local[fid, slot] = (order % nlf).astype(np.int32)
        facets = np.empty((n_facets, nfv), dtype=np.int32)
        facets[rank] = tup[first_pos]
        return FacetData(facets, facet_cells, facet_local)

    @cached_property
    def num_facets(self) -> int:
        return self.facet_data.facets.shape[0]

    def classify_facets_by_material(self) -> np.ndarray:
        """marker = sum of adjacent cell materials (boundary facets once):
        1 or 2 -> class 1, 4 -> class 2, 3 -> class 3 (the Nitsche
        interface)."""
        fd = self.facet_data
        m0 = self.material[fd.facet_cells[:, 0]]
        m1 = np.where(
            fd.facet_cells[:, 1] >= 0, self.material[fd.facet_cells[:, 1]], 0
        )
        marker = m0 + m1
        out = np.zeros(self.num_facets, dtype=np.int32)
        out[(marker == 1) | (marker == 2)] = 1
        out[marker == 4] = 2
        out[marker == 3] = 3
        return out


def _stable_row_order(tup: np.ndarray, n: int) -> np.ndarray:
    """Stable lexicographic order of the rows of ``tup`` (values < n).

    A row packs into one unsigned 64-bit key a·n² + b·n + c while n^width
    fits (2.25M vertices in 3D: n³ ≈ 1.14e19 overflows int64 but not
    uint64); otherwise a lexsort."""
    width = tup.shape[1]
    if n ** width < 2 ** 64:
        key = np.zeros(tup.shape[0], dtype=np.uint64)
        for col in range(width):
            key = key * np.uint64(n) + tup[:, col].astype(np.uint64)
        return np.argsort(key, kind="stable")
    return np.lexsort(tup.T[::-1])


class FunctionSpace:
    """P1 Lagrange space with ``n_fields`` components: cell dofs are the
    mesh's vertex ids (node ids); the per-field dof id is
    node·n_fields + field."""

    def __init__(self, mesh: Mesh, degree: int = 1, n_fields: int = 1):
        if degree != 1:
            raise ValueError(f"the port covers P1 spaces, got degree={degree}")
        self.mesh = mesh
        self.degree = 1
        self.n_fields = int(n_fields)
        self.element = ReferenceElement(mesh.dim, 1)
        self.cell_dofs = mesh.cells
        self.n_nodes = mesh.n_verts
        self.node_coords = mesh.coords
        self.n_dofs = self.n_nodes * self.n_fields


def flat_dofs(node_ids: np.ndarray, n_fields: int) -> np.ndarray:
    """Interleave node ids into per-field dof ids along the last axis."""
    if n_fields == 1:
        return node_ids
    base = node_ids[..., :, None] * n_fields + np.arange(n_fields)
    out_shape = node_ids.shape[:-1] + (node_ids.shape[-1] * n_fields,)
    return base.reshape(out_shape).astype(np.int32)
