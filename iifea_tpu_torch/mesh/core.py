"""Mesh and function-space core (numpy copy of ``iifea_tpu/mesh/core.py``
for 2D P1 triangle meshes).

Host-side frozen numpy arrays: node ids are dof ids. The unique-facet
extraction is numpy only (no native library), done with a stable sort of
int64 vertex-pair keys, so it stays fast at millions of cells.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from iifea_tpu_torch.ops.reference_elements import TRI_FACETS, ReferenceElement


@dataclasses.dataclass(frozen=True)
class FacetData:
    """Unique edges of a triangle mesh.

    facet_cells[f] = (c0, c1) adjacent cells, c1 = -1 on the boundary.
    facet_local[f] = local facet index of f within c0 / c1 (-1 if none).
    """

    facets: np.ndarray       # (n_facets, 2) vertex ids (sorted within row)
    facet_cells: np.ndarray  # (n_facets, 2) int32
    facet_local: np.ndarray  # (n_facets, 2) int32


class Mesh:
    """An immutable triangle mesh."""

    def __init__(self, coords: np.ndarray, cells: np.ndarray,
                 material: np.ndarray | None = None):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.dim = self.coords.shape[1]
        if self.dim != 2 or self.cells.shape[1] != 3:
            raise ValueError("the port covers 2D triangle meshes")
        self.n_cells = self.cells.shape[0]
        self.n_verts = self.coords.shape[0]
        if material is None:
            material = np.zeros(self.n_cells, dtype=np.int32)
        self.material = np.asarray(material).astype(np.int32)

    # -- geometry -----------------------------------------------------------

    @cached_property
    def cell_coords(self) -> np.ndarray:
        """(n_cells, 3, 2) vertex coordinates per cell."""
        return self.coords[self.cells]

    @cached_property
    def cell_diameters(self) -> np.ndarray:
        """UFL CellDiameter: max vertex-pair distance per cell."""
        x = self.cell_coords
        d = x[:, :, None, :] - x[:, None, :, :]
        return np.sqrt((d * d).sum(-1)).max(axis=(1, 2))

    # -- topology -----------------------------------------------------------

    @cached_property
    def facet_data(self) -> FacetData:
        """Unique edges, numbered in order of first appearance in the
        (cell, local facet) scan, the order of the reference's native mesh
        library; that first incidence takes slot 0, the second slot 1."""
        nlf = TRI_FACETS.shape[0]
        pairs = np.sort(self.cells[:, TRI_FACETS].reshape(-1, 2), axis=1)
        pairs = pairs.astype(np.int64)
        key = pairs[:, 0] * self.n_verts + pairs[:, 1]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.ones(ks.size, dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        n_facets = int(first.sum())
        # renumber the key-sorted facets by their first incidence
        first_pos = order[first]
        rank = np.empty(n_facets, dtype=np.int64)
        rank[np.argsort(first_pos)] = np.arange(n_facets)
        fid = rank[np.cumsum(first) - 1]
        facet_cells = np.full((n_facets, 2), -1, dtype=np.int32)
        facet_local = np.full((n_facets, 2), -1, dtype=np.int32)
        slot = np.where(first, 0, 1)
        facet_cells[fid, slot] = (order // nlf).astype(np.int32)
        facet_local[fid, slot] = (order % nlf).astype(np.int32)
        facets = np.empty((n_facets, 2), dtype=np.int32)
        facets[rank] = pairs[first_pos]
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


class FunctionSpace:
    """Scalar P1 Lagrange space: cell dofs are the mesh's vertex ids."""

    def __init__(self, mesh: Mesh, degree: int = 1, n_fields: int = 1):
        if degree != 1 or n_fields != 1:
            raise ValueError(
                f"the port covers scalar P1 spaces, got degree={degree} "
                f"n_fields={n_fields}"
            )
        self.mesh = mesh
        self.degree = 1
        self.n_fields = 1
        self.element = ReferenceElement(mesh.dim, 1)
        self.cell_dofs = mesh.cells
        self.n_nodes = mesh.n_verts
        self.node_coords = mesh.coords
        self.n_dofs = self.n_nodes


def flat_dofs(node_ids: np.ndarray, n_fields: int) -> np.ndarray:
    """Interleave node ids into per-field dof ids along the last axis."""
    if n_fields == 1:
        return node_ids
    base = node_ids[..., :, None] * n_fields + np.arange(n_fields)
    out_shape = node_ids.shape[:-1] + (node_ids.shape[-1] * n_fields,)
    return base.reshape(out_shape).astype(np.int32)
