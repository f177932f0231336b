"""Mesh and function-space core (numpy copy of ``iifea_tpu/mesh/core.py``
for triangle and tetrahedron meshes with P1 and P2 spaces).

Host-side frozen numpy arrays: node ids are dof ids. The unique facets and
the P2 edge nodes are numbered in numpy (no native library), each with one
stable sort of the sorted vertex tuples, so it stays fast at tens of
millions of incidences; both keep the reference native library's order,
first appearance in the (cell, local entity) scan, so dof vectors of the
two packages compare entry by entry. A mesh read from the reference's files
may carry its own P2 connectivity (``cell_nodes``, the Exodus TRI6/TET10
node ids of ``cell_nodes.csv``); a P2 space on it takes those ids as its
node ids, as the reference's extraction files number them.
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
                 material: np.ndarray | None = None,
                 cell_nodes: np.ndarray | None = None):
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
        # optional P2 connectivity with external node ids (Exodus TRI6/TET10
        # rows of cell_nodes.csv)
        self.cell_nodes = (None if cell_nodes is None
                           else np.ascontiguousarray(cell_nodes,
                                                     dtype=np.int32))

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

    def hmin(self) -> float:
        return float(self.cell_diameters.min())

    def diameters_of(self, cell_ids: np.ndarray) -> np.ndarray:
        """``cell_diameters[cell_ids]``: the largest vertex-pair distance,
        over the distinct pairs (a pair and its reverse have the same
        squared length), 2^20 cells at a time (all pairs of all cells
        at once are a (n_cells, 4, 4, 3) f64 array, 5 GB at 13 M
        tetrahedra). Once ``cell_diameters`` is computed, its entries."""
        cell_ids = np.asarray(cell_ids, dtype=np.int64)
        if "cell_diameters" in self.__dict__:
            return self.cell_diameters[cell_ids]
        a, b = np.triu_indices(self.dim + 1, k=1)
        out = np.empty(len(cell_ids))
        for s in range(0, len(cell_ids), 2 ** 20):
            x = self.coords[self.cells[cell_ids[s:s + 2 ** 20]]]
            # pair by pair: the same sums and max as on all pairs at once,
            # without their (cells, pairs, dim) copy
            sq = np.zeros(len(x))
            for i, j in zip(a, b):
                d = x[:, i, :] - x[:, j, :]
                np.maximum(sq, (d * d).sum(-1), out=sq)
            out[s:s + 2 ** 20] = np.sqrt(sq)
        return out

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
        fid, order, first, rank = _first_appearance(tup, self.n_verts)
        n_facets = rank.size
        facet_cells = np.full((n_facets, 2), -1, dtype=np.int32)
        facet_local = np.full((n_facets, 2), -1, dtype=np.int32)
        slot = np.where(first, 0, 1)
        facet_cells[fid[order], slot] = (order // nlf).astype(np.int32)
        facet_local[fid[order], slot] = (order % nlf).astype(np.int32)
        facets = np.empty((n_facets, nfv), dtype=np.int32)
        facets[rank] = tup[order[first]]
        return FacetData(facets, facet_cells, facet_local)

    @cached_property
    def p2_nodes(self) -> tuple[np.ndarray, int, np.ndarray]:
        """P2 node numbering of the mesh: (cell dofs (n_cells, n_local),
        node count, node coordinates), computed once per mesh (a generator
        and the problem on its mesh both build the P2 space: 72 M edge
        incidences at 12 M tetrahedra)."""
        cell_dofs, n_nodes, edge_first = _number_p2(self)
        return cell_dofs, n_nodes, _p2_node_coords(self, edge_first)

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

    def filter_small_cells(self, tol: float, block_id: int = 2,
                           facet_class: np.ndarray | None = None,
                           surf_id: int = 3):
        """Small-cut-cell volume filter: block cells (material
        ``block_id``) of volume < tol·hmax^dim leave the block (material 0)
        and their facets of class ``surf_id`` leave the surface (class 0).
        Returns (material, facet classes, cells removed, facets removed)."""
        vol_limit = self.hmax() ** self.dim * tol
        material = self.material.copy()
        small = (self.cell_volumes < vol_limit) & (material == block_id)
        material[small] = 0
        n_facet_elim = 0
        if facet_class is not None:
            facet_class = facet_class.copy()
            fc = self.facet_data.facet_cells
            adj = small[fc[:, 0]] | ((fc[:, 1] >= 0) & small[fc[:, 1]])
            kill = adj & (facet_class == surf_id)
            n_facet_elim = int(kill.sum())
            facet_class[kill] = 0
        return material, facet_class, int(small.sum()), n_facet_elim


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


def _first_appearance(tup: np.ndarray, n: int):
    """Number the distinct rows of ``tup`` (values < n) by their first
    appearance. Returns (id of every row, the rows' stable sort order,
    whether each sorted row is its group's first, rank: id of each group in
    sorted order)."""
    order = _stable_row_order(tup, n)
    ts = tup[order]
    first = np.ones(order.size, dtype=bool)
    first[1:] = (ts[1:] != ts[:-1]).any(axis=1)
    del ts
    first_pos = order[first]
    rank = np.empty(first_pos.size, dtype=np.int64)
    rank[np.argsort(first_pos)] = np.arange(first_pos.size)
    ids = np.empty(order.size, dtype=np.int64)
    ids[order] = rank[np.cumsum(first) - 1]
    return ids, order, first, rank


class FunctionSpace:
    """Lagrange space of degree 1 or 2 with ``n_fields`` components. Cell
    dofs are node ids, (n_cells, n_local_nodes): the mesh's vertex ids for
    P1; for P2 the vertices keep their ids and the edge nodes follow,
    numbered by first appearance, unless the mesh carries ``cell_nodes``:
    then those (Exodus) ids are the node ids, n_nodes = max + 1, and the
    node coordinates come from the cell geometry. The per-field dof id is
    node·n_fields + field."""

    def __init__(self, mesh: Mesh, degree: int = 1, n_fields: int = 1):
        if degree not in (1, 2):
            raise ValueError(
                f"the port covers P1 and P2 spaces, got degree={degree}")
        self.mesh = mesh
        self.degree = int(degree)
        self.n_fields = int(n_fields)
        self.element = ReferenceElement(mesh.dim, self.degree)
        if self.degree == 1:
            self.cell_dofs = mesh.cells
            self.n_nodes = mesh.n_verts
            self.node_coords = mesh.coords
        elif mesh.cell_nodes is not None:
            cn = mesh.cell_nodes
            if cn.shape[1] != self.element.n_nodes:
                raise ValueError(f"cell_nodes has {cn.shape[1]} columns, "
                                 f"expected {self.element.n_nodes}")
            self.cell_dofs = cn
            self.n_nodes = int(cn.max()) + 1
            self.node_coords = _exodus_p2_coords(mesh, cn, self.n_nodes)
        else:
            self.cell_dofs, self.n_nodes, self.node_coords = mesh.p2_nodes
        self.n_dofs = self.n_nodes * self.n_fields

    def flat_cell_dofs(self) -> np.ndarray:
        """(n_cells, n_local_nodes·n_fields) interleaved global dof ids."""
        return flat_dofs(self.cell_dofs, self.n_fields)


def flat_dofs(node_ids: np.ndarray, n_fields: int) -> np.ndarray:
    """Interleave node ids into per-field dof ids along the last axis."""
    if n_fields == 1:
        return node_ids
    base = node_ids[..., :, None] * n_fields + np.arange(n_fields)
    out_shape = node_ids.shape[:-1] + (node_ids.shape[-1] * n_fields,)
    return base.reshape(out_shape).astype(np.int32)


def _number_p2(mesh: Mesh) -> tuple[np.ndarray, int, np.ndarray]:
    """P2 node ids: the vertices keep theirs, each unique edge gets
    n_verts + its number in order of first appearance in the (cell, local
    edge) scan (the reference's native ``mesh_number_edges``). Returns
    (cell dofs, node count, the scan position of each edge's first
    appearance)."""
    edges = ReferenceElement(mesh.dim, 2).edges
    tup = np.sort(mesh.cells[:, edges].reshape(-1, 2), axis=1)
    ids, order, first, rank = _first_appearance(tup, mesh.n_verts)
    edge_ids = (mesh.n_verts + ids).reshape(mesh.n_cells, -1)
    cell_dofs = np.hstack([mesh.cells, edge_ids]).astype(np.int32)
    edge_first = np.empty(rank.size, dtype=np.int64)
    edge_first[rank] = order[first]
    return cell_dofs, mesh.n_verts + rank.size, edge_first


def _p2_node_coords(mesh: Mesh, edge_first: np.ndarray) -> np.ndarray:
    """P2 node coordinates (straight-sided): the vertices (zero where no
    cell uses one), then each edge's midpoint, from its first (cell, local
    edge) incidence (every incidence gives the same value: a + b = b +
    a)."""
    edges = ReferenceElement(mesh.dim, 2).edges
    cell, local = np.divmod(edge_first, len(edges))
    verts = mesh.cells[cell[:, None], edges[local]]          # (n_edges, 2)
    mids = 0.5 * (mesh.coords[verts[:, 0]] + mesh.coords[verts[:, 1]])
    used = np.zeros(mesh.n_verts, dtype=bool)
    used[mesh.cells.ravel()] = True
    return np.concatenate([np.where(used[:, None], mesh.coords, 0.0), mids])


def _exodus_p2_coords(mesh: Mesh, cell_dofs: np.ndarray,
                      n_nodes: int) -> np.ndarray:
    """Node coordinates of a P2 space on external node ids (straight-sided):
    each cell's vertex nodes take its vertices' coordinates, its edge nodes
    the midpoints of the reference element's edges; an id no cell uses
    stays at zero."""
    edges = ReferenceElement(mesh.dim, 2).edges
    nv = mesh.dim + 1
    coords = np.zeros((n_nodes, mesh.dim))
    coords[cell_dofs[:, :nv].ravel()] = mesh.coords[mesh.cells.ravel()]
    mids = 0.5 * (mesh.coords[mesh.cells[:, edges[:, 0]]]
                  + mesh.coords[mesh.cells[:, edges[:, 1]]])
    coords[cell_dofs[:, nv:].ravel()] = mids.reshape(-1, mesh.dim)
    return coords
