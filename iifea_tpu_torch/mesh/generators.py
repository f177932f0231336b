"""Structured mesh generation and runtime extraction (numpy port of the
parts of ``iifea_tpu/mesh/generators.py`` the lattice paths use).

``immersed_square_problem`` is the synthetic cut-square workload: a
structured foreground triangle mesh with the cells inside a rotated square
marked as the block (material 2), and a coarser structured background
triangle grid; M interpolates the background P1 space at the foreground
nodes. ``immersed_cube_problem`` is its 3D analog on Kuhn tetrahedra.
"""
from __future__ import annotations

import numpy as np

from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.extraction import ExtractionOperator


def rectangle_mesh(p0, p1, nx: int, ny: int) -> Mesh:
    """Structured triangle mesh, 2 triangles per quad ('right' diagonal);
    vertex id = i·(ny+1) + j."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00, v10 = vid(i, j).ravel(), vid(i + 1, j).ravel()
    v01, v11 = vid(i, j + 1).ravel(), vid(i + 1, j + 1).ravel()
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    mesh = Mesh(coords, np.concatenate([t1, t2], axis=0))
    mesh.structured = ("rect", np.asarray(p0, float), np.asarray(p1, float),
                       nx, ny)
    return mesh


def box_mesh(p0, p1, nx: int, ny: int, nz: int) -> Mesh:
    """Structured tetrahedron mesh, 6 tets per hex (Kuhn triangulation);
    vertex id = (i·(ny+1) + j)·(nz+1) + k."""
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    z = np.linspace(p0[2], p1[2], nz + 1)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    c = {
        (a, b, d): vid(i + a, j + b, k + d).ravel().astype(np.int32)
        for a in (0, 1) for b in (0, 1) for d in (0, 1)
    }
    # Kuhn: 6 tets around the main diagonal (0,0,0)-(1,1,1)
    paths = [
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],
    ]
    cells = np.concatenate(
        [np.stack([c[v] for v in p], axis=1) for p in paths], axis=0
    )
    mesh = Mesh(coords, cells)
    mesh.structured = ("box", np.asarray(p0, float), np.asarray(p1, float),
                       nx, ny, nz)
    return mesh


def _rotate(coords: np.ndarray, angle_deg: float,
            axis: int = 2) -> np.ndarray:
    """Rotate points by ``angle_deg`` in the plane (2D) or about ``axis``
    (3D; about y in DOLFIN's sense)."""
    a = np.deg2rad(angle_deg)
    ca, sa = np.cos(a), np.sin(a)
    out = coords.copy()
    if coords.shape[1] == 2:
        out[:, 0] = ca * coords[:, 0] - sa * coords[:, 1]
        out[:, 1] = sa * coords[:, 0] + ca * coords[:, 1]
        return out
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    u, v = coords[:, i].copy(), coords[:, j].copy()
    s = -sa if axis == 1 else sa
    out[:, i] = ca * u - s * v
    out[:, j] = s * u + ca * v
    return out


def generate_unfitted_mesh(L_f: float, L_b: float, N_f: int, N_b: int,
                           dim: int = 2, rotate_f: bool = False,
                           rotate_b: bool = False, angle: float = 30.0):
    """generateUnfittedMesh parity: (foreground, background) structured
    meshes, optionally rotated. The reference's 2D foreground uses (N_f,
    N_b) divisions, reproduced verbatim. A rotated mesh loses its
    structured tag (``transfer_matrix_simplex`` locates points only in an
    unrotated grid)."""
    if dim == 2:
        mesh_f = rectangle_mesh((-L_f / 2, -L_f / 2), (L_f / 2, L_f / 2),
                                N_f, N_b)
        mesh_b = rectangle_mesh((-L_b / 2, -L_b / 2), (L_b / 2, L_b / 2),
                                N_b, N_b)
        if rotate_f:
            mesh_f = Mesh(_rotate(mesh_f.coords, angle), mesh_f.cells)
        if rotate_b:
            mesh_b = Mesh(_rotate(mesh_b.coords, angle), mesh_b.cells)
    elif dim == 3:
        mesh_b = box_mesh((-L_b / 2,) * 3, (L_b / 2,) * 3, N_b, N_b, N_b)
        mesh_f = box_mesh((-L_f / 2,) * 3, (L_f / 2,) * 3, N_f, N_f, N_f)
        if rotate_f:
            mesh_f = Mesh(_rotate(_rotate(mesh_f.coords, angle, 2), angle, 1),
                          mesh_f.cells)
        if rotate_b:
            mesh_b = Mesh(_rotate(_rotate(mesh_b.coords, angle, 2), angle, 1),
                          mesh_b.cells)
    else:
        raise ValueError(f"Dimension of {dim} is not supported!")
    return mesh_f, mesh_b


def locate_structured_rect(mesh: Mesh, points: np.ndarray,
                           tol: float = 1e-10):
    """O(1) vectorized point location in a structured rectangle_mesh.

    Returns (cell ids, reference coordinates); outside points get id -1.
    """
    _, p0, p1, nx, ny = mesh.structured
    points = np.asarray(points, dtype=np.float64)
    rel = (points - p0) / (p1 - p0)
    inside = (rel.min(1) >= -tol) & (rel.max(1) <= 1 + tol)
    gx = np.clip(rel[:, 0] * nx, 0, nx * (1 - 1e-15))
    gy = np.clip(rel[:, 1] * ny, 0, ny * (1 - 1e-15))
    i = np.minimum(gx.astype(np.int64), nx - 1)
    j = np.minimum(gy.astype(np.int64), ny - 1)
    s = gx - i
    t = gy - j
    lower = s >= t  # triangle t1 = (v00, v10, v11) covers s >= t
    quad = i * ny + j
    cell = np.where(lower, quad, nx * ny + quad)
    ref_lower = np.stack([s - t, t], axis=1)   # verts (0,0),(1,0),(1,1)
    ref_upper = np.stack([s, t - s], axis=1)   # verts (0,0),(1,1),(0,1)
    ref = np.where(lower[:, None], ref_lower, ref_upper)
    return np.where(inside, cell, -1), ref


def locate_structured_box(mesh: Mesh, points: np.ndarray,
                          tol: float = 1e-10):
    """O(1) vectorized point location in a box_mesh (Kuhn triangulation).

    The 6 tets of each hex are the regions x_α >= x_β >= x_γ of the local
    cube coordinates, one per axis permutation; the containing tet is read
    off an argsort and the reference coordinates are the consecutive
    differences of the sorted coordinates. Outside points get id -1."""
    _, p0, p1, nx, ny, nz = mesh.structured
    points = np.asarray(points, dtype=np.float64)
    rel = (points - p0) / (p1 - p0)
    inside = (rel.min(1) >= -tol) & (rel.max(1) <= 1 + tol)
    n = np.array([nx, ny, nz])
    g = np.clip(rel * n, 0, n * (1 - 1e-15))
    ijk = np.minimum(g.astype(np.int64), n - 1)
    s = g - ijk                                      # local cube coords
    order = np.argsort(-s, axis=1, kind="stable")    # (np, 3): α, β, γ
    # path index per axis-addition order (matches box_mesh's `paths` list)
    path_of = np.full(27, -1, dtype=np.int64)
    for p, (a, b_, c) in enumerate(
        [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    ):
        path_of[a * 9 + b_ * 3 + c] = p
    path = path_of[order[:, 0] * 9 + order[:, 1] * 3 + order[:, 2]]
    quad = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    cell = path * (nx * ny * nz) + quad
    srt = np.take_along_axis(s, order, axis=1)
    ref = np.stack([srt[:, 0] - srt[:, 1], srt[:, 1] - srt[:, 2], srt[:, 2]],
                   axis=1)
    return np.where(inside, cell, -1), ref


def transfer_matrix_simplex(mesh_b: Mesh, points: np.ndarray,
                            degree: int = 1, n_fields: int = 1,
                            tol: float = 1e-10, dtype=np.float64, *,
                            device="cuda") -> ExtractionOperator:
    """P1 interpolation matrix from a structured background triangle or
    tetrahedron grid to points: row i holds the basis values of the
    background cell that contains point i, replicated over ``n_fields``
    fields (ExtractionOperator's multi-field layout). Points outside the
    grid get zero rows."""
    if getattr(mesh_b, "structured", None) is None:
        raise ValueError("the port locates points in rectangle_mesh and "
                         "box_mesh grids")
    Vb = FunctionSpace(mesh_b, degree=degree)
    points = np.asarray(points, dtype=np.float64)
    npts = points.shape[0]
    locate = (locate_structured_rect if mesh_b.structured[0] == "rect"
              else locate_structured_box)
    cell_idx, ref = locate(mesh_b, points, tol)
    inside = cell_idx >= 0
    safe_cells = np.maximum(cell_idx, 0)
    vals = Vb.element.tabulate(ref)                   # (np, dim+1)
    cols = np.asarray(Vb.cell_dofs)[safe_cells]       # (np, dim+1)
    rows = np.repeat(np.arange(npts), vals.shape[1])
    mask = np.repeat(inside, vals.shape[1])
    v = vals.ravel()
    keep = mask & (np.abs(v) > 1e-14)
    return ExtractionOperator.from_triples(
        rows[keep], cols.ravel()[keep], v[keep], n_fg_nodes=npts,
        n_bg_nodes=Vb.n_nodes, n_fields=n_fields, dtype=dtype,
        device=device,
    )


def immersed_square_problem(n_fg: int, n_bg: int, L: float = 2.0,
                            angle: float = 30.0, half_width: float = 0.6,
                            degree: int = 1, n_fields: int = 1,
                            dtype=np.float64, *,
                            device="cuda"):
    """Rotated square of half-width ``half_width`` immersed in [-L/2, L/2]²:
    foreground cells whose centroid lies inside are the block (material 2),
    the rest material 1. M carries ``n_fields`` fields per node (2 for
    2D elasticity). Returns (mesh_f, M)."""
    mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    material = np.where(
        (np.abs(u) <= half_width) & (np.abs(v) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)
    mesh_b = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_bg, n_bg)
    Vf = FunctionSpace(mesh_f, degree=degree)
    M = transfer_matrix_simplex(mesh_b, np.asarray(Vf.node_coords),
                                degree=degree, n_fields=n_fields,
                                dtype=dtype, device=device)
    return mesh_f, M


def immersed_cube_problem(n_fg: int, n_bg: int, L: float = 2.0,
                          angle: float = 30.0, half_width: float = 0.6,
                          degree: int = 1, n_fields: int = 1,
                          dtype=np.float64, *,
                          device="cuda"):
    """3D analog of immersed_square_problem: a cube of half-width
    ``half_width``, rotated by ``angle`` about z then y, immersed in a
    structured tetrahedron block over [-L/2, L/2]³. Background node ids
    follow box_mesh (id = (i·(n_bg+1) + j)·(n_bg+1) + k), the layout of
    StencilOperator3D. Returns (mesh_f, M)."""
    mesh_f = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_fg, n_fg, n_fg)
    cent = np.zeros((mesh_f.n_cells, 3))
    for v in range(4):
        cent += mesh_f.coords[mesh_f.cells[:, v]]
    cent /= 4.0
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    w = cent[:, 2]
    u2 = ca * u + sa * w
    w2 = -sa * u + ca * w
    material = np.where(
        (np.abs(u2) <= half_width) & (np.abs(v) <= half_width)
        & (np.abs(w2) <= half_width), 2, 1
    ).astype(np.int32)
    mesh_f = Mesh(mesh_f.coords, mesh_f.cells, material)
    mesh_b = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_bg, n_bg, n_bg)
    Vf = FunctionSpace(mesh_f, degree=degree)
    M = transfer_matrix_simplex(mesh_b, np.asarray(Vf.node_coords),
                                degree=degree, n_fields=n_fields,
                                dtype=dtype, device=device)
    return mesh_f, M
