"""Structured mesh generation and runtime extraction (numpy port of the
parts of ``iifea_tpu/mesh/generators.py`` the lattice paths use).

``immersed_square_problem`` is the synthetic cut-square workload: a
structured foreground triangle mesh with the cells inside a rotated square
marked as the block (material 2), and a coarser structured background
triangle grid; M interpolates the background P1 (or P2) space at the
foreground nodes. ``immersed_cube_problem`` is its 3D analog on Kuhn
tetrahedra. ``immersed_square_bspline_problem`` and
``immersed_cube_bspline_problem`` put a P2 foreground on a quadratic
B-spline background lattice (the biharmonic workload).
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


def locate_cells(mesh: Mesh, points: np.ndarray,
                 tol: float = 1e-10) -> np.ndarray:
    """Point location on any simplex mesh: the containing cell id per
    point, -1 if outside. The reference's uniform bucket grid over cell
    bounding boxes, searched per point as one vectorised test: a point on
    a shared facet gets the lowest-numbered cell its bucket lists, as
    there."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    dim = mesh.dim
    lo = mesh.coords.min(0) - tol
    hi = mesh.coords.max(0) + tol
    n_buckets = max(int(round(mesh.n_cells ** (1.0 / dim))), 1)
    width = (hi - lo) / n_buckets

    def bucket_of(x):
        return np.clip(((x - lo) / width).astype(np.int64), 0, n_buckets - 1)

    cc = mesh.cell_coords
    cmin, cmax = bucket_of(cc.min(1)), bucket_of(cc.max(1))
    Jinv = np.linalg.inv(np.swapaxes(cc[:, 1:, :] - cc[:, :1, :], 1, 2))
    out = np.full(len(points), -1, dtype=np.int64)
    for p, (x, b) in enumerate(zip(points, bucket_of(points))):
        cand = np.flatnonzero(np.all((cmin <= b) & (b <= cmax), axis=1))
        lam = np.einsum("cij,cj->ci", Jinv[cand], x - cc[cand, 0, :])
        hit = cand[(lam.min(1) >= -tol) & (lam.sum(1) <= 1 + tol)]
        if len(hit):
            out[p] = hit[0]
    return out


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
    """P1 or P2 interpolation matrix from a structured background triangle
    or tetrahedron grid to points: row i holds the basis values of the
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


def _snap_cut_boundary(mesh_f, angle: float, half_width: float):
    """Snap the staircase material interface onto the exact rotated square.

    The centroid classification of the synthetic generators leaves the
    immersed boundary as a staircase of mesh facets with O(h) re-entrant
    steps. For 2nd-order problems the Nitsche formulation is consistent on
    that polygon and rates are unaffected, but for the biharmonic the
    staircase corners destroy the H4 dual regularity the Aubin-Nitsche
    argument needs, capping the observed L2 rate at the energy rate (~1).
    Here every interface
    vertex is projected onto the nearest point of the exact rotated-square
    boundary, and material-2 cells that collapse (all three vertices on one
    side line, or folded over it) are demoted to material 1 — they are
    zero-area boundary slivers. The resulting interface facets lie ON the
    exact square sides (up to O(h) chamfers at the four convex corners),
    which restores the duality gain (a foreground cut to conform to the
    geometry has it by construction).
    """
    coords = np.array(mesh_f.coords, dtype=np.float64, copy=True)
    cells = np.asarray(mesh_f.cells)
    material = np.array(mesh_f.material, copy=True)
    in2 = material == 2
    c2 = cells[in2]
    # interface edges: edges of material-2 cells not shared by two of them
    e = np.concatenate([c2[:, [0, 1]], c2[:, [1, 2]], c2[:, [2, 0]]])
    e = np.sort(e, axis=1)
    _, inv, counts = np.unique(
        e, axis=0, return_inverse=True, return_counts=True
    )
    bverts = np.unique(e[counts[inv] == 1])

    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    R = np.array([[ca, sa], [-sa, ca]])
    uv = coords[bverts] @ R.T
    # nearest point on the square |u|_inf = half_width: push the larger
    # coordinate to the side, clamp the other into the side segment
    au, av = np.abs(uv[:, 0]), np.abs(uv[:, 1])
    major_u = au >= av
    snapped = uv.copy()
    snapped[major_u, 0] = np.sign(uv[major_u, 0]) * half_width
    snapped[major_u, 1] = np.clip(uv[major_u, 1], -half_width, half_width)
    snapped[~major_u, 1] = np.sign(uv[~major_u, 1]) * half_width
    snapped[~major_u, 0] = np.clip(uv[~major_u, 0], -half_width, half_width)
    coords[bverts] = snapped @ R

    # demote collapsed/folded material-2 slivers (their area is (near) zero:
    # they lie on the boundary line, so removing them leaves the domain
    # unchanged). Threshold: a small fraction of the median cell area.
    p = coords[cells[in2]]
    area2 = 0.5 * (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    )
    tol = 0.02 * np.median(np.abs(area2))
    drop = np.flatnonzero(in2)[area2 <= tol]
    material[drop] = 1
    out = type(mesh_f)(coords, cells, material)
    return out


def immersed_square_problem(n_fg: int, n_bg: int, L: float = 2.0,
                            angle: float = 30.0, half_width: float = 0.6,
                            degree: int = 1, n_fields: int = 1,
                            dtype=np.float64, *,
                            device="cuda"):
    """Rotated square of half-width ``half_width`` immersed in [-L/2, L/2]²:
    foreground cells whose centroid lies inside are the block (material 2),
    the rest material 1. M carries ``n_fields`` fields per node (2 for
    2D elasticity). Returns (mesh_f, M)."""
    mesh_f = _cut_square(n_fg, L, angle, half_width)
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
    mesh_f = _cut_cube(n_fg, L, angle, half_width)
    mesh_b = box_mesh((-L / 2,) * 3, (L / 2,) * 3, n_bg, n_bg, n_bg)
    Vf = FunctionSpace(mesh_f, degree=degree)
    M = transfer_matrix_simplex(mesh_b, np.asarray(Vf.node_coords),
                                degree=degree, n_fields=n_fields,
                                dtype=dtype, device=device)
    return mesh_f, M


def _cut_square(n_fg: int, L: float, angle: float,
                half_width: float) -> Mesh:
    """The structured foreground over [-L/2, L/2]² with the cells whose
    centroid lies in the rotated square as the block (material 2)."""
    mesh_f = rectangle_mesh((-L / 2, -L / 2), (L / 2, L / 2), n_fg, n_fg)
    cent = mesh_f.cell_coords.mean(1)
    a = np.deg2rad(angle)
    ca, sa = np.cos(a), np.sin(a)
    u = ca * cent[:, 0] + sa * cent[:, 1]
    v = -sa * cent[:, 0] + ca * cent[:, 1]
    material = np.where(
        (np.abs(u) <= half_width) & (np.abs(v) <= half_width), 2, 1
    ).astype(np.int32)
    return Mesh(mesh_f.coords, mesh_f.cells, material)


def _cut_cube(n_fg: int, L: float, angle: float, half_width: float) -> Mesh:
    """The structured tetrahedron foreground over [-L/2, L/2]³ with the
    cells whose centroid lies in the cube rotated about z then y as the
    block (material 2)."""
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
    return Mesh(mesh_f.coords, mesh_f.cells, material)


def immersed_square_bspline_problem(n_fg: int, n_bg: int, L: float = 2.0,
                                    angle: float = 30.0,
                                    half_width: float = 0.6,
                                    fg_degree: int = 2, bg_degree: int = 2,
                                    n_fields: int = 1, dtype=np.float64,
                                    snap_boundary: bool = False, *,
                                    device="cuda"):
    """A rotated immersed square in a P2 (``fg_degree``) triangle
    foreground, extracted to a C1 tensor-product B-spline background of
    degree ``bg_degree`` with n_bg spans a side: the lattice the
    biharmonic's radius-3 stencil and multigrid run on.

    Returns (mesh_f, M, lattice_shape), lattice_shape = the control net
    (ncp_x, ncp_y), ncp = n_bg + bg_degree; n_bg = 2^m − bg_degree + 1
    gives a 2^m + 1 net that coarsens all the way. Pick ``n_fg`` a multiple
    of ``n_bg`` (nested grids): then each foreground cell lies in one knot
    span, and the P2 interpolation reproduces the spline exactly.
    ``snap_boundary`` moves the staircase interface onto the exact square
    (``_snap_cut_boundary``)."""
    from iifea_tpu_torch.mesh.bspline import BSplineSpace2D

    mesh_f = _cut_square(n_fg, L, angle, half_width)
    if snap_boundary:
        mesh_f = _snap_cut_boundary(mesh_f, angle, half_width)
    space = BSplineSpace2D(bg_degree, (n_bg, n_bg), (-L / 2, -L / 2),
                           (L / 2, L / 2))
    Vf = FunctionSpace(mesh_f, degree=fg_degree)
    M = space.transfer_matrix(np.asarray(Vf.node_coords), n_fields=n_fields,
                              dtype=dtype, device=device)
    return mesh_f, M, space.ncp


def immersed_cube_bspline_problem(n_fg: int, n_bg: int, L: float = 2.0,
                                  angle: float = 30.0,
                                  half_width: float = 0.6,
                                  fg_degree: int = 2, bg_degree: int = 2,
                                  n_fields: int = 1, dtype=np.float64, *,
                                  device="cuda"):
    """3D analog of ``immersed_square_bspline_problem``: a rotated cube in a
    P2 tetrahedron foreground on a quadratic B-spline box background.
    Returns (mesh_f, M, lattice_shape = ncp)."""
    from iifea_tpu_torch.mesh.bspline import BSplineSpace3D

    mesh_f = _cut_cube(n_fg, L, angle, half_width)
    space = BSplineSpace3D(bg_degree, (n_bg,) * 3, (-L / 2,) * 3,
                           (L / 2,) * 3)
    Vf = FunctionSpace(mesh_f, degree=fg_degree)
    M = space.transfer_matrix(np.asarray(Vf.node_coords), n_fields=n_fields,
                              dtype=dtype, device=device)
    return mesh_f, M, space.ncp
