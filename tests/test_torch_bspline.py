"""The port's B-spline background spaces (mesh/bspline.py) and the B-spline
immersed problems of mesh/generators.py vs the JAX package (the spec is
tests/test_bspline.py and the cube case of tests/test_models.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh import bspline as j_bspline
from iifea_tpu.mesh.generators import (
    immersed_cube_bspline_problem as j_cube,
    immersed_square_bspline_problem as j_square,
)
from iifea_tpu_torch.mesh import bspline
from iifea_tpu_torch.mesh.generators import (
    immersed_cube_bspline_problem,
    immersed_square_bspline_problem,
)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_torch_bspline_basis(p):
    """Knots, spans and Cox-de Boor values equal JAX's; partition of unity
    and nonnegativity; quadratic splines reproduce x from Greville
    coefficients."""
    knots = bspline.uniform_open_knots(p, 7, -1.0, 2.0)
    assert np.array_equal(knots, j_bspline.uniform_open_knots(p, 7, -1.0,
                                                               2.0))
    x = np.random.default_rng(p).uniform(-1, 2, 113)
    spans, vals = bspline.basis_values(knots, p, x)
    spans_j, vals_j = j_bspline.basis_values(knots, p, x)
    assert np.array_equal(spans, spans_j) and np.array_equal(vals, vals_j)
    assert np.allclose(vals.sum(1), 1.0) and (vals >= -1e-14).all()
    n = len(knots) - p - 1
    grev = np.array([knots[i + 1:i + p + 1].mean() for i in range(n)])
    recon = sum(vals[:, j] * grev[spans - p + j] for j in range(p + 1))
    assert np.allclose(recon, x, atol=1e-13)


def test_torch_bspline_2d_extraction():
    """Partition of unity, bilinear reproduction from Greville points and
    zero rows outside, the same M as JAX's (entries equal)."""
    sp = bspline.BSplineSpace2D(2, (4, 5), (-2.0, -2.0), (2.0, 2.0))
    sp_j = j_bspline.BSplineSpace2D(2, (4, 5), (-2.0, -2.0), (2.0, 2.0))
    pts = np.random.default_rng(0).uniform(-2, 2, (200, 2))
    pts = np.vstack([pts, [[3.0, 0.5], [-2.5, -2.5]]])
    M, M_j = sp.transfer_matrix(pts, device="cpu"), sp_j.transfer_matrix(pts)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    ones = M.mv(torch.ones(sp.n_dofs, dtype=torch.float64)).numpy()
    assert np.allclose(ones[:-2], 1.0) and (ones[-2:] == 0.0).all()
    grev = sp.greville_points()
    assert np.array_equal(grev, sp_j.greville_points())
    for d in range(2):
        vals = M.mv(torch.from_numpy(grev[:, d])).numpy()
        assert np.allclose(vals[:-2], pts[:-2, d], atol=1e-12)
    xy = M.mv(torch.from_numpy(grev[:, 0] * grev[:, 1])).numpy()[:-2]
    assert np.allclose(xy, pts[:-2, 0] * pts[:-2, 1], atol=1e-12)


def test_torch_bspline_3d_extraction():
    """The 3D space: partition of unity, trilinear reproduction, JAX's M."""
    sp = bspline.BSplineSpace3D(2, (3, 4, 3), (0.0,) * 3, (1.0,) * 3)
    sp_j = j_bspline.BSplineSpace3D(2, (3, 4, 3), (0.0,) * 3, (1.0,) * 3)
    pts = np.random.default_rng(2).uniform(0, 1, (150, 3))
    M, M_j = sp.transfer_matrix(pts, device="cpu"), sp_j.transfer_matrix(pts)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    assert np.allclose(M.mv(torch.ones(sp.n_dofs,
                                       dtype=torch.float64)).numpy(), 1.0)
    g = [np.array([k[i + 1:i + 3].mean() for i in range(n)])
         for k, n in zip(sp.knots, sp.ncp)]
    G = np.stack(np.meshgrid(*g, indexing="ij"), axis=-1).reshape(-1, 3)
    c = torch.from_numpy(G[:, 0] * G[:, 1] * G[:, 2])
    assert np.allclose(M.mv(c).numpy(), pts.prod(axis=1), atol=1e-12)


@pytest.mark.parametrize("snap", [False, True])
def test_torch_bspline_square_problem(snap):
    """immersed_square_bspline_problem(n_fg=32, n_bg=15): the same mesh,
    materials and M triples as JAX's, with and without the snapped
    boundary."""
    mesh_j, M_j, ncp_j = j_square(n_fg=32, n_bg=15, snap_boundary=snap)
    mesh, M, ncp = immersed_square_bspline_problem(
        n_fg=32, n_bg=15, snap_boundary=snap, device="cpu")
    assert tuple(ncp) == tuple(ncp_j) == (17, 17)
    assert np.array_equal(mesh.coords, mesh_j.coords)
    assert np.array_equal(mesh.cells, mesh_j.cells)
    assert np.array_equal(mesh.material, mesh_j.material)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    assert M.n_bg_dofs == M_j.n_bg_dofs == 17 * 17


def test_torch_bspline_cube_problem():
    """immersed_cube_bspline_problem's host part: JAX's mesh, materials and
    M; rows sum to 1 inside the box (test_models.py's criterion)."""
    mesh_j, M_j, ncp_j = j_cube(n_fg=8, n_bg=3)
    mesh, M, ncp = immersed_cube_bspline_problem(n_fg=8, n_bg=3,
                                                 device="cpu")
    assert tuple(ncp) == tuple(ncp_j) == (5, 5, 5)
    assert np.array_equal(mesh.material, mesh_j.material)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    ones = M.mv(torch.ones(M.n_bg_dofs, dtype=torch.float64)).numpy()
    assert np.allclose(ones, np.asarray(M_j.mv(jnp.ones(M_j.n_bg_dofs))),
                       atol=1e-12)
    assert np.allclose(ones, 1.0, atol=1e-12)
