"""The port's P2 spaces vs the JAX package: reference elements, quadrature,
the P2 node numbering (the reference native library's first-appearance
edge order, reproduced in numpy), the small-cell filter, Hessian
tabulation in the assembly domains, and P2 Poisson and elasticity (the
specs are tests/test_elements.py, tests/test_quadrature.py,
tests/test_native.py and the k=2 case of tests/test_models.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh import core as j_core
from iifea_tpu.mesh import generators as j_gen
from iifea_tpu.models.elasticity import (
    ImmersedElasticityProblem as JElasticity,
)
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops import assembly as j_assembly
from iifea_tpu.ops import quadrature as j_quad
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.reference_elements import ReferenceElement as JElement
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.mesh import core, generators
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import assembly, quadrature
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.reference_elements import ReferenceElement
from iifea_tpu_torch.solvers.ksp import solve_ksp


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("deg", [1, 2])
def test_torch_p2_reference_element(dim, deg):
    """Values, gradients and Hessians equal JAX's (1e-12); nodal property,
    partition of unity, and the Hessians of P2 match finite differences of
    the gradients."""
    el, el_j = ReferenceElement(dim, deg), JElement(dim, deg)
    assert np.array_equal(el.node_coords, el_j.node_coords)
    assert np.array_equal(el.edges, el_j.edges)
    pts = np.random.default_rng(dim + deg).random((7, dim)) * 0.3
    for fn in ("tabulate", "tabulate_grad", "tabulate_hess"):
        a, b = getattr(el, fn)(pts), getattr(el_j, fn)(pts)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-12
    assert np.allclose(el.tabulate(el.node_coords), np.eye(el.n_nodes),
                       atol=1e-13)
    assert np.allclose(el.tabulate(pts).sum(1), 1.0)
    eps = 1e-5
    for d in range(dim):
        dp, dm = pts.copy(), pts.copy()
        dp[:, d] += eps
        dm[:, d] -= eps
        fd = (el.tabulate_grad(dp) - el.tabulate_grad(dm)) / (2 * eps)
        assert np.allclose(el.tabulate_hess(pts)[:, :, :, d], fd, atol=1e-7)
    for lf in range(dim + 1):
        fp = np.full((3, dim - 1), 0.25)
        assert np.array_equal(el.facet_to_cell_points(lf, fp),
                              el_j.facet_to_cell_points(lf, fp))


def test_torch_p2_quadrature():
    """Every rule equals JAX's and integrates its degree exactly."""
    from math import factorial

    for deg in range(1, 9):
        for a, b in ((quadrature.triangle_rule(deg),
                      j_quad.triangle_rule(deg)),
                     (quadrature.interval_rule(deg),
                      j_quad.interval_rule(deg))):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        pts, wts = quadrature.triangle_rule(deg)
        for i in range(deg + 1):
            for j in range(deg + 1 - i):
                exact = factorial(i) * factorial(j) / factorial(i + j + 2)
                assert abs((wts * pts[:, 0] ** i * pts[:, 1] ** j).sum()
                           - exact) < 1e-12
    for deg in range(1, 7):
        assert all(np.array_equal(x, y) for x, y in zip(
            quadrature.tet_rule(deg), j_quad.tet_rule(deg)))
        for dim in (2, 3):
            assert all(np.array_equal(x, y) for x, y in zip(
                quadrature.facet_rule(dim, deg), j_quad.facet_rule(dim, deg)))


def _shuffled(dim, seed):
    """A structured mesh with its cells and their vertex order shuffled, so
    the first-appearance order differs from any sorted order."""
    mesh = (generators.rectangle_mesh((0, 0), (1, 1), 5, 4) if dim == 2
            else generators.box_mesh((0, 0, 0), (1, 1, 1), 3, 2, 3))
    rng = np.random.default_rng(seed)
    cells = mesh.cells[rng.permutation(mesh.n_cells)]
    cells = np.take_along_axis(
        cells, np.argsort(rng.random(cells.shape), axis=1), axis=1)
    return mesh.coords, cells


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_p2_numbering(dim):
    """P2 cell dofs equal the JAX package's (its native library numbers the
    edges in first-appearance order) exactly, node coordinates too, on a
    structured mesh and on a shuffled one."""
    coords, cells = _shuffled(dim, 0)
    m = (generators.rectangle_mesh((0, 0), (1, 1), 5, 4) if dim == 2
         else generators.box_mesh((0, 0, 0), (1, 1, 1), 3, 2, 3))
    for c in (m.cells, cells):
        V = core.FunctionSpace(core.Mesh(coords, c), degree=2)
        V_j = j_core.FunctionSpace(j_core.Mesh(coords, c), degree=2)
        assert np.array_equal(V.cell_dofs, V_j.cell_dofs)
        assert V.n_nodes == V_j.n_nodes and V.n_dofs == V_j.n_dofs
        assert np.array_equal(V.node_coords, V_j.node_coords)
        ne = V.n_nodes - coords.shape[0]
        assert ne == (np.unique(np.sort(c[:, V.element.edges].reshape(-1, 2),
                                        axis=1), axis=0).shape[0])


@pytest.mark.parametrize("tol", [1e-5, 0.1])
def test_torch_p2_filter_small_cells(tol):
    """filter_small_cells on the snapped cut square (it leaves sliver block
    cells): the same materials, facet classes and counts as JAX's."""
    mesh_j, _, _ = j_gen.immersed_square_bspline_problem(
        n_fg=24, n_bg=7, snap_boundary=True)
    mesh = core.Mesh(mesh_j.coords, mesh_j.cells, mesh_j.material)
    fc = mesh.classify_facets_by_material()
    fc_j = mesh_j.classify_facets_by_material()
    out = mesh.filter_small_cells(tol, 2, fc, 3)
    out_j = mesh_j.filter_small_cells(tol, 2, fc_j, 3)
    assert np.array_equal(out[0], out_j[0])
    assert np.array_equal(out[1], out_j[1])
    assert out[2:] == out_j[2:]
    if tol > 1e-3:
        assert out[2] > 0 and out[3] > 0


@pytest.mark.parametrize("with_hessian", [True, "lap"])
def test_torch_p2_hessian_domains(with_hessian):
    """Cell and facet domains built with Hessians: ctx.hess (physical) or
    ctx.lap (their traces) equal JAX's; lap_phi of an element is the trace
    of its full Hessian."""
    mesh_j, _ = j_gen.immersed_square_problem(n_fg=8, n_bg=4, degree=2)
    mesh = core.Mesh(mesh_j.coords, mesh_j.cells, mesh_j.material)
    V, V_j = core.FunctionSpace(mesh, 2), j_core.FunctionSpace(mesh_j, 2)
    cells = np.flatnonzero(mesh.material == 2)
    facets = np.flatnonzero(mesh.classify_facets_by_material() == 3)
    doms = [(assembly.build_cell_domain(V, cells, 2, device="cpu",
                                        with_hessian=with_hessian),
             j_assembly.build_cell_domain(V_j, cells, 2,
                                          with_hessian=with_hessian)),
            (assembly.build_facet_domain(V, facets, 2, device="cpu",
                                         with_hessian=with_hessian),
             j_assembly.build_facet_domain(V_j, facets, 2,
                                           with_hessian=with_hessian))]
    for dom, dom_j in doms:
        ctx, ctx_j = dom.ctx(), dom_j.ctx()
        field = "lap" if with_hessian == "lap" else "hess"
        assert getattr(ctx, "hess" if field == "lap" else "lap") is None
        assert _rel(getattr(ctx, field), getattr(ctx_j, field)) < 1e-12
        if field == "hess":
            # lap_phi of one element: the trace of its physical Hessian
            one = type(ctx)(*(None if v is None else v[..., 0] for v in ctx))
            assert _rel(assembly.lap_phi(one),
                        np.einsum("qbdd->qb", np.asarray(ctx_j.hess)[..., 0])
                        ) < 1e-12


def _p2_poisson(n_fg, n_bg):
    mesh_j, M_j = j_gen.immersed_square_problem(n_fg=n_fg, n_bg=n_bg,
                                                degree=2)
    prob_j = JPoisson(mesh_j, k=2, sym=True, beta_value=10)
    A_j, b_j = jax.jit(lambda u: j_assemble(prob_j.form, u, M_j))(
        jnp.zeros(prob_j.space.n_dofs))
    # the host arrays of M do not travel through jit
    A_j = JBackgroundOperator(prob_j.form, A_j.blocks, M_j)
    mesh, M = generators.immersed_square_problem(n_fg=n_fg, n_bg=n_bg,
                                                 degree=2, device="cpu")
    prob = PoissonProblem(mesh, k=2, sym=True, beta_value=10, device="cpu")
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    return prob_j, M_j, A_j, b_j, prob, M, A, b


def test_torch_p2_poisson():
    """P2 Poisson (k=2 on a P2 background): the same M, the same assembled
    system, and host-LU error norms equal to JAX's (1e-10)."""
    prob_j, M_j, A_j, b_j, prob, M, A, b = _p2_poisson(16, 8)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    assert _rel(b, b_j) < 1e-12
    x = np.random.default_rng(3).standard_normal(M.n_bg_dofs)
    assert _rel(A.mv(torch.from_numpy(x)),
                jax.jit(A_j.mv)(jnp.asarray(x))) < 1e-12
    u, _ = solve_ksp(A, b, method="direct")
    u_j, _ = j_solve_ksp(A_j, b_j, method="direct", monitor=False)
    n = prob.error_norms(M.mv(u))
    n_j = prob_j.error_norms(M_j.mv(jnp.asarray(u_j)))
    for k in ("L2", "H10"):
        assert abs(n[k] - n_j[k]) <= 1e-10 * n_j[k]
    assert 0 < n["L2"] < 0.05


def test_torch_p2_elasticity():
    """ImmersedElasticityProblem(k=2): Jacobian blocks and residual at a
    random state equal JAX's (1e-12)."""
    mesh_j, _ = j_gen.immersed_square_problem(n_fg=8, n_bg=4, degree=2,
                                              n_fields=2)
    prob_j = JElasticity(mesh_j, k=2)
    mesh = core.Mesh(mesh_j.coords, mesh_j.cells, mesh_j.material)
    prob = ImmersedElasticityProblem(mesh, k=2, device="cpu")
    assert prob.space.n_dofs == prob_j.space.n_dofs
    u = np.random.default_rng(4).standard_normal(prob.space.n_dofs)
    blocks_j, res_j = jax.jit(prob_j.form.jacobian_and_residual)(
        jnp.asarray(u))
    blocks, res = prob.form.jacobian_and_residual(torch.from_numpy(u))
    for K, K_j in zip(blocks, blocks_j):
        assert _rel(K, K_j) < 1e-12
    assert _rel(res, res_j) < 1e-12


@pytest.mark.parametrize("name", ["poisson", "linear_elasticity"])
def test_torch_p2_demos(name):
    """``--k 2`` in the Poisson and elasticity demos (P2 foreground and
    background; the elasticity demo's default preconditioner is then
    point-block Jacobi): the solve converges and the printed norms are the
    problem's."""
    import contextlib
    import importlib
    import io

    demo = importlib.import_module(f"iifea_tpu_torch.demos.{name}")
    argv = ["--k", "2", "--ref", "0", "--device", "cpu"]
    if name == "linear_elasticity":
        argv += ["--mesh-root", "synthetic"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = demo.main(argv)
    assert res["info"].converged
    assert 0 < res["norms"]["L2"] < 0.1
    assert f"{res['norms']['L2']}" in out.getvalue()
