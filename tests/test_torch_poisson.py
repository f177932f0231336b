"""Port mesh, assembly core and Poisson model vs the JAX package, from
identical state (numpy arrays through iifea_tpu_torch.convert) at n_bg=16."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_square_problem as j_problem
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.models.poisson import source_fn, u_exact_fn
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.generators import immersed_square_problem
from iifea_tpu_torch.models.poisson import (
    PoissonProblem,
    eval_points,
    p1_stiffness_arrays,
    source,
    u_exact,
)

N_BG, N_FG = 16, 23


@pytest.fixture(scope="module")
def both():
    mesh_j, M_j = j_problem(n_fg=N_FG, n_bg=N_BG, degree=1, dtype=np.float64)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10, dtype=np.float64)
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu",
    )
    prob_t = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                            device="cpu")
    return mesh_j, M_j, prob_j, st, prob_t


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def test_torch_generator_matches(both):
    mesh_j, M_j, *_ = both
    mesh, M = immersed_square_problem(n_fg=N_FG, n_bg=N_BG, device="cpu")
    assert np.array_equal(mesh.coords, mesh_j.coords)
    assert np.array_equal(mesh.cells, mesh_j.cells)
    assert np.array_equal(mesh.material, mesh_j.material)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    assert M.n_bg_dofs == M_j.n_bg_dofs


def test_torch_facet_data_matches(both):
    mesh_j, _, _, st, _ = both
    fj, ft = mesh_j.facet_data, st.mesh.facet_data
    assert np.array_equal(ft.facets, fj.facets)
    assert np.array_equal(ft.facet_cells, fj.facet_cells)
    assert np.array_equal(ft.facet_local, fj.facet_local)
    assert np.array_equal(st.mesh.classify_facets_by_material(),
                          mesh_j.classify_facets_by_material())


def test_torch_extraction_mv_rmv(both):
    _, M_j, _, st, _ = both
    rng = np.random.default_rng(0)
    ub = rng.standard_normal(M_j.n_bg_dofs)
    rf = rng.standard_normal(M_j.n_fg_dofs)
    assert _rel(st.M.mv(torch.from_numpy(ub)), M_j.mv(jnp.asarray(ub))) < 1e-14
    assert _rel(st.M.rmv(torch.from_numpy(rf)),
                M_j.rmv(jnp.asarray(rf))) < 1e-14


def test_torch_domains_match(both):
    _, _, prob_j, _, prob_t = both
    cj, ct = prob_j.cell_dom, prob_t.cell_dom
    for name in ("eldofsT", "JinvT", "wdetT", "xqT", "h"):
        assert np.array_equal(getattr(ct, name).numpy(),
                              np.asarray(getattr(cj, name))), name
    fj, ft = prob_j.facet_dom, prob_t.facet_dom
    for name in ("eldofsT", "phiT", "gphiT", "wT", "xqT", "h", "normalT"):
        assert np.array_equal(getattr(ft, name).numpy(),
                              np.asarray(getattr(fj, name))), name


def test_torch_facet_jacobian_blocks(both):
    _, _, prob_j, _, prob_t = both
    Kj = prob_j.form.jacobian_blocks(jnp.zeros(prob_j.space.n_dofs))
    Kt = prob_t.form.jacobian_blocks(
        torch.zeros(prob_t.space.n_dofs, dtype=torch.float64))
    assert Kt[1].shape == Kj[1].shape
    assert _rel(Kt[1], Kj[1]) < 1e-13
    assert _rel(Kt[0], Kj[0]) < 1e-13       # cell term by autodiff too


def test_torch_p1_stiffness_matches_df(both):
    """Native f64 P1 stiffness vs the JAX double-float stiffness (hi+lo)."""
    _, _, prob_j, _, prob_t = both
    Kh, Kl = jax.jit(prob_j.cell_stiffness_df)()
    Kj = np.asarray(Kh, np.float64) + np.asarray(Kl, np.float64)
    cd = prob_t.cell_dom
    Kt = p1_stiffness_arrays(cd.JinvT, cd.wdetT, cd.gphi_ref.numpy())
    assert _rel(Kt, Kj) < 1e-13


def test_torch_source_term():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (2, 64))
    fj = jax.vmap(source_fn(u_exact_fn(2)), in_axes=1)(jnp.asarray(X))
    gj = jax.vmap(u_exact_fn(2), in_axes=1)(jnp.asarray(X))
    xqT = torch.from_numpy(X)[None]                     # (1, 2, 64)
    assert _rel(eval_points(source, xqT)[0], fj) < 1e-13
    assert _rel(eval_points(u_exact, xqT)[0], gj) < 1e-14


def test_torch_error_norms(both):
    _, _, prob_j, _, prob_t = both
    rng = np.random.default_rng(2)
    u = rng.standard_normal(prob_j.space.n_dofs) * 0.1
    nj = prob_j.error_norms(jnp.asarray(u))
    nt = prob_t.error_norms(torch.from_numpy(u))
    for k in ("L2", "H10", "H1"):
        assert abs(nt[k] - nj[k]) <= 1e-13 * abs(nj[k]), k


def test_torch_port_raises_on_missing_cuda(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, st, _ = both
    with pytest.raises((RuntimeError, AssertionError)):
        PoissonProblem(st.mesh, device="cuda")
