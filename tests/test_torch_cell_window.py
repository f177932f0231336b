"""Port 3D host modules, assembly and cell-window projection vs the JAX
package, from identical state (numpy arrays through
iifea_tpu_torch.convert) on a small immersed cube (n_bg=6, n_fg=10)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import box_mesh as j_box_mesh
from iifea_tpu.mesh.generators import immersed_cube_problem as j_problem
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops import cell_window as jcw
from iifea_tpu.ops.projection import BackgroundOperator as JBackground
from iifea_tpu.ops.projection import assemble_background_system
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.generators import box_mesh, immersed_cube_problem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import cell_window as tcw
from iifea_tpu_torch.ops.lattice_bin import LatticeBinError
from iifea_tpu_torch.ops.projection import BackgroundOperator

N_BG, N_FG = 6, 10
SHAPE = (N_BG + 1,) * 3


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
    blocks_j = prob_j.form.jacobian_blocks(jnp.zeros(prob_j.space.n_dofs))
    return mesh_j, M_j, prob_j, st, prob_t, blocks_j


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def test_torch_box_mesh_facet_data_matches():
    """Tet facets in first-appearance order, slot by slot, on a small
    box_mesh (the JAX package's native facet build gives this order)."""
    mj = j_box_mesh((0, 0, 0), (1, 2, 1), 4, 3, 5)
    mt = box_mesh((0, 0, 0), (1, 2, 1), 4, 3, 5)
    assert np.array_equal(mt.coords, mj.coords)
    assert np.array_equal(mt.cells, mj.cells)
    fj, ft = mj.facet_data, mt.facet_data
    assert np.array_equal(ft.facets, fj.facets)
    assert np.array_equal(ft.facet_cells, fj.facet_cells)
    assert np.array_equal(ft.facet_local, fj.facet_local)


def test_torch_facet_row_order_lexsort_fallback():
    """Rows whose packed key would overflow uint64 take the lexsort path,
    which gives the same stable order as the packed key."""
    from iifea_tpu_torch.mesh.core import _stable_row_order

    rng = np.random.default_rng(3)
    tup = np.sort(rng.integers(0, 40, (500, 3)), axis=1).astype(np.int32)
    assert np.array_equal(_stable_row_order(tup, 2 ** 22),
                          _stable_row_order(tup, 40))
    assert np.array_equal(_stable_row_order(tup, 40),
                          np.lexsort(tup.T[::-1]))


def test_torch_cube_generator_matches(both):
    mesh_j, M_j, *_ = both
    mesh, M = immersed_cube_problem(n_fg=N_FG, n_bg=N_BG, device="cpu")
    assert np.array_equal(mesh.coords, mesh_j.coords)
    assert np.array_equal(mesh.cells, mesh_j.cells)
    assert np.array_equal(mesh.material, mesh_j.material)
    assert np.array_equal(M.idx_np, M_j.idx_np)
    assert np.array_equal(M.val_np, M_j.val_np)
    assert M.n_bg_dofs == M_j.n_bg_dofs == int(np.prod(SHAPE))
    assert np.array_equal(mesh.classify_facets_by_material(),
                          mesh_j.classify_facets_by_material())


def test_torch_domains3_match(both):
    _, _, prob_j, _, prob_t, _ = both
    cj, ct = prob_j.cell_dom, prob_t.cell_dom
    for name in ("eldofsT", "JinvT", "wdetT", "xqT", "h"):
        assert np.array_equal(getattr(ct, name).numpy(),
                              np.asarray(getattr(cj, name))), name
    fj, ft = prob_j.facet_dom, prob_t.facet_dom
    assert ft.n_elem > 0
    for name in ("eldofsT", "phiT", "gphiT", "wT", "xqT", "h", "normalT"):
        assert np.array_equal(getattr(ft, name).numpy(),
                              np.asarray(getattr(fj, name))), name


def test_torch_jacobian_and_residual3(both):
    _, _, prob_j, _, prob_t, blocks_j = both
    _, r_j = prob_j.form.jacobian_and_residual(jnp.zeros(prob_j.space.n_dofs))
    u0 = torch.zeros(prob_t.space.n_dofs, dtype=torch.float64)
    blocks_t, r_t = prob_t.form.jacobian_and_residual(u0)
    for Kt, Kj in zip(blocks_t, blocks_j):
        assert Kt.shape == Kj.shape and _rel(Kt, Kj) < 1e-13
    assert _rel(r_t, r_j) < 1e-13
    assert _rel(prob_t.form.residual(u0), r_j) < 1e-13


def test_torch_background_operator_and_rhs(both):
    """The exact f64 operator Mᵀ A_f M x and b = −Mᵀ r at 1e-13."""
    _, M_j, prob_j, st, prob_t, blocks_j = both
    u0 = torch.zeros(prob_t.space.n_dofs, dtype=torch.float64)
    blocks_t, r_t = prob_t.form.jacobian_and_residual(u0)
    x = np.random.default_rng(1).standard_normal(M_j.n_bg_dofs)
    y_j = JBackground(prob_j.form, blocks_j, M_j).mv(jnp.asarray(x))
    y_t = BackgroundOperator(prob_t.form, blocks_t, st.M).mv(
        torch.from_numpy(x))
    assert _rel(y_t, y_j) < 1e-13
    _, b_j = assemble_background_system(
        prob_j.form, jnp.zeros(prob_j.space.n_dofs), M_j)
    assert _rel(-st.M.rmv(r_t), b_j) < 1e-13


@pytest.fixture(scope="module")
def jax_planes(both):
    """The JAX package's planes: f64 from its window congruence
    (``stencil_coeffs_windows`` on bound blocks; the JAX tests pin it and
    the fused f64 ``stencil_planes_windows``, which runs op by op and is
    far slower on CPU, to the same general probe at 1e-12), f32 from the
    fused ``stencil_planes_windows`` on f32 tables and blocks (the
    reference's solver path)."""
    _, M_j, prob_j, _, _, blocks_j = both
    red_j = jcw.build_window_projection(prob_j.form, M_j, SHAPE,
                                        dtype=np.float64)
    bound = [r.bind_blocks(K) for r, K in zip(red_j, blocks_j)]
    C_j = np.asarray(jax.jit(jcw.stencil_coeffs_windows)(red_j, bound))
    red_j32 = jcw.build_window_projection(prob_j.form, M_j, SHAPE,
                                          dtype=np.float32)
    C_j32 = np.asarray(jcw.stencil_planes_windows(
        red_j32, [K.astype(jnp.float32) for K in blocks_j],
        dtype=jnp.float32))
    return [r.meta for r in red_j], C_j, C_j32


@pytest.mark.parametrize("slab_bytes", [4e9, 2e5])
def test_torch_window_planes_match(both, jax_planes, slab_bytes):
    """Window planes vs the JAX package: f64 at 1e-12·max, and the f32
    cast vs the JAX f32 planes at 1e-5·max. The small slab budget forces
    one bbox x-row per slab."""
    *_, st, prob_t, blocks_j = both
    metas_j, C_j, C_j32 = jax_planes
    red_t = tcw.build_window_projection(prob_t.form, st.M, SHAPE,
                                        device="cpu")
    assert [r.meta for r in red_t] == metas_j
    blocks_t = [torch.tensor(np.asarray(K)) for K in blocks_j]
    C_t = tcw.stencil_planes_windows(red_t, blocks_t, slab_bytes=slab_bytes)
    assert C_t.shape == (125, *SHAPE) and C_t.dtype == torch.float64
    scale = np.abs(C_j).max()
    assert np.abs(C_t.numpy() - C_j).max() < 1e-12 * scale
    C_t32 = C_t.to(torch.float32).numpy()
    assert np.abs(C_t32 - C_j32).max() < 1e-5 * scale


def test_torch_window_tables(both):
    """Table bytes are reported per table; padding slots have perm 0 and
    weight 0."""
    *_, st, prob_t, _ = both
    red = tcw.build_window_projection(prob_t.form, st.M, SHAPE,
                                      device="cpu")
    for r, (dom, _) in zip(red, prob_t.form.terms):
        ne, km, L, nc = r.meta
        assert r.nbytes() == {"val_b": nc * L * ne * km * 8,
                              "kappa": nc * L * ne * km, "perm": nc * L * 8}
        assert int((r.perm > 0).sum()) == dom.n_elem
        assert bool((r.val_b[r.perm == 0] == 0).all())
        assert int(r.kappa.max()) < 27


def test_torch_error_norms3(both):
    _, _, prob_j, _, prob_t, _ = both
    u = np.random.default_rng(2).standard_normal(prob_j.space.n_dofs) * 0.1
    nj = prob_j.error_norms(jnp.asarray(u))
    nt = prob_t.error_norms(torch.from_numpy(u))
    for k in ("L2", "H10", "H1"):
        assert abs(nt[k] - nj[k]) <= 1e-13 * abs(nj[k]), k


def test_torch_window_spill_raises():
    """Foreground elements wider than the background spacing leave the
    {0..2}³ window (the JAX test_window_spill_raises case)."""
    mesh, M = immersed_cube_problem(n_fg=2, n_bg=9, device="cpu")
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device="cpu")
    with pytest.raises(LatticeBinError):
        tcw.build_window_projection(prob.form, M, (10, 10, 10), device="cpu")
