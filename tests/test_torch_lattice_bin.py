"""Port lattice-binned reducers vs the JAX package (ops/lattice_bin.py):
tables, direct stencil planes, rhs projection and the f64 operator apply,
from identical state at (n_bg, n_fg) ∈ {(12, 17), (16, 23)}. The JAX
reducers run op by op (no jit): compiling their unrolled double-float graphs
costs far more than running them at these sizes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_square_problem as j_problem
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops import df as jdf
from iifea_tpu.ops import lattice_bin as jlb
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import lattice_bin as tlb
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

SIZES = [(12, 17), (16, 23)]
_CACHE = {}


def _both(n_bg, n_fg):
    if (n_bg, n_fg) not in _CACHE:
        mesh_j, M_j = j_problem(n_fg=n_fg, n_bg=n_bg, degree=1,
                                dtype=np.float64)
        prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10,
                          dtype=np.float64)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=M_j.idx_np, val=M_j.val_np,
            n_bg_dofs=M_j.n_bg_dofs, device="cpu",
        )
        prob_t = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                                device="cpu")
        shape = (n_bg + 1, n_bg + 1)
        blocks_j = prob_j.form.jacobian_blocks(jnp.zeros(prob_j.space.n_dofs))
        _CACHE[(n_bg, n_fg)] = (M_j, prob_j, st.M, prob_t, shape, blocks_j)
    return _CACHE[(n_bg, n_fg)]


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n_bg,n_fg", SIZES)
def test_torch_binned_tables_match(n_bg, n_fg):
    M_j, prob_j, M_t, prob_t, shape, _ = _both(n_bg, n_fg)
    red_j = jlb.build_binned_projection(prob_j.form, M_j, shape,
                                        dtype=np.float64)
    red_t = tlb.build_binned_projection(prob_t.form, M_t, shape,
                                        device="cpu")
    for rj, rt in zip(red_j, red_t):
        assert rt.meta == rj.meta and rt.bbox == rj.bbox
        val = rt.val_b.numpy()
        assert np.array_equal(val, np.asarray(rj.val_b))
        live = val != 0
        assert np.array_equal(rt.kappa.numpy()[live],
                              np.asarray(rj.kappa).astype(np.int64)[live])
        assert np.all(rt.kappa.numpy()[~live] == 0)
        assert np.array_equal(rt.perm.numpy(), np.asarray(rj.perm))
        assert (rt.cells is None) == (rj.cells is None)
        if rj.cells is not None:
            assert np.array_equal(rt.cells.numpy(), np.asarray(rj.cells))
            assert np.array_equal(rt.rows9.numpy(), np.asarray(rj.rows9))
    if n_bg >= 16:          # both placements (compact facets, dense cells)
        assert red_t[1].cells is not None and red_t[0].cells is None


@pytest.mark.parametrize("n_bg,n_fg", SIZES)
def test_torch_stencil_planes_match(n_bg, n_fg):
    """f64 direct planes (autodiff blocks and the solver's P1 stiffness
    path) vs the JAX f64 planes at 1e-12; the f32 cast vs the JAX df-hi
    f32 planes at 1e-5."""
    M_j, prob_j, M_t, prob_t, shape, blocks_j = _both(n_bg, n_fg)
    red_j = jlb.build_binned_projection(prob_j.form, M_j, shape,
                                        dtype=np.float64)
    C_j = np.asarray(jlb.stencil_planes_binned(red_j, blocks_j))
    red_t = tlb.build_binned_projection(prob_t.form, M_t, shape,
                                        device="cpu")
    blocks_t = prob_t.form.jacobian_blocks(
        torch.zeros(prob_t.space.n_dofs, dtype=torch.float64))
    assert _rel(tlb.stencil_planes_binned(red_t, blocks_t), C_j) < 1e-12

    solver = BinnedLatticeSolver(prob_t, M_t, shape, device="cpu")
    _, Kc, Kf = solver.assemble()
    bound = solver.bind(Kc, Kf)
    C_t = tlb.stencil_planes_binned_bound(solver.reducers, bound)
    assert _rel(C_t, C_j) < 1e-12
    # tiny slab budget: the row-slab loop gives the same planes
    C_slab = solver.reducers[0].stencil_planes_bound(bound[0], slab_bytes=1)
    C_one = solver.reducers[0].stencil_planes_bound(bound[0])
    assert _rel(C_slab, C_one) < 1e-14

    red_df = jlb.build_binned_projection(prob_j.form, M_j, shape,
                                         dtype=np.float32, df=True)
    bound_df = jlb.bind_blocks_df_binned(red_df,
                                         jlb.split_blocks_df(blocks_j))
    C32_j = np.asarray(jlb.stencil_planes_binned_bound(red_df, bound_df))
    S32 = solver.probe(bound)
    assert S32.dtype == torch.float32
    assert _rel(S32.coeffs, C32_j) < 1e-5


@pytest.mark.parametrize("n_bg,n_fg", SIZES)
def test_torch_rhs_matches_df(n_bg, n_fg):
    """f64 rhs (bound tables + binned Mᵀ) vs the JAX double-float rhs."""
    M_j, prob_j, M_t, prob_t, shape, _ = _both(n_bg, n_fg)
    red_df = jlb.build_binned_projection(prob_j.form, M_j, shape,
                                         dtype=np.float32, df=True)
    r_el = prob_j.rhs_el_df(prob_j.rhs_df_tables(red_df))
    b_j = np.asarray(jdf.df_to_f64(jlb.project_rhs_df_binned(red_df, r_el)))
    red_t = tlb.build_binned_projection(prob_t.form, M_t, shape,
                                        device="cpu")
    b_t = tlb.project_rhs_binned(red_t, prob_t.rhs_el(
        prob_t.rhs_tables(red_t)))
    assert np.linalg.norm(b_t.numpy() - b_j) / np.linalg.norm(b_j) < 1e-13


@pytest.mark.parametrize("n_bg,n_fg", SIZES)
def test_torch_apply_matches_df(n_bg, n_fg):
    """f64 binned apply vs the JAX double-float apply_df_binned, and vs the
    f64 stencil operator of the same blocks."""
    M_j, prob_j, M_t, prob_t, shape, blocks_j = _both(n_bg, n_fg)
    red_df = jlb.build_binned_projection(prob_j.form, M_j, shape,
                                         dtype=np.float32, df=True)
    bound_df = jlb.bind_blocks_df_binned(red_df,
                                         jlb.split_blocks_df(blocks_j))
    x = np.random.default_rng(7).standard_normal(M_j.n_bg_dofs)
    y_j = np.asarray(jdf.df_to_f64(jlb.apply_df_binned(
        red_df, bound_df, jdf.df_from_f64(jnp.asarray(x)))))

    red_t = tlb.build_binned_projection(prob_t.form, M_t, shape,
                                        device="cpu")
    blocks_t = prob_t.form.jacobian_blocks(
        torch.zeros(prob_t.space.n_dofs, dtype=torch.float64))
    bound_t = [r.bind_blocks(K) for r, K in zip(red_t, blocks_t)]
    y_t = tlb.apply_binned(red_t, bound_t, torch.from_numpy(x)).numpy()
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-13

    C = tlb.stencil_planes_binned_bound(red_t, bound_t)
    y_s = JStencil(jnp.asarray(C.numpy()), shape, 2).mv_ref(jnp.asarray(x))
    assert _rel(y_t, y_s) < 1e-12
