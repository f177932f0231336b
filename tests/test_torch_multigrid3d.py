"""Port 3D multigrid (StencilMultigrid3D and its helpers) vs the JAX
package on one immersed operator at a 17³ lattice (two levels, dense 9³
coarse), both packages starting from the same f64 stencil coefficients
(iifea_tpu_torch.convert)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.solvers import krylov as jkrylov
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.generators import immersed_cube_problem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops.stencil import StencilOperator3D
from iifea_tpu_torch.solvers import krylov
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

N_BG = 16


@pytest.fixture(scope="module")
def operator():
    """(JAX f64 stencil, port f64 stencil, f64 rhs) of the n_bg=16 cut
    cube. The planes are assembled once (by the port, in f64) and handed
    to both packages as the same numpy array."""
    mesh, M = immersed_cube_problem(n_fg=20, n_bg=N_BG, device="cpu")
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device="cpu")
    shape = (N_BG + 1,) * 3
    solver = BinnedLatticeSolver(prob, M, shape, device="cpu")
    b, Kc, Kf = solver.assemble()
    from iifea_tpu_torch.ops.cell_window import stencil_planes_windows

    C = stencil_planes_windows(solver.reducers, [Kc, Kf]).numpy()
    S_j = JStencil3(jnp.asarray(C), shape, 2)
    S_t = from_numpy_state(coeffs=np.asarray(S_j.coeffs),
                           lattice_shape=S_j.shape, radius=S_j.radius,
                           device="cpu").S
    assert isinstance(S_t, StencilOperator3D)
    return S_j, S_t, b.numpy()


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def hierarchies(operator):
    S_j, S_t, _ = operator
    mg_j, mg_t = jmg.StencilMultigrid3D(S_j), tmg.StencilMultigrid3D(S_t)
    # the coarse pseudo-inverse is Newton–Schulz in both packages; the
    # cycles are compared given the same one (see test_torch_minv_matches
    # in test_torch_multigrid.py for why the two differ at ~1e-9)
    mg_t.coarse_inv = torch.from_numpy(np.array(mg_j.coarse_inv))
    return mg_j, mg_t


def test_torch_coarsen3_matches(operator):
    S_j, S_t, _ = operator
    Cj = np.asarray(jmg._coarsen3(S_j).coeffs)
    Ct = tmg._coarsen3(S_t)
    assert Ct.shape == (9, 9, 9)
    assert _rel(Ct.coeffs, Cj) < 1e-12


def test_torch_coarsen3_masks_offgrid_slots():
    """Random planes (garbage in off-grid slots) through both packages."""
    C = np.random.default_rng(7).standard_normal((125, 9, 7, 11))
    Cj = np.asarray(jmg._coarsen3(JStencil3(jnp.asarray(C), (9, 7, 11),
                                            2)).coeffs)
    Ct = tmg._coarsen3(StencilOperator3D(torch.from_numpy(C), (9, 7, 11),
                                         2)).coeffs
    assert np.abs(Ct.numpy() - Cj).max() < 1e-12 * np.abs(Cj).max()


def test_torch_transfers3_match():
    x = np.random.default_rng(8).standard_normal((9, 7, 11))
    xc = np.random.default_rng(9).standard_normal((5, 4, 6))
    assert np.abs(tmg._restrict3(torch.from_numpy(x)).numpy()
                  - np.asarray(jmg._restrict3(jnp.asarray(x)))).max() < 1e-14
    assert np.abs(tmg._prolong3(torch.from_numpy(xc)).numpy()
                  - np.asarray(jmg._prolong3(jnp.asarray(xc)))).max() < 1e-14


def test_torch_invd3_l1_matches(operator):
    S_j, S_t, _ = operator
    assert _rel(tmg._invd3_l1(S_t), jmg._invd3_l1(S_j)) < 1e-12


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_torch_chebyshev_sweeps_match(operator, hierarchies, start, sweeps):
    """f64 Chebyshev smoothing (l1 scaling, [1.05/8, 1.05]) at 1e-12, from
    x = 0 (the pre-smoother: first step through the Jacobi sweep) and from a
    random x (the post-smoother)."""
    _, S_t, _ = operator
    mg_j, mg_t = hierarchies
    rng = np.random.default_rng(10)
    b = rng.standard_normal(S_t.n)
    x = np.zeros(S_t.n) if start == "zero" else rng.standard_normal(S_t.n)
    y_j = mg_j._smooth(0, jnp.asarray(x), jnp.asarray(b), sweeps)
    y_t = mg_t._smooth(0, torch.from_numpy(x), torch.from_numpy(b), sweeps,
                       x_zero=start == "zero")
    assert _rel(y_t, y_j) < 1e-12


def test_torch_minv3_matches(operator, hierarchies):
    """f64 V-cycle action (Chebyshev 2+2, dense coarse solve) at 1e-12,
    with both cycles given the same coarse pseudo-inverse."""
    _, S_t, _ = operator
    mg_j, mg_t = hierarchies
    assert len(mg_t.levels) == len(mg_j.levels) == 2
    assert mg_t.coarse_inv.shape == (729, 729)
    r = np.random.default_rng(3).standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)),
                mg_j.minv(jnp.asarray(r))) < 1e-12


def test_torch_cg3_matches(operator):
    """f32 MG-PCG from identical state (each package with its own coarse
    pseudo-inverse): iteration counts within one check chunk."""
    S_j, S_t, b = operator
    S_j32, S_t32 = S_j.astype(jnp.float32), S_t.to(torch.float32)
    mg_j, mg_t = jmg.StencilMultigrid3D(S_j32), tmg.StencilMultigrid3D(S_t32)
    b32 = b.astype(np.float32)
    x_j, info_j = jkrylov.cg(S_j32.mv_ref, jnp.asarray(b32), minv=mg_j.minv,
                             rtol=1e-6, atol=1e-30, max_it=500,
                             check_every=4)
    x_t, info_t = krylov.cg(S_t32.mv, torch.from_numpy(b32),
                            minv=mg_t.minv, rtol=1e-6, atol=1e-30,
                            max_it=500, check_every=4)
    assert info_t.converged and bool(info_j.converged)
    assert abs(info_t.iters - int(info_j.iters)) <= 4


@pytest.mark.parametrize("kw", [
    dict(smoother="jacobi"), dict(smoother="jacobi", omega=0.8),
    dict(cheb_alpha=4.0), dict(smoother="chebyshev", cheb_alpha=8.0),
])
def test_torch_multigrid3d_smoother_options(operator, kw):
    """StencilMultigrid3D's smoother, omega and cheb_alpha options: the
    smoothing steps (from x and from zero) and the V-cycle against JAX's
    with the same arguments, given JAX's coarse inverse; f64 at 1e-10. The
    defaults are the Chebyshev cycle with α = 8."""
    S_j, S_t, b = operator
    mg_j = jmg.StencilMultigrid3D(S_j, **kw)
    mg_t = tmg.StencilMultigrid3D(S_t, **kw)
    assert (mg_t.smoother, mg_t.omega, mg_t.cheb_alpha) == (
        mg_j.smoother, mg_j.omega, mg_j.cheb_alpha)
    rng = np.random.default_rng(41)
    x = rng.standard_normal(S_t.n)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    for sweeps in (1, 3):
        assert _rel(mg_t._smooth(0, torch.from_numpy(x), bt, sweeps),
                    mg_j._smooth(0, jnp.asarray(x), bj, sweeps)) < 1e-10
        assert _rel(mg_t._smooth(0, torch.zeros_like(bt), bt, sweeps,
                                 x_zero=True),
                    mg_j._smooth(0, jnp.zeros(S_t.n), bj, sweeps)) < 1e-10
    mg_t.coarse_inv = torch.from_numpy(np.array(mg_j.coarse_inv))
    r = rng.standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)),
                mg_j.minv(jnp.asarray(r))) < 1e-10


def test_torch_multigrid3d_defaults_and_refusal(operator):
    _, S_t, _ = operator
    mg_t = tmg.StencilMultigrid3D(S_t)
    assert (mg_t.smoother, mg_t.omega, mg_t.cheb_alpha) == ("chebyshev", 1.0,
                                                            8.0)
    with pytest.raises(ValueError, match="smoother"):
        tmg.StencilMultigrid3D(S_t, smoother="sor")
