"""Port multigrid and CG vs the JAX package on one immersed operator at a
65² lattice (two levels, dense 33² coarse), both packages starting from the
same stencil coefficients (iifea_tpu_torch.convert)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil
from iifea_tpu.solvers import krylov as jkrylov
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.generators import immersed_square_problem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import lattice_bin as tlb
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.solvers import krylov
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

N_BG = 64


@pytest.fixture(scope="module")
def operator():
    """(JAX f64 stencil, port f64 stencil, f64 rhs) of the n_bg=64 cut
    square. The planes are assembled once (by the port) and handed to both
    packages as the same numpy array."""
    mesh, M = immersed_square_problem(n_fg=90, n_bg=N_BG, device="cpu")
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device="cpu")
    shape = (N_BG + 1, N_BG + 1)
    solver = BinnedLatticeSolver(prob, M, shape, device="cpu")
    b, Kc, Kf = solver.assemble()
    C = tlb.stencil_planes_binned_bound(solver.reducers,
                                        solver.bind(Kc, Kf)).numpy()
    S_j = JStencil(jnp.asarray(C), shape, 2)
    S_t = from_numpy_state(coeffs=np.asarray(S_j.coeffs),
                           lattice_shape=S_j.shape, radius=S_j.radius,
                           device="cpu").S
    return S_j, S_t, b.numpy()


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def test_torch_coarsen_matches(operator):
    S_j, S_t, _ = operator
    Cj = np.asarray(jmg._coarsen(S_j).coeffs)
    Ct = tmg._coarsen(S_t)
    assert Ct.shape == (33, 33)
    assert _rel(Ct.coeffs, Cj) < 1e-12
    Cj32 = np.asarray(jmg._coarsen(S_j.astype(jnp.float32)).coeffs)
    Ct32 = tmg._coarsen(S_t.to(torch.float32)).coeffs
    assert Ct32.dtype == torch.float32
    assert _rel(Ct32, Cj32) < 1e-5


def test_torch_coarsen_masks_offgrid_slots():
    """Random planes (garbage in off-grid slots) through both packages."""
    C = np.random.default_rng(7).standard_normal((25, 17, 13))
    Cj = np.asarray(jmg._coarsen(JStencil(jnp.asarray(C), (17, 13), 2)).coeffs)
    Ct = tmg._coarsen(tmg.StencilOperator2D(torch.from_numpy(C), (17, 13),
                                            2)).coeffs
    assert np.abs(Ct.numpy() - Cj).max() < 1e-12


def test_torch_transfers_match():
    x = np.random.default_rng(8).standard_normal((17, 13))
    xc = np.random.default_rng(9).standard_normal((9, 7))
    assert np.abs(tmg._restrict(torch.from_numpy(x)).numpy()
                  - np.asarray(jmg._restrict(jnp.asarray(x)))).max() < 1e-14
    assert np.abs(tmg._prolong(torch.from_numpy(xc)).numpy()
                  - np.asarray(jmg._prolong(jnp.asarray(xc)))).max() < 1e-14


def test_torch_minv_matches(operator):
    """f64 V-cycle action (Jacobi 2+2, ω=0.67, dense coarse solve) at 1e-12,
    with both cycles given the same coarse pseudo-inverse."""
    S_j, S_t, _ = operator
    mg_j = jmg.StencilMultigrid(S_j)
    mg_t = tmg.StencilMultigrid(S_t)
    assert len(mg_t.levels) == len(mg_j.levels) == 2
    assert mg_t.coarse_inv.shape == (33 * 33, 33 * 33)
    # the port's own pseudo-inverse: Newton–Schulz at 50 iterations leaves
    # the smallest nonzero modes of this singular coarse operator (λ ~ 2e-6
    # λmax) partly converged, where matmul rounding differences between the
    # two packages grow to ~1e-9 relative
    rc = np.random.default_rng(4).standard_normal(33 * 33)
    assert _rel(mg_t.coarse_inv @ torch.from_numpy(rc),
                mg_j.coarse_inv @ jnp.asarray(rc)) < 1e-7
    mg_t.coarse_inv = torch.from_numpy(np.array(mg_j.coarse_inv))
    r = np.random.default_rng(3).standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)),
                mg_j.minv(jnp.asarray(r))) < 1e-12


def test_torch_pinv_matches():
    """Newton–Schulz pseudo-inverse on a well-conditioned SPD matrix."""
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((96, 96)))[0]
    A = (Q * rng.uniform(1.0, 20.0, 96)) @ Q.T
    Xt = tmg._pinv(torch.from_numpy(A)).numpy()
    assert _rel(Xt, np.asarray(jmg._pinv(jnp.asarray(A)))) < 1e-12
    assert _rel(Xt, np.linalg.inv(A)) < 1e-12


@pytest.mark.parametrize("dim,n_fields", [(2, 1), (3, 1), (2, 3), (3, 3)])
def test_torch_dense_coarse_matrix_from_planes(dim, n_fields):
    """The coarsest level's dense matrix read off the planes equals the
    operator applied to every unit vector, bitwise (scalar and block, 2D
    and 3D, radius 2 and a radius-3 scalar case)."""
    from iifea_tpu_torch.ops import stencil as tst

    shape = (5, 6) if dim == 2 else (4, 5, 3)
    r = 3 if (dim, n_fields) == (2, 1) else 2
    taps = (2 * r + 1) ** dim
    lead = () if n_fields == 1 else (n_fields, n_fields)
    C = torch.from_numpy(np.random.default_rng(dim + n_fields).standard_normal(
        lead + (taps,) + shape))
    cls = {(2, False): tst.StencilOperator2D, (3, False): tst.StencilOperator3D,
           (2, True): tst.StencilOperatorBlock2D,
           (3, True): tst.StencilOperatorBlock3D}[(dim, n_fields > 1)]
    S = cls(C, shape, r)
    ref = S.mv_ref(torch.eye(S.n, dtype=S.dtype)).T
    assert torch.equal(tmg._dense(S), ref)


def test_torch_pinv_lone_rows_match():
    """A matrix whose unsupported dofs couple to nothing but their unit
    diagonal (a cut lattice's coarsest level): the port iterates those rows
    as scalars and the coupled block as a matrix; JAX's full iteration
    agrees to 1e-12, a singular coupled pair included."""
    rng = np.random.default_rng(11)
    n = 120
    B = rng.standard_normal((n, n))
    A = B @ B.T / n
    A[:, 0] = A[:, 1]                       # a null pair in the block
    A[0, :] = A[1, :]
    lone = rng.permutation(np.arange(2, n))[:50]
    A[lone, :] = 0.0
    A[:, lone] = 0.0
    A[lone, lone] = rng.uniform(0.5, 3.0, len(lone))
    for steps in (44, 50):
        Xt = tmg._pinv(torch.from_numpy(A), iters=steps).numpy()
        Xj = np.asarray(jmg._pinv(jnp.asarray(A), iters=steps))
        assert _rel(Xt, Xj) < 1e-12


def test_torch_cg_matches(operator):
    """f32 MG-PCG from identical state: same iteration count (or within one
    check chunk), x to 1e-5."""
    S_j, S_t, b = operator
    S_j32, S_t32 = S_j.astype(jnp.float32), S_t.to(torch.float32)
    mg_j, mg_t = jmg.StencilMultigrid(S_j32), tmg.StencilMultigrid(S_t32)
    b32 = b.astype(np.float32)
    x_j, info_j = jkrylov.cg(S_j32.mv_ref, jnp.asarray(b32), minv=mg_j.minv,
                             rtol=1e-6, atol=1e-30, max_it=500,
                             check_every=4)
    x_t, info_t = krylov.cg(S_t32.mv, torch.from_numpy(b32),
                            minv=mg_t.minv, rtol=1e-6, atol=1e-30,
                            max_it=500, check_every=4)
    assert info_t.converged and bool(info_j.converged)
    assert abs(info_t.iters - int(info_j.iters)) <= 4
    assert _rel(x_t, x_j) < 1e-5


def test_torch_lmax_and_cheb_smoother_match(operator):
    """The Chebyshev option of the 2D cycle: the per-level power-iteration
    λmax, ``_smooth_cheb`` from x and from zero, and the whole V-cycle
    against JAX's (given the same coarse inverse), f64 at 1e-10."""
    S_j, S_t, b = operator
    mg_j = jmg.StencilMultigrid(S_j, smoother="chebyshev")
    mg_t = tmg.StencilMultigrid(S_t, smoother="chebyshev")
    assert mg_t.smoother == "chebyshev" and len(mg_t.lmaxs) == 2
    for lt, lj, lv, lv_j, d, d_j in zip(mg_t.lmaxs, mg_j.lmaxs, mg_t.levels,
                                        mg_j.levels, mg_t.inv_diags,
                                        mg_j.inv_diags):
        assert abs(lt - float(lj)) < 1e-10 * float(lj)
        assert abs(tmg._lmax_jacobi(lv, d, iters=5)
                   - float(jmg._lmax_jacobi(lv_j, d_j, iters=5))) < 1e-10 * lt
    rng = np.random.default_rng(21)
    x = rng.standard_normal(S_t.n)
    for sweeps in (0, 1, 3):
        got = mg_t._smooth_cheb(0, torch.from_numpy(x), torch.from_numpy(b),
                                sweeps)
        assert _rel(got, mg_j._smooth_cheb(0, jnp.asarray(x), jnp.asarray(b),
                                           sweeps)) < 1e-10
    xz, res = mg_t._smooth(0, None, torch.from_numpy(b), 2,
                           with_residual=True)
    xz_j = mg_j._smooth(0, jnp.zeros(S_t.n), jnp.asarray(b), 2)
    assert _rel(xz, xz_j) < 1e-10
    assert _rel(res, jnp.asarray(b) - S_j.mv_ref(xz_j)) < 1e-10
    mg_t.coarse_inv = torch.from_numpy(np.array(mg_j.coarse_inv))
    r = rng.standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)),
                mg_j.minv(jnp.asarray(r))) < 1e-10


def test_torch_chebyshev_smoother_option(operator):
    """smoother='chebyshev' inside CG (the reference's
    test_chebyshev_smoother_option): converges like the default, within
    twice its iterations, with JAX's iteration count and JAX's solution
    for the same option (supported dofs: a diagonal above 1e-3 of the
    largest; the singular system's null components follow the
    preconditioner, so the two smoothers' own solutions are not compared);
    an unknown smoother is refused; the default builds no λmax."""
    S_j, S_t, b = operator
    bt = torch.from_numpy(b)
    its = {}
    for smoother in ("jacobi", "chebyshev"):
        mg_t = tmg.StencilMultigrid(S_t, smoother=smoother)
        x_t, info = krylov.cg(S_t.mv, bt, minv=mg_t.minv, rtol=1e-10,
                              check_every=2)
        assert info.converged
        its[smoother] = info.iters
    assert its["chebyshev"] <= 2 * its["jacobi"]
    mg_j = jmg.StencilMultigrid(S_j, smoother="chebyshev")
    x_j, info_j = jkrylov.cg(S_j.mv_ref, jnp.asarray(b), minv=mg_j.minv,
                             rtol=1e-10, check_every=2)
    assert abs(its["chebyshev"] - int(info_j.iters)) <= 2
    d = S_t.diag().abs()
    mask = (d > 1e-3 * d.max()).numpy()
    x_j = np.asarray(x_j)
    assert np.abs(x_t.numpy() - x_j)[mask].max() <= 1e-6 * max(
        np.abs(x_j[mask]).max(), 1.0)
    assert tmg.StencilMultigrid(S_t).lmaxs is None
    with pytest.raises(ValueError, match="smoother"):
        tmg.StencilMultigrid(S_t, smoother="gauss-seidel")
