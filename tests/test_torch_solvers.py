"""The port's Krylov solvers, Jacobi, trim helpers, direct solve and
condition estimate vs the JAX package's, on the same numpy inputs (the
specs are tests/test_solvers.py and tests/test_condition.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from iifea_tpu.solvers import krylov as jkrylov
from iifea_tpu.solvers import trim as jtrim
from iifea_tpu.solvers.condition import estimate_condition_number as jcond
from iifea_tpu.solvers.direct import solve_direct as jdirect
from iifea_tpu.solvers.precond import jacobi as jjacobi
from iifea_tpu_torch.solvers import krylov, trim
from iifea_tpu_torch.solvers.condition import estimate_condition_number
from iifea_tpu_torch.solvers.direct import solve_direct
from iifea_tpu_torch.solvers.precond import jacobi

# the port reads the residual every check_every iterations (CG, BiCGStab:
# 8; GMRES: 1 Arnoldi step); GCR checks per cycle, as the JAX package
CHECK = {"cg": 8, "bicgstab": 8, "gmres": 1, "gcr": 1}


def make_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T + n * np.eye(n), rng


def _both(method, A, b, **kw):
    """(port x, port info, JAX x, JAX info) on A x = b."""
    At = torch.from_numpy(A)
    Aj = jnp.asarray(A)
    x, info = getattr(krylov, method)(lambda v: At @ v, torch.from_numpy(b),
                                      **kw)
    xj, info_j = getattr(jkrylov, method)(lambda v: Aj @ v, jnp.asarray(b),
                                          **kw)
    return x.numpy(), info, np.asarray(xj), info_j


@pytest.mark.parametrize("method", ["cg", "gmres", "gcr", "bicgstab"])
def test_torch_krylov_spd(method):
    A, rng = make_spd(40)
    b = rng.standard_normal(40)
    x, info, xj, info_j = _both(method, A, b, rtol=1e-12, atol=1e-14)
    assert info.converged and bool(info_j.converged)
    assert np.abs(x - xj).max() <= 1e-8
    assert np.abs(x - np.linalg.solve(A, b)).max() <= 1e-8
    assert abs(info.iters - int(info_j.iters)) < max(CHECK[method], 2)


@pytest.mark.parametrize("method", ["gmres", "gcr", "bicgstab"])
def test_torch_krylov_nonsymmetric(method):
    rng = np.random.default_rng(3)
    n = 35
    A = np.eye(n) * 5 + rng.standard_normal((n, n)) * 0.5
    b = rng.standard_normal(n)
    x, info, xj, info_j = _both(method, A, b, rtol=1e-12, atol=1e-14)
    assert np.abs(x - xj).max() <= 1e-8
    assert abs(info.iters - int(info_j.iters)) < max(CHECK[method], 2)


def test_torch_gmres_restart_cycles():
    A, rng = make_spd(50, seed=7)
    b = rng.standard_normal(50)
    x, info, xj, info_j = _both("gmres", A, b, restart=10, rtol=1e-11)
    assert np.abs(x - xj).max() <= 1e-8
    assert info.history is not None and len(info.history) > 2
    assert info.iters == int(info_j.iters)


def test_torch_cg_nonzero_initial_guess():
    A, rng = make_spd(20, seed=9)
    b = rng.standard_normal(20)
    x_ref = np.linalg.solve(A, b)
    x0 = x_ref + 1e-3 * rng.standard_normal(20)
    x, info = krylov.cg(lambda v: torch.from_numpy(A) @ v,
                        torch.from_numpy(b), x0=torch.from_numpy(x0),
                        rtol=1e-12, check_every=4)
    assert info.iters <= 16
    assert np.abs(x.numpy() - x_ref).max() <= 1e-8


def test_torch_jacobi_matches():
    rng = np.random.default_rng(5)
    n = 60
    d = 10.0 ** rng.uniform(-2, 2, n)
    d[::7] = 0.0
    A = np.diag(d) + 0.01 * np.eye(n)
    b = rng.standard_normal(n)
    for guard in (0.0, 0.05):
        y = jacobi(torch.from_numpy(d), guard)(torch.from_numpy(b))
        yj = jjacobi(jnp.asarray(d), guard)(jnp.asarray(b))
        assert np.array_equal(y.numpy(), np.asarray(yj))
    minv = jacobi(torch.from_numpy(np.diag(A).copy()))
    x, info_pc = krylov.cg(lambda v: torch.from_numpy(A) @ v,
                           torch.from_numpy(b), minv=minv, rtol=1e-10)
    _, info_plain = krylov.cg(lambda v: torch.from_numpy(A) @ v,
                              torch.from_numpy(b), rtol=1e-10, max_it=5000)
    assert info_pc.iters < info_plain.iters
    assert np.abs(x.numpy() - np.linalg.solve(A, b)).max() <= 1e-7


def test_torch_trim_helpers():
    rng = np.random.default_rng(2)
    d = rng.standard_normal(30)
    b = rng.standard_normal(30)
    tgt = rng.standard_normal(30)
    mask = trim.trim_mask_from_diag(torch.from_numpy(d), 0.1)
    mask_j = jtrim.trim_mask_from_diag(jnp.asarray(d), 0.1)
    assert np.array_equal(mask.numpy(), np.asarray(mask_j))
    for target in (None, tgt):
        bt = trim.apply_trim_rhs(
            torch.from_numpy(b), mask,
            None if target is None else torch.from_numpy(target))
        bj = jtrim.apply_trim_rhs(jnp.asarray(b), mask_j,
                                  None if target is None
                                  else jnp.asarray(target))
        assert np.array_equal(bt.numpy(), np.asarray(bj))
    ids = [3, 7, 29]
    assert np.array_equal(trim.mask_from_ids(ids, 30, device="cpu").numpy(),
                          np.asarray(jtrim.mask_from_ids(ids, 30)))


def _near_null_system():
    rng = np.random.default_rng(3)
    n = 60
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 4.0, n)) @ Q.T
    s = np.ones(n)
    s[:4] = 1e-12
    A = (A * s[:, None]) * s[None, :]
    b = A @ np.ones(n)
    A[:4, :4] += 1e-17 * rng.standard_normal((4, 4))
    return A, b


def _ill_conditioned_system():
    rng = np.random.default_rng(11)
    n = 80
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.logspace(-11, 0, n)) @ Q.T
    return A, A @ rng.standard_normal(n)


@pytest.mark.parametrize("case", ["null_row", "near_null", "ill_conditioned"])
def test_torch_solve_direct_matches(case):
    if case == "null_row":
        A = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 0.0], [0.0, 0.0, 0.0]])
        b = np.array([1.0, 2.0, 5.0])
    elif case == "near_null":
        A, b = _near_null_system()
    else:
        A, b = _ill_conditioned_system()
    x = solve_direct(sp.csr_matrix(A), b)
    xj = jdirect(sp.csr_matrix(A), b)
    assert np.all(np.isfinite(x))
    assert np.array_equal(x, xj)
    if case == "null_row":
        assert np.allclose(A[:2, :2] @ x[:2], b[:2]) and x[2] == 0.0
    if case == "near_null":
        assert np.allclose(x[4:], 1.0, atol=1e-6)


class _DenseOps:
    """The same dense matrix as a port (torch) and a JAX operator."""

    def __init__(self, A, lib):
        self.A = torch.from_numpy(A) if lib == "torch" else jnp.asarray(A)
        self.n = A.shape[0]

    def mv(self, x):
        return self.A @ x

    def mv_t(self, x):
        return self.A.T @ x


@pytest.mark.parametrize("kind", ["spd", "nonsymmetric"])
def test_torch_condition_number(kind):
    rng = np.random.default_rng(0 if kind == "spd" else 1)
    if kind == "spd":
        Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
        A = Q @ np.diag(np.linspace(0.5, 80.0, 40)) @ Q.T
    else:
        U, _ = np.linalg.qr(rng.standard_normal((30, 30)))
        V, _ = np.linalg.qr(rng.standard_normal((30, 30)))
        A = U @ np.diag(np.geomspace(1e-2, 1e2, 30)) @ V.T
    n = A.shape[0]
    smax, smin = estimate_condition_number(_DenseOps(A, "torch"), iters=n)
    smax_j, smin_j = jcond(_DenseOps(A, "jax"), iters=n)
    assert abs(smax - smax_j) <= 1e-6 * smax_j
    assert abs(smin - smin_j) <= 1e-6 * smin_j
    s = np.linalg.svd(A, compute_uv=False)
    assert abs(smax - s.max()) <= 1e-6 * s.max()


def test_torch_cg_stall_stops_at_the_floor():
    """CG's stagnation stop: on an inconsistent singular system the
    residual cannot fall below the part of b outside the range, and CG
    stops three checks after its least residual (unconverged, stalled),
    returning the iterate of that least residual instead of running on
    past the floor (here into overflow) to max_it. A system CG solves
    never meets the stop: the same iterate as a textbook CG run for the
    same number of iterations."""
    n = 40
    d = torch.linspace(1.0, 4.0, n, dtype=torch.float64)
    d[-1] = 0.0
    b = torch.ones(n, dtype=torch.float64)

    def mv(v):
        return d * v

    x, info = krylov.cg(mv, b, rtol=1e-12, max_it=400, check_every=4)
    assert info.stalled and not info.converged and info.iters < 400
    assert info.iters == 4 * (info.history.index(min(info.history)) + 3)
    assert info.resnorm == min(info.history) >= 1.0
    assert float(torch.linalg.vector_norm(b - mv(x))) == pytest.approx(
        info.resnorm, rel=1e-12)
    d[-1] = 2.0
    x1, i1 = krylov.cg(mv, b, rtol=1e-10, check_every=4)
    assert i1.converged and not i1.stalled
    xr, r = torch.zeros_like(b), b.clone()
    p, rr = r.clone(), torch.dot(r, r)
    for _ in range(i1.iters):
        ap = mv(p)
        alpha = rr / torch.dot(p, ap)
        xr, r = xr + alpha * p, r - alpha * ap
        rr_new = torch.dot(r, r)
        p, rr = r + rr_new / rr * p, rr_new
    assert torch.allclose(x1, xr, rtol=1e-13, atol=0)


def test_torch_mixed_single_level_checks_every_iteration():
    """The mixed route on a one-level hierarchy (3D elasticity at n_bg = 8:
    the dense 3 × 9³ inverse is the whole preconditioner) checks its f32 CG
    every iteration, so a pass stops where the inverse has taken the
    residual to the floor instead of iterating on rounding noise: at most
    two iterations a pass, and the f64 route's error norms."""
    from iifea_tpu_torch.mesh.generators import immersed_cube_problem
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    mesh, M = immersed_cube_problem(n_fg=10, n_bg=8, n_fields=3,
                                    device="cpu")
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True, device="cpu")
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    kw = dict(method="cg", pc="mg", rtol=1e-10, lattice_shape=(9, 9, 9),
              n_fields=3, monitor=False)
    x64, _ = solve_ksp(A, b, mixed=False, **kw)
    x, info = solve_ksp(A, b, mixed=True, **kw)
    passes = len(info.history) - 1
    assert info.converged and 1 <= info.iters <= 2 * passes
    n, n64 = prob.error_norms(M.mv(x)), prob.error_norms(M.mv(x64))
    for k in ("L2", "H10"):
        assert abs(n[k] - n64[k]) < 1e-8 * n64[k]
