"""The port's Navier-Stokes model (models/navier_stokes.py), its
block-multigrid Newton step and the Taylor-Green demo vs the JAX package,
from identical numpy state (the specs are iifea_tpu/models/navier_stokes.py,
tests/test_solvers.py::test_tg_step_with_block_mg and demos/tg_vortex.py).

Tolerances: the element Jacobians and residual 1e-11 relative (the same f64
arithmetic in another summation order), the error norms 1e-12, the Newton
step's iterate 1e-8 on the block's dofs (both solve with MG-GMRES to 1e-8)
and its L2u 1e-6; the demo against the same steps in process 1e-10."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iifea_tpu.api import l2_project as j_l2_project
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models import navier_stokes as jns
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.solvers import newton as jnewton
from iifea_tpu_torch.api import l2_project
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos import tg_vortex as demo
from iifea_tpu_torch.models import navier_stokes as tns
from iifea_tpu_torch.solvers import newton as tnewton

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Pair:
    """One immersed square with three fields per node in both packages."""

    def __init__(self, n_fg, n_bg, k=1):
        self.mesh_j, self.M_j = j_square(n_fg=n_fg, n_bg=n_bg, degree=k,
                                         n_fields=3)
        st = from_numpy_state(
            coords=self.mesh_j.coords, cells=self.mesh_j.cells,
            material=self.mesh_j.material, idx=self.M_j.idx_np,
            val=self.M_j.val_np, n_bg_dofs=self.M_j.n_bg_dofs, device="cpu")
        self.mesh, self.M, self.k = st.mesh, st.M, k
        self.shape = (n_bg + 1, n_bg + 1)

    def problems(self, **kw):
        kw = dict(k=self.k, Re=100.0, n_bg_dofs=self.M.n_bg_dofs, **kw)
        return (tns.TaylorGreenProblem(self.mesh, device="cpu", **kw),
                jns.TaylorGreenProblem(self.mesh_j, **kw))


@pytest.fixture(scope="module")
def pair8():
    return Pair(16, 8)


def _state(prob, seed):
    rng = np.random.default_rng(seed)
    n = prob.space.n_dofs
    return 0.3 * rng.standard_normal(n), 0.3 * rng.standard_normal(n)


def _compare_model(prob, prob_j, seed):
    u, old = _state(prob, seed)
    t = 0.37
    blocks, res = prob.form.jacobian_and_residual(
        torch.from_numpy(u), {"up_old": torch.from_numpy(old)}, {"t": t})
    blocks_j, res_j = jax.jit(prob_j.form.jacobian_and_residual)(
        jnp.asarray(u), {"up_old": jnp.asarray(old)}, {"t": jnp.asarray(t)})
    assert len(blocks) == len(blocks_j) == len(prob_j.form.terms)
    for K, K_j in zip(blocks, blocks_j):
        assert _rel(K, K_j) < 1e-11
    assert _rel(res, res_j) < 1e-11
    # the residual alone (the line search's merit) is the same function
    r2 = prob.form.residual(torch.from_numpy(u),
                            {"up_old": torch.from_numpy(old)}, {"t": t})
    assert _rel(r2, res_j) < 1e-11


@pytest.mark.parametrize("sym,facets", [(False, True), (True, True),
                                        (False, False)])
def test_torch_navier_stokes_model(pair8, sym, facets):
    """Jacobian blocks and residual of the VMS cell term and the weak
    Dirichlet facet term at a random state and old state, nonsymmetric and
    symmetric (the penalty), and the cell term alone."""
    kw = dict(Dt=0.05, sym=sym)
    if not facets:
        kw["boundary_facets"] = np.zeros(0, dtype=np.int64)
    prob, prob_j = pair8.problems(**kw)
    assert (prob.facet_dom is not None) == facets
    _compare_model(prob, prob_j, seed=3 + sym + 2 * facets)


def test_torch_navier_stokes_model_p2():
    """k = 2: the Hessian terms of div σ on the coarsest mesh with cut
    cells (P2 foreground and background)."""
    p = Pair(8, 4, k=2)
    prob, prob_j = p.problems(Dt=0.1)
    assert prob.cell_dom.hess_mode == "full" and prob.facet_dom is not None
    _compare_model(prob, prob_j, seed=7)


def test_torch_navier_stokes_error_norms(pair8):
    """error_norms (L2u, H1u, L2p, the mean-removed L2p0, H1p) at a smooth
    state near the exact one and at a random one."""
    prob, prob_j = pair8.problems(Dt=0.05)
    x = np.asarray(prob.space.node_coords)
    t = 0.4
    ue = np.asarray(jns.u_exact(jnp.asarray(x.T), prob.nu, t)).T
    pe = np.asarray(jns.p_exact(jnp.asarray(x.T), prob.nu, prob.rho, t))
    near = np.column_stack([ue, pe + 0.1]).reshape(-1)
    near = near + 1e-3 * np.random.default_rng(5).standard_normal(near.size)
    for up in (near, _state(prob, 6)[0]):
        n = prob.error_norms(torch.from_numpy(up), t)
        n_j = prob_j.error_norms(jnp.asarray(up), t)
        assert set(n) == set(n_j)
        for key in n_j:
            assert abs(n[key] - n_j[key]) <= 1e-12 * n_j[key], key


def _tg_step(pkg, pair, monkeypatch):
    """One Taylor-Green Newton time step with a pinned pressure dof and
    gmres + mg (test_solvers.py::test_tg_step_with_block_mg) through one
    package; returns (up_f, L2u, linear solves)."""
    jax_side = pkg == "jax"
    xp = jnp if jax_side else torch
    mesh, M = (pair.mesh_j, pair.M_j) if jax_side else (pair.mesh, pair.M)
    Dt = 4 / np.sqrt(mesh.n_cells)
    kw = dict(k=1, Re=100.0, Dt=Dt, sym=False, n_bg_dofs=M.n_bg_dofs)
    if jax_side:
        prob = jns.TaylorGreenProblem(mesh, **kw)
    else:
        prob = tns.TaylorGreenProblem(mesh, device="cpu", **kw)
    nu = prob.nu

    def ic_expr(x):
        u = (jns if jax_side else tns).u_exact(x, nu, 0.0)
        return (jnp.array([u[0], u[1], 0.0]) if jax_side
                else torch.cat([u, torch.zeros_like(x[:1])]))

    project = j_l2_project if jax_side else l2_project
    up_p, up_f = project(ic_expr, prob.space, prob.cell_dom, M)
    t = 0.5 * Dt
    tt = jnp.asarray(t) if jax_side else t
    if jax_side:
        blocks0 = prob.form.jacobian_blocks(up_f, {"up_old": up_f},
                                            {"t": tt})
        d0 = np.asarray(JBackgroundOperator(prob.form, blocks0, M).diag())
        nn = M.n_bg_dofs // 3
        pin = np.array([2 * nn + int(np.argmax(d0[2 * nn:]))])
    else:
        pin = demo.pressure_pin(prob, M, up_f, up_f, t)
    mod = jnewton if jax_side else tnewton
    count = [0]
    solve = mod.solve_ksp

    def counted(*a, **k):
        count[0] += 1
        return solve(*a, **k)

    monkeypatch.setattr(mod, "solve_ksp", counted)
    up_p, up_f = mod.solve_nonlinear(
        prob.form, up_f, M, up_p, aux={"up_old": up_f}, params={"t": tt},
        max_iters=10, linear_method="gmres", linear_pc="mg",
        lattice_shape=pair.shape, n_fields=3, zero_ids=pin,
        monitor_newton=False, relative_tolerance=5e-4,
        absolute_tolerance=1e-4, absolute_tolerance_res=1e-5)
    monkeypatch.undo()
    norms = prob.error_norms(up_f, Dt)
    assert np.isfinite(float(xp.linalg.norm(up_p)))
    return np.asarray(up_f), norms, count[0], pin, prob


def test_torch_tg_step_with_block_mg(pair8, monkeypatch):
    """The slice as a whole at n_fg = 16, n_bg = 8: projection, pressure
    pin, and one Newton time step whose linear solves run three-field block
    MG-GMRES, in both packages: the same pin and Newton iteration count,
    the iterate on the block's foreground dofs to 1e-8, L2u to 1e-6."""
    up_j, n_j, it_j, pin_j, _ = _tg_step("jax", pair8, monkeypatch)
    up, n, it, pin, prob = _tg_step("torch", pair8, monkeypatch)
    assert np.array_equal(pin, pin_j)
    assert it == it_j >= 1
    dofs = np.unique(prob.cell_dom.flat_eldofs_np)
    assert _rel(up[dofs], up_j[dofs]) < 1e-8
    assert abs(n["L2u"] - n_j["L2u"]) <= 1e-6 * n_j["L2u"]
    assert n_j["L2u"] < 0.02     # the reference test's bound (0.00398)


def _in_process_steps(ref, T):
    """The demo's first steps (--pc mg --pin-pressure True) driven through
    the port's functions in this process; returns the error norms."""
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.solvers import solve_nonlinear

    n = 8 * 2 ** ref
    mesh, M = immersed_square_problem(n_fg=n, n_bg=n // 2, n_fields=3,
                                      device="cpu")
    N_STEPS = int(np.ceil(T / (4 / np.sqrt(mesh.n_cells))))
    Dt = T / N_STEPS
    prob = tns.TaylorGreenProblem(mesh, Dt=Dt, n_bg_dofs=M.n_bg_dofs,
                                  device="cpu")

    def ic(x):
        return torch.cat([tns.u_exact(x, prob.nu, 0.0),
                          torch.zeros_like(x[:1])])

    up_p, up_f = l2_project(ic, prob.space, prob.cell_dom, M)
    pin = demo.pressure_pin(prob, M, up_f, up_f)
    t = 0.0
    for _ in range(N_STEPS):
        t += 0.5 * Dt
        up_p, up_f_new = solve_nonlinear(
            prob.form, up_f, M, up_p, aux={"up_old": up_f}, params={"t": t},
            max_iters=10, linear_method="gmres", linear_pc="mg",
            lattice_shape=(n // 2 + 1,) * 2, n_fields=3, zero_ids=pin,
            monitor_newton=False, relative_tolerance=5e-4,
            absolute_tolerance=1e-4, absolute_tolerance_res=1e-5)
        up_f = up_f_new
        t += 0.5 * Dt
    return prob.error_norms(up_f, t), N_STEPS


def test_torch_tg_demo_on_cpu(tmp_path):
    """python -m iifea_tpu_torch.demos.tg_vortex --device cpu at ref 2 for
    two steps: the JAX demo's report lines and CSV schema, and norms equal
    to the same steps driven in process (1e-10)."""
    T = 0.17                     # Dt ≈ 4/sqrt(2048) = 0.088: two steps
    of = tmp_path / "tg.csv"
    res = subprocess.run(
        [sys.executable, "-m", "iifea_tpu_torch.demos.tg_vortex", "--ref",
         "2", "--T", str(T), "--mesh-root", "synthetic", "--solv", "gmres",
         "--pc", "mg", "--pin-pressure", "True", "--wf", "True", "--of",
         str(of), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "======= Time step 2/2 =======" in lines
    labels = {"L2u": "L2 velocity error: ", "H1u": "H1 velocity error: ",
              "L2p": "L2 pressure error: ",
              "L2p0": "L2 pressure error (mean-removed): ",
              "H1p": "H1 pressure error: "}
    printed = {k: float(next(ln for ln in lines if ln.startswith(lab))
                        [len(lab):]) for k, lab in labels.items()}
    report = lines[-7:]
    assert report[0] == report[-1] == "-" * 40
    assert [ln.split(": ")[0] + ": " for ln in report[1:-1]] == \
        list(labels.values())
    csv = of.read_text().split("\n")
    assert csv[0] == "" and len(csv) == 2
    fields = csv[1].split(",")
    assert fields[0] == "2" and fields[5:] == ["1", "synthetic", "100.0",
                                                 "2"]
    assert [float(v) for v in fields[1:5]] == [
        printed["L2u"], printed["H1u"], printed["L2p"], printed["H1p"]]

    norms, n_steps = _in_process_steps(2, T)
    assert n_steps == 2
    for k in labels:
        assert abs(printed[k] - norms[k]) <= 1e-10 * norms[k], k


def test_torch_tg_demo_refuses_mesh_files():
    """A mesh root without the files exits naming the missing path."""
    with pytest.raises(SystemExit,
                       match="no /nonexistent/square/Linear/R0/mesh.xdmf"):
        demo.main(["--mesh-root", "/nonexistent", "--device", "cpu"])


def test_torch_tg_unfitted_demo():
    """The unfitted demo's identity default and its runtime transfer: one
    step at ref 0 on the host converges, with error norms of the fitted
    solve's size."""
    from iifea_tpu_torch.demos.background_unfitted import tg_unfitted

    for identity in ("True", "False"):
        out = tg_unfitted.main(["--ref", "0", "--T", "0.3", "--identity",
                                identity, "--device", "cpu"])
        assert out["n_steps"] == 1
        assert 0 < out["norms"]["L2u"] < 0.1, (identity, out["norms"])


def test_torch_tg_mixed_refinement_unpinned():
    """The card's route on the unpinned system (the enclosed flow's
    constant pressure a null vector on both sides): f32 MG-GMRES passes
    refined in f64 (``mixed=True``, here with the plain kernels) converge
    to the f64 route's tolerance in at most twice its iterations, to its
    solution within 1e-5. Each f32 pass must aim at the residual's
    reducible part: the component along the left null vector stays."""
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.ops.projection import BackgroundOperator
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    mesh, M = immersed_square_problem(n_fg=32, n_bg=16, n_fields=3,
                                      device="cpu")
    Dt = 4 / np.sqrt(mesh.n_cells)
    prob = tns.TaylorGreenProblem(mesh, Dt=Dt, n_bg_dofs=M.n_bg_dofs,
                                  device="cpu")

    def ic(x):
        return torch.cat([tns.u_exact(x, prob.nu, 0.0),
                          torch.zeros_like(x[:1])])

    _, up_f = l2_project(ic, prob.space, prob.cell_dom, M)
    blocks, res = prob.form.jacobian_and_residual(up_f, {"up_old": up_f},
                                                  {"t": 0.5 * Dt})
    A, b = BackgroundOperator(prob.form, blocks, M), M.rmv(res)
    kw = dict(method="gmres", pc="mg", lattice_shape=(17, 17), n_fields=3,
              monitor=False, max_it=400)
    x64, info64 = solve_ksp(A, b, mixed=False, **kw)
    x, info = solve_ksp(A, b, mixed=True, **kw)
    assert info64.converged and info.converged
    assert info.iters <= 2 * info64.iters
    assert _rel(x, x64) < 1e-5
