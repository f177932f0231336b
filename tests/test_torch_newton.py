"""The port's Newton solvers vs the JAX package's, from identical numpy
state: ``solve_nonlinear`` on the reference's three cases
(tests/test_solvers.py: nonlinear diffusion with ``linear_pc='mg'`` against
Jacobi, the atan-reaction line-search case, ``solve_newtons_linear`` with a
warm start and pinned dofs) and once each through ``ptc_sigma0``,
``bfr_tol`` and ``zero_ids``. Both packages must take the same number of
Newton iterations (linear solves) and land on the same iterate on
supported dofs: 1e-8·max|u| with direct linear solves, 1e-5 with iterative
ones (the reference test's own tolerance)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.core import FunctionSpace as JSpace
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops import assembly as jasm
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.solvers import newton as jnewton
from iifea_tpu_torch import api
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.core import FunctionSpace
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import assembly as tasm
from iifea_tpu_torch.solvers import newton as tnewton


def _kernels(xp, einsum, kind):
    """The same weak forms for both packages (xp: jnp or torch)."""
    def diffusion(u_loc, aux_loc, ctx, params):
        uq = einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = einsum("q,q,qd,qbd->b", ctx.w, 1 + uq ** 2, gu, ctx.gphi)
        r = r + einsum("q,q,qb->b", ctx.w, uq - 1.0, ctx.phi)
        return r[:, None]

    def atan_reaction(u_loc, aux_loc, ctx, params):
        uq = einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
        r = r + einsum("q,q,qb->b", ctx.w, xp.arctan(uq - 2.0), ctx.phi)
        return r[:, None]

    return {"diffusion": diffusion, "atan": atan_reaction}[kind]


class Pair:
    """One cut-square problem with a nonlinear scalar form, in both
    packages; ``run`` drives both Newton solvers with the same arguments
    and counts their linear solves."""

    def __init__(self, n_fg, n_bg, kind):
        mesh_j, self.M_j = j_square(n_fg=n_fg, n_bg=n_bg)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=self.M_j.idx_np,
            val=self.M_j.val_np, n_bg_dofs=self.M_j.n_bg_dofs, device="cpu")
        self.M = st.M
        cells = np.where(mesh_j.material == 2)[0]
        V_j = JSpace(mesh_j, degree=1, n_fields=1)
        self.form_j = jasm.Form(V_j, [jasm.Term(
            jasm.build_cell_domain(V_j, cells, 3),
            _kernels(jnp, jnp.einsum, kind))])
        V = FunctionSpace(st.mesh, degree=1, n_fields=1)
        self.form = tasm.Form(V, [tasm.Term(
            tasm.build_cell_domain(V, cells, 3, device="cpu"),
            _kernels(torch, torch.einsum, kind))])
        self.shape = (n_bg + 1, n_bg + 1)
        self.n = self.M.n_bg_dofs

    def run(self, monkeypatch, u0, **kw):
        """(u_p port, u_p JAX, linear solves port, linear solves JAX); an
        exception of either package is returned in place of its iterate."""
        counts = {"t": 0, "j": 0}

        def counting(mod, key):
            solve = mod.solve_ksp

            def wrapped(*a, **k):
                counts[key] += 1
                return solve(*a, **k)
            monkeypatch.setattr(mod, "solve_ksp", wrapped)

        counting(tnewton, "t")
        counting(jnewton, "j")
        kw = {"max_iters": 30, "relative_tolerance": 1e-8,
              "monitor_newton": False, **kw}
        u0 = np.asarray(u0, dtype=np.float64)
        try:
            u0_t = torch.from_numpy(u0.copy())
            u_t, u_f = tnewton.solve_nonlinear(
                self.form, self.M.mv(u0_t), self.M, u0_t, **kw)
            assert torch.equal(u_f, self.M.mv(u_t))
            u_t = u_t.numpy()
        except tnewton.NonlinearSolveError as e:
            u_t = e
        try:
            u0_j = jnp.asarray(u0)
            u_j, _ = jnewton.solve_nonlinear(
                self.form_j, self.M_j.mv(u0_j), self.M_j, u0_j, **kw)
            u_j = np.asarray(u_j)
        except jnewton.NonlinearSolveError as e:
            u_j = e
        return u_t, u_j, counts["t"], counts["j"]

    def supported(self, u):
        blocks = self.form_j.jacobian_blocks(self.M_j.mv(jnp.asarray(u)))
        return np.abs(np.asarray(JBackgroundOperator(
            self.form_j, blocks, self.M_j).diag())) > 0

    def agree(self, u_t, u_j, tol):
        d = self.supported(u_j)
        scale = max(np.abs(u_j).max(), 1.0)
        return np.abs(u_t - u_j)[d].max() <= tol * scale


@pytest.fixture(scope="module")
def diffusion():
    return Pair(24, 16, "diffusion")


@pytest.fixture(scope="module")
def diffusion8():
    return Pair(12, 8, "diffusion")


@pytest.mark.parametrize("pc", ["mg", "jacobi"])
def test_torch_newton_with_mg_fast_path(diffusion, monkeypatch, pc):
    """Nonlinear diffusion at n_bg=16 with CG linear solves: pc='mg' (each
    Newton step re-assembled onto the stencil fast path) and pc='jacobi',
    each against the JAX package with the same arguments."""
    p = diffusion
    kw = dict(linear_method="cg", linear_pc=pc)
    if pc == "mg":
        kw["lattice_shape"] = p.shape
    u_t, u_j, n_t, n_j = p.run(monkeypatch, np.zeros(p.n), **kw)
    assert n_t == n_j and 2 <= n_t < 30
    assert p.agree(u_t, u_j, 1e-5)


def test_torch_newton_mg_equals_jacobi(diffusion, monkeypatch):
    """The reference test's own comparison inside the port: the MG and the
    Jacobi runs land on the same iterate on supported dofs."""
    p = diffusion
    u_mg, _, n_mg, _ = p.run(monkeypatch, np.zeros(p.n), linear_method="cg",
                             linear_pc="mg", lattice_shape=p.shape)
    u_ja, _, n_ja, _ = p.run(monkeypatch, np.zeros(p.n), linear_method="cg",
                             linear_pc="jacobi")
    assert p.agree(u_mg, u_ja, 1e-5)


@pytest.fixture(scope="module")
def atan8():
    return Pair(12, 8, "atan")


@pytest.mark.parametrize("line_search", [False, True])
def test_torch_newton_line_search_globalizes(atan8, monkeypatch, line_search):
    """The atan-reaction problem started far away (n_bg=8, direct linear
    solves): plain Newton overshoots and has not converged after 8 steps
    in either package (NonlinearSolveError after 8 solves; its iterates
    blow up, and each further near-singular direct solve costs seconds),
    the Armijo backtracking variant converges within 15 in both, with the
    same number of steps, to the same iterate and a small projected
    residual."""
    p = atan8
    u_t, u_j, n_t, n_j = p.run(
        monkeypatch, np.full(p.n, 20.0), max_iters=15 if line_search else 8,
        linear_method="direct", line_search=line_search)
    assert n_t == n_j
    if not line_search:
        assert isinstance(u_t, tnewton.NonlinearSolveError)
        assert isinstance(u_j, jnewton.NonlinearSolveError)
        assert n_t == 8
        return
    assert n_t < 15 and p.agree(u_t, u_j, 1e-8)
    u = torch.from_numpy(u_t)
    R = p.M.rmv(p.form.residual(p.M.mv(u)))
    assert float(torch.linalg.vector_norm(R)) < 1e-6


@pytest.mark.parametrize("option", ["ptc", "bfr", "zero_ids", "relax"])
def test_torch_newton_options(diffusion8, monkeypatch, option):
    """ptc_sigma0 (the shifted operator), bfr_tol (rows trimmed by the
    Jacobian's diagonal), zero_ids (pinned dofs stay at their start) and
    relax_param with du_0_mag, once each at n_bg=8 with direct solves."""
    p = diffusion8
    pin = np.array([p.n // 2, p.n // 2 + 1])
    kw = {"ptc": dict(ptc_sigma0=0.1, max_iters=60),
          "bfr": dict(bfr_tol=1e-9),
          "zero_ids": dict(zero_ids=pin),
          "relax": dict(relax_param=0.8, du_0_mag=1.0)}[option]
    u_t, u_j, n_t, n_j = p.run(monkeypatch, np.zeros(p.n),
                               linear_method="direct", **kw)
    assert n_t == n_j and n_t >= 2
    assert p.agree(u_t, u_j, 1e-8)
    if option == "zero_ids":
        assert np.all(u_t[pin] == 0.0)


def test_torch_newton_estimate_cond_num(diffusion8, capsys):
    """estimate_cond_num logs the singular-value estimates each step, and
    the monitor lines go through log_info."""
    p = diffusion8
    u0 = torch.zeros(p.n, dtype=torch.float64)
    tnewton.solve_nonlinear(p.form, p.M.mv(u0), p.M, u0, max_iters=30,
                            relative_tolerance=1e-8, linear_method="direct",
                            estimate_cond_num=True)
    out = capsys.readouterr().out
    assert "sigma_max:" in out and "Newton solver iteration: 0," in out


def test_torch_newtons_linear_warm_start_pins_zero():
    """solve_newtons_linear with zero_ids and a nonzero warm start: pinned
    dofs end at 0, supported dofs match the cold start, and both equal the
    JAX package's results."""
    mesh_j, M_j = j_square(n_fg=18, n_bg=12)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10)
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu")
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    pin = np.array([0, 1])
    warm0 = np.random.default_rng(5).standard_normal(M_j.n_bg_dofs)
    kw = dict(zero_ids=pin, monitor_newton=False, linear_method="direct")
    u_f = torch.zeros(prob.space.n_dofs, dtype=torch.float64)
    out = {}
    for name, start in (("cold", np.zeros_like(warm0)), ("warm", warm0)):
        u, uf = api.solve_newtons_linear(prob.form, u_f, st.M,
                                         torch.from_numpy(start.copy()), **kw)
        assert torch.equal(uf, st.M.mv(u))
        u_j, _ = jnewton.solve_newtons_linear(
            prob_j.form, jnp.zeros(prob_j.space.n_dofs), M_j,
            jnp.asarray(start), **kw)
        out[name] = (u.numpy(), np.asarray(u_j))
    A_j = JBackgroundOperator(
        prob_j.form, prob_j.form.jacobian_blocks(
            jnp.zeros(prob_j.space.n_dofs)), M_j)
    sup = np.abs(np.asarray(A_j.diag())) > 0
    for u, u_j in out.values():
        assert np.all(u[pin] == 0.0)
        scale = max(np.abs(u_j).max(), 1.0)
        assert np.abs(u - u_j)[sup].max() <= 1e-8 * scale
    scale = max(np.abs(out["cold"][0]).max(), 1.0)
    assert np.abs(out["warm"][0] - out["cold"][0])[sup].max() <= 1e-5 * scale


def test_torch_newton_exports():
    """The solvers are importable from the solvers package and the api
    module, with the reference's signatures."""
    import inspect

    from iifea_tpu_torch import solvers

    for name in ("solve_nonlinear", "solve_newtons_linear"):
        fn, fn_j = getattr(tnewton, name), getattr(jnewton, name)
        assert getattr(solvers, name) is fn and getattr(api, name) is fn
        sig, sig_j = (inspect.signature(f).parameters for f in (fn, fn_j))
        assert list(sig) == list(sig_j)
        for k in sig:
            assert sig[k].default == sig_j[k].default, k
    assert issubclass(solvers.NonlinearSolveError, RuntimeError)
