"""The port's biharmonic (models/biharmonic.py) and its radius-3 MG-GMRES
solve through solve_ksp vs the JAX package, on the quadratic B-spline
background (the spec is tests/test_models.py::
test_bspline_biharmonic_radius3_probe_and_mg: n_fg = 32, n_bg = 15, a
17² net), and the demo and the refusals of the card paths."""
import contextlib
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import (
    immersed_square_bspline_problem as j_bspline_square,
)
from iifea_tpu.models.biharmonic import BiharmonicProblem as JBiharmonic
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos import biharmonic as demo
from iifea_tpu_torch.mesh.generators import immersed_square_bspline_problem
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import StencilOperator2D
from iifea_tpu_torch.solvers import ksp
from iifea_tpu_torch.solvers.ksp import solve_ksp

N_FG, N_BG = 32, 15


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Pair:
    """Both packages' biharmonic system at u = 0 on the same net."""

    def __init__(self):
        mesh_j, self.M_j, self.shape = j_bspline_square(n_fg=N_FG, n_bg=N_BG)
        self.prob_j = JBiharmonic(mesh_j)
        form_j = self.prob_j.form
        A, self.b_j = jax.jit(lambda u: j_assemble(form_j, u, self.M_j))(
            jnp.zeros(form_j.n_dofs))
        self.A_j = JBackgroundOperator(form_j, A.blocks, self.M_j)
        mesh, self.M, shape = immersed_square_bspline_problem(
            n_fg=N_FG, n_bg=N_BG, device="cpu")
        assert tuple(shape) == tuple(self.shape)
        self.prob = BiharmonicProblem(mesh, device="cpu")
        self.A, self.b = assemble_background_system(
            self.prob.form,
            torch.zeros(self.prob.space.n_dofs, dtype=torch.float64), self.M)

    def norms(self, u):
        return self.prob.error_norms(self.M.mv(u))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_torch_biharmonic_model(pair):
    """Cell and facet residuals and Jacobians at a random foreground state,
    b = −Mᵀr at u = 0, the small-cell filter and the error norms."""
    u = np.random.default_rng(0).standard_normal(pair.prob.space.n_dofs)
    ut, uj = torch.from_numpy(u), jnp.asarray(u)
    assert pair.prob.elim_counts == pair.prob_j.elim_counts
    assert pair.prob.cell_dom.n_elem == pair.prob_j.cell_dom.n_elem
    assert pair.prob.facet_dom.n_elem == pair.prob_j.facet_dom.n_elem
    blocks_j, res_j = jax.jit(pair.prob_j.form.jacobian_and_residual)(uj)
    blocks, res = pair.prob.form.jacobian_and_residual(ut)
    for K, K_j in zip(blocks, blocks_j):
        assert _rel(K, K_j) < 1e-12
    assert _rel(res, res_j) < 1e-12
    assert _rel(pair.b, pair.b_j) < 1e-12
    n, n_j = pair.prob.error_norms(ut), pair.prob_j.error_norms(uj)
    for k in n_j:
        assert abs(n[k] - n_j[k]) <= 1e-12 * n_j[k]


def test_torch_biharmonic_radius3_probe(pair):
    """The 49-colour probe of A.mv_multi equals A.mv (1e-12, the JAX
    test's criterion) and JAX's radius-3 planes; a JAX radius-3 operator
    carried across by ``convert`` applies the same."""
    S = StencilOperator2D.probe_multi(pair.A.mv_multi, pair.shape, radius=3,
                                      dtype=torch.float64, device="cpu")
    x = np.random.default_rng(1).standard_normal(pair.M.n_bg_dofs)
    ax = pair.A.mv(torch.from_numpy(x))
    assert float(torch.linalg.vector_norm(S.mv(torch.from_numpy(x)) - ax)) \
        < 1e-12 * float(torch.linalg.vector_norm(ax))
    S_j = JStencil.probe_multi(pair.A_j.mv_multi, pair.shape, radius=3,
                               dtype=jnp.float64)
    assert _rel(S.coeffs, S_j.coeffs) < 1e-12
    st = from_numpy_state(coeffs=np.asarray(S_j.coeffs),
                          lattice_shape=S_j.shape, radius=S_j.radius,
                          idx=pair.M_j.idx_np, val=pair.M_j.val_np,
                          n_bg_dofs=pair.M_j.n_bg_dofs, device="cpu")
    assert st.S.radius == 3 and _rel(st.S.mv(torch.from_numpy(x)), ax) \
        < 1e-12
    assert torch.equal(st.M.idxT, pair.M.idxT)
    assert _rel(st.M.valT, pair.M.valT) == 0.0


@pytest.mark.parametrize("mixed", [False, True])
def test_torch_biharmonic_mg_gmres(pair, mixed):
    """solve_ksp(gmres, mg, stencil_radius=3): the f64 route takes JAX's
    iteration count within 2 and both routes land on host LU's L2_rel
    within 2e-2 (the JAX test's yardstick); the f64 route also on JAX's
    solution's."""
    kw = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=pair.shape,
              stencil_radius=3)
    x, info = solve_ksp(pair.A, pair.b, monitor=False, mixed=mixed, **kw)
    r = pair.b - pair.A.mv(x)
    assert float(torch.linalg.vector_norm(r)) < 1e-10 * float(
        torch.linalg.vector_norm(pair.b))
    u_lu, _ = solve_ksp(pair.A, pair.b, method="direct")
    n, n_lu = pair.norms(x), pair.norms(u_lu)
    assert abs(n["L2_rel"] - n_lu["L2_rel"]) < 2e-2 * n_lu["L2_rel"]
    if not mixed:
        x_j, info_j = j_solve_ksp(pair.A_j, pair.b_j, monitor=False, **kw)
        n_j = pair.prob_j.error_norms(pair.M_j.mv(x_j))
        assert abs(info.iters - int(info_j.iters)) <= 2
        assert abs(n["L2_rel"] - n_j["L2_rel"]) < 2e-2 * n_j["L2_rel"]


def test_torch_biharmonic_demo():
    """The demo at --ref 0 (n_bg = 15, nested grids) on the host: its
    printed norms are the problem's, and the MG-GMRES solve meets 1e-10.
    ``--dim 3`` runs: with ``--mms steep`` (the wavelength-2 cosines in
    the problem's dimension, the reference's own 3D solution) at --ref 0
    it lands on the reference run's recorded L2_rel (studies/
    biharmonic_synthetic.jsonl, "--dim 3 --ref 0"). A mesh root without
    the files exits naming the missing path."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = demo.main(["--ref", "0", "--device", "cpu"])
    assert res["info"].converged
    assert f"relative L2 norm: {res['norms']['L2_rel']}" in out.getvalue()
    assert 0 < res["norms"]["L2_rel"] < 1e-4
    with contextlib.redirect_stdout(io.StringIO()):
        res3 = demo.main(["--dim", "3", "--ref", "0", "--mms", "steep",
                          "--device", "cpu"])
    assert res3["info"].converged
    assert abs(res3["norms"]["L2_rel"] - 0.1428220610425672) <= \
        1e-8 * 0.1428220610425672
    with pytest.raises(SystemExit,
                       match="no /nowhere/square/Quadratic/R3/mesh.xdmf"):
        demo.main(["--mesh-root", "/nowhere", "--device", "cpu"])


def test_torch_biharmonic_card_refusals(monkeypatch):
    """The card's kernels take every MG configuration of the JAX package's
    models: 2D and 3D, 1 to 3 fields, every radius (the runtime-radius
    instances from 5, a quartic or higher B-spline background), f32 and
    f64. What they do not take is refused before any work: a 2D radius
    past the tile a block can stage (41 in f64 with three fields), a
    radius below 1 and a dtype other than f32 and f64; solve_ksp raises it
    for a system on a card (mocked: no operator is touched)."""
    f32, f64 = torch.float32, torch.float64
    monkeypatch.setattr(ksp, "_on_card", lambda t: True)
    with pytest.raises(ValueError, match="radius 1 to 41"):
        solve_ksp(None, torch.zeros(3 * 17 ** 2, dtype=f64), method="gmres",
                  pc="mg", lattice_shape=(17, 17), stencil_radius=42,
                  n_fields=3, monitor=False)
    with pytest.raises(ValueError, match="float16"):
        solve_ksp(None, torch.zeros(9 ** 3, dtype=torch.float16),
                  method="cg", pc="mg", lattice_shape=(9, 9, 9),
                  mixed=False, monitor=False)
    for shape in ((17, 17), (9, 9, 9)):
        for n_fields in (1, 2, 3):
            for radius in (1, 2, 3, 4, 5, 6):
                for dt in (f32, f64):
                    assert ksp._cuda_mg_refusal(shape, n_fields, radius,
                                                dt) is None
    for args, kind, word in [(((17, 17), 1, 78, f64), ValueError,
                              "radius 1 to 77"),
                             (((9, 9, 9), 3, 0, f32), ValueError,
                              ">= 1"),
                             (((17, 17), 2, 2, torch.float16), ValueError,
                              "float16"),
                             (((9, 9, 9), 1, 3, torch.bfloat16), ValueError,
                              "bfloat16")]:
        err = ksp._cuda_mg_refusal(*args)
        assert isinstance(err, kind) and word in str(err)
