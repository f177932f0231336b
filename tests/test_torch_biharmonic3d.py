"""The port's 3D biharmonic (radius-3 3D stencils) vs the JAX package: the
r = 3 plain versions of the 3D stencil kernels, the 343-colour probe of the
cube at n_bg = 7 (``demos/biharmonic.py --dim 3 --ref 0``: a 9³ quadratic
B-spline net), ``solve_ksp(gmres, pc='mg', stencil_radius=3)`` against
JAX's iterations and norms and against the reference's recorded norms, the
radius-3 3D hierarchy on a seeded two-level 17³ operator, the demo, and
the device routing of ``StencilOperator3D``."""
import contextlib
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import (
    immersed_cube_bspline_problem as j_bspline_cube,
)
from iifea_tpu.models.biharmonic import BiharmonicProblem as JBiharmonic
from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos import biharmonic as demo
from iifea_tpu_torch.mesh.generators import immersed_cube_bspline_problem
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import StencilOperator3D
from iifea_tpu_torch.solvers.ksp import solve_ksp

N_BG = 7                     # demos/biharmonic.py --dim 3 --ref 0
# the JAX package's row for that demo run (f64, gmres+mg on a CPU):
# studies/biharmonic_synthetic.jsonl, "--dim 3 --ref 0", nested grids
REF0_NORMS = {"L2_rel": 0.1428220610425672, "H1_rel": 0.12418013668221375,
              "H2_rel": 0.2746447425956136}
KW = dict(method="gmres", pc="mg", rtol=1e-10, stencil_radius=3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Pair:
    """Both packages' 3D biharmonic system at u = 0 on the n_bg = 7 net."""

    def __init__(self):
        mesh_j, self.M_j, self.shape = j_bspline_cube(n_fg=2 * N_BG,
                                                      n_bg=N_BG)
        self.prob_j = JBiharmonic(mesh_j)
        form_j = self.prob_j.form
        A, self.b_j = jax.jit(lambda u: j_assemble(form_j, u, self.M_j))(
            jnp.zeros(form_j.n_dofs))
        self.A_j = JBackgroundOperator(form_j, A.blocks, self.M_j)
        mesh, self.M, shape = immersed_cube_bspline_problem(
            n_fg=2 * N_BG, n_bg=N_BG, device="cpu")
        assert tuple(shape) == tuple(self.shape)
        self.prob = BiharmonicProblem(mesh, device="cpu")
        self.A, self.b = assemble_background_system(
            self.prob.form,
            torch.zeros(self.prob.space.n_dofs, dtype=torch.float64), self.M)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_torch_stencil3d_radius3_plain(dtype, tol):
    """The r = 3 3D plain versions (apply, Jacobi sweep, Chebyshev step with
    β = 0 and β ≠ 0) in f32 and f64 against JAX's StencilOperator3D.mv_ref,
    its jacobi_smooth and the Chebyshev step of its V-cycle, at an odd
    shape; the 3D kernel wrappers take these instances on the host."""
    shape = (9, 11, 13)
    n = 9 * 11 * 13
    rng = np.random.default_rng(21)
    C = rng.standard_normal((343, *shape)).astype(dtype)
    x, b, d = (rng.standard_normal(n).astype(dtype) for _ in range(3))
    invd = rng.uniform(0.5, 2.0, n).astype(dtype)
    S_j = JStencil3(jnp.asarray(C), shape, 3)
    Ct, xt, bt, dt, it = map(torch.from_numpy, (C, x, b, d, invd))
    y_j = S_j.mv_ref(jnp.asarray(x))
    assert _rel(sk.stencil_mv3(Ct, xt, shape, 3), y_j) < tol
    assert _rel(StencilOperator3D(Ct, shape, 3).mv(xt), y_j) < tol
    s_j = S_j.jacobi_smooth(S_j.pad_volume(jnp.asarray(invd)),
                            S_j.pad_volume(jnp.asarray(b)), jnp.asarray(x),
                            0.67)
    assert _rel(sk.jacobi_smooth3(Ct, it, bt, xt, 0.67, shape, 3), s_j) < tol
    # JAX's Chebyshev step: r = invd·(b − A x), d' = ρ'(2r/δ + ρ d)
    r_j = jnp.asarray(invd) * (jnp.asarray(b) - y_j)
    for d_in, alpha, beta in ((None, 1.7, 0.0), (dt, 1.3, 0.45)):
        d_ref = alpha * r_j + (0.0 if d_in is None else beta * jnp.asarray(d))
        x1, d1 = sk.cheb_step3(Ct, it, bt, xt, None if d_in is None
                               else d_in.clone(), alpha, beta, shape, 3)
        assert _rel(d1, d_ref) < tol
        assert _rel(x1, jnp.asarray(x) + d_ref) < tol


def test_torch_stencil3d_routing_refuses(monkeypatch):
    """StencilOperator3D routes by device: on the host an f64 operator at
    radius 2 runs the plain version; on a card (the device check mocked)
    every apply and sweep goes to the kernel wrappers, which take f64 at
    every radius from 1 (given CPU tensors they run their plain versions;
    radius 5 the runtime-radius instances' plain version) and refuse what
    no instance takes: another dtype, radius 0."""
    shape = (5, 6, 7)
    rng = np.random.default_rng(4)
    C = torch.from_numpy(rng.standard_normal((125, *shape)))
    x, b, invd = (torch.from_numpy(rng.standard_normal(210))
                  for _ in range(3))
    S = StencilOperator3D(C, shape, 2)
    assert torch.equal(S.mv(x), sk.stencil_mv3_plain(C, x, shape, 2))
    monkeypatch.setattr(StencilOperator3D, "device",
                        property(lambda self: torch.device("cuda")))
    called = []
    for name in ("stencil_mv3", "jacobi_smooth3", "smooth3"):
        monkeypatch.setattr(sk, name, (lambda f, n: lambda *a, **k: (
            called.append(n), f(*a, **k))[1])(getattr(sk, name), name))
    assert torch.equal(S.mv(x), sk.stencil_mv3_plain(C, x, shape, 2))
    assert torch.equal(S.jacobi_smooth(invd, b, x, 0.67),
                       sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape,
                                               2))
    assert torch.equal(S.smooth(invd, b, x, [(1.0, 0.0)], cheb=True),
                       sk.smooth3_plain(C, invd, b, x, [(1.0, 0.0)], shape,
                                        2, cheb=True))
    assert called == ["stencil_mv3", "jacobi_smooth3", "smooth3"]
    S16 = StencilOperator3D(C.half(), shape, 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        S16.mv(x.half())
    C5 = torch.from_numpy(rng.standard_normal((1331, *shape)))
    assert torch.equal(sk.stencil_mv3(C5, x, shape, 5),
                       sk.stencil_mv3_plain(C5, x, shape, 5))
    with pytest.raises(ValueError, match=">= 1"):
        sk.stencil_mv3(torch.zeros((1, *shape)), torch.zeros(210), shape, 0)


def test_torch_biharmonic3d_probe(pair):
    """The 343-colour probe of A.mv_multi equals A.mv (1e-12) and JAX's
    radius-3 planes (1e-12); JAX's operator carried across by ``convert``
    applies the same."""
    S = StencilOperator3D.probe_multi(pair.A.mv_multi, pair.shape, radius=3,
                                      dtype=torch.float64, device="cpu")
    x = np.random.default_rng(1).standard_normal(pair.M.n_bg_dofs)
    ax = pair.A.mv(torch.from_numpy(x))
    assert float(torch.linalg.vector_norm(S.mv(torch.from_numpy(x)) - ax)) \
        < 1e-12 * float(torch.linalg.vector_norm(ax))
    S_j = JStencil3.probe_multi(pair.A_j.mv_multi, pair.shape, radius=3,
                                dtype=jnp.float64)
    assert _rel(S.coeffs, S_j.coeffs) < 1e-12
    st = from_numpy_state(coeffs=np.asarray(S_j.coeffs),
                          lattice_shape=S_j.shape, radius=S_j.radius,
                          device="cpu")
    assert isinstance(st.S, StencilOperator3D) and st.S.radius == 3
    assert _rel(st.S.mv(torch.from_numpy(x)), ax) < 1e-12


def test_torch_biharmonic3d_mg_gmres(pair):
    """solve_ksp(gmres, pc='mg', stencil_radius=3) on the cube: JAX's
    iteration count within 2, its norms within 1e-8 relative, and the
    reference run's recorded L2_rel (the JAX package's own row)."""
    x, info = solve_ksp(pair.A, pair.b, monitor=False,
                        lattice_shape=pair.shape, **KW)
    r = pair.b - pair.A.mv(x)
    assert float(torch.linalg.vector_norm(r)) < 1e-10 * float(
        torch.linalg.vector_norm(pair.b))
    x_j, info_j = j_solve_ksp(pair.A_j, pair.b_j, monitor=False,
                              lattice_shape=pair.shape, **KW)
    n = pair.prob.error_norms(pair.M.mv(x))
    n_j = pair.prob_j.error_norms(pair.M_j.mv(x_j))
    assert abs(info.iters - int(info_j.iters)) <= 2
    for k in ("L2_rel", "H1_rel", "H2_rel"):
        assert abs(n[k] - n_j[k]) <= 1e-8 * n_j[k], k
        assert abs(n[k] - REF0_NORMS[k]) <= 1e-8 * REF0_NORMS[k], k


def test_torch_multigrid3d_radius3():
    """``_coarsen3`` at radius 3 and one V-cycle (Chebyshev smoothing on the
    r = 3 sweeps, the 9³ dense coarse level) on a seeded two-level 17³
    operator carried across by ``convert``, against JAX (1e-10); the two
    cycles are given the same coarse pseudo-inverse, as in
    test_torch_multigrid3d.py."""
    shape = (17, 17, 17)
    rng = np.random.default_rng(17)
    C = rng.uniform(-0.02, 0.02, (343, *shape))
    C[171] += 4.0
    S_j = JStencil3(jnp.asarray(C), shape, 3)
    S_t = from_numpy_state(coeffs=np.asarray(S_j.coeffs), lattice_shape=shape,
                           radius=3, device="cpu").S
    assert _rel(tmg._coarsen3(S_t).coeffs, jmg._coarsen3(S_j).coeffs) < 1e-10
    mg_j, mg_t = jmg.StencilMultigrid3D(S_j), tmg.StencilMultigrid3D(S_t)
    assert [lv.shape for lv in mg_t.levels] == [shape, (9, 9, 9)]
    mg_t.coarse_inv = torch.from_numpy(np.array(mg_j.coarse_inv))
    r = rng.standard_normal(S_t.n)
    assert _rel(mg_t.minv(torch.from_numpy(r)), mg_j.minv(jnp.asarray(r))) \
        < 1e-10


def test_torch_biharmonic3d_demo():
    """``demos.biharmonic --dim 3 --ref 0 --device cpu`` (n_bg = 7): the
    printed norms are the problem's and equal the reference run's row to
    1e-8, and the MG-GMRES solve meets 1e-10."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = demo.main(["--dim", "3", "--ref", "0", "--device", "cpu"])
    assert res["info"].converged
    assert f"relative L2 norm: {res['norms']['L2_rel']}" in out.getvalue()
    for k, v in REF0_NORMS.items():
        assert abs(res["norms"][k] - v) <= 1e-8 * v, k
