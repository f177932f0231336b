"""The port's solves on a card against its own host runs: ``solve_ksp(pc=
'mg')`` for scalar 2D (CG, GMRES; mixed and f64), 2D and 3D elasticity
(the block kernels), the single-level 3D case whose coarse inverse is the
whole preconditioner, the biharmonic (radius 3, f64 and mixed; 2D, and
3D at n_bg = 7, 15),
``pc='asm'``, ``solve_nonlinear(linear_pc='mg')``, one Taylor-Green
time step through the demo (three-field block MG) and the pinned
Kirchhoff-Love shell demo at --ref 1. Every case skips
without a CUDA device.

The file imports nothing of JAX, so it also runs on a machine that has a
card and no JAX, without the package's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_solves_card.py -q
"""
import pytest
import torch

from iifea_tpu_torch.api import l2_norm
from iifea_tpu_torch.mesh.core import FunctionSpace
from iifea_tpu_torch.mesh.generators import (
    immersed_cube_bspline_problem,
    immersed_cube_problem,
    immersed_square_bspline_problem,
    immersed_square_problem,
)
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.assembly import Form, Term, build_cell_domain
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.solvers import solve_ksp, solve_nonlinear
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return "cuda"


def _system(gen, model, device, n_fg, n_bg, n_fields=1, **kw):
    mesh, M = gen(n_fg=n_fg, n_bg=n_bg, n_fields=n_fields, device=device)
    prob = model(mesh, k=1, device=device, **kw)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=device), M)
    return prob, M, A, b


def _supported_agree(x, x_ref, A_ref, rel=1e-6):
    d = A_ref.diag().abs()
    sup = d > 1e-3 * d.max()
    return float((x.cpu() - x_ref)[sup].abs().max()) <= rel * float(
        x_ref[sup].abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_torch_solve_ksp_mg_on_card(method):
    """On a CUDA operator pc='mg' runs the mixed route with the Krylov
    matvec on the stencil_mv kernel and reproduces the host's f64 MG
    solution on supported dofs; mixed=False is refused there."""
    dev = _card()
    kw = dict(sym=True, beta_value=10)
    _, _, A, b = _system(immersed_square_problem, PoissonProblem, dev, 48,
                         32, **kw)
    _, _, A_h, b_h = _system(immersed_square_problem, PoissonProblem, "cpu",
                             48, 32, **kw)
    solve = dict(method=method, pc="mg", rtol=1e-10, lattice_shape=(33, 33),
                 monitor=False)
    x_ref, _ = solve_ksp(A_h, b_h, **solve)
    sk.reset_launches()
    x, info = solve_ksp(A, b, **solve)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged
    assert sk.stencil_mv.launches > 0
    assert _supported_agree(x, x_ref, A_h)
    # mixed=False runs the f64 instances of the same kernels
    sk.reset_launches()
    x64, info64 = solve_ksp(A, b, mixed=False, **solve)
    torch.cuda.synchronize()
    assert x64.is_cuda and info64.converged and sk.stencil_mv.launches > 0
    assert _supported_agree(x64, x_ref, A_h)


@pytest.mark.gpu
def test_torch_elasticity_mg_on_card():
    """On a CUDA operator the 2D block MG route runs the mixed f32 passes
    with every block apply and smoothing call on the block kernels, and
    reproduces host LU's error norms; radius 3 is refused there."""
    dev = _card()
    prob, M, A, b = _system(immersed_square_problem,
                            ImmersedElasticityProblem, dev, 32, 16, 2)
    solve = dict(method="cg", pc="mg", lattice_shape=(17, 17), n_fields=2,
                 monitor=False)
    sk.reset_launches()
    x, info = solve_ksp(A, b, rtol=1e-11, **solve)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged
    assert sk.stencil_mv_block.launches > 0 and sk.smooth.launches > 0
    n = prob.error_norms(M.mv(x))
    n_lu = prob.error_norms(M.mv(solve_ksp(A, b, method="direct")[0]))
    for k in ("L2", "H10"):
        assert abs(n[k] - n_lu[k]) < 1e-8 * n_lu[k]
    with pytest.raises(NotImplementedError, match="item 14"):
        solve_ksp(A, b, stencil_radius=3, **solve)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bg", [8, 16])
def test_torch_elasticity3d_mg_on_card(n_bg):
    """3D three-field elasticity through pc='mg' on the card: every block
    apply, residual and sweep a launch of the 3D block kernel (n_bg=8 is
    one dense 9³ level: applies only), host LU's error norms to 1e-8."""
    dev = _card()
    prob, M, A, b = _system(immersed_cube_problem, ImmersedElasticityProblem,
                            dev, 2 * n_bg, n_bg, 3)
    sk.reset_launches()
    x, info = solve_ksp(A, b, method="cg", pc="mg", rtol=1e-10,
                        lattice_shape=(n_bg + 1,) * 3, n_fields=3,
                        monitor=False)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged and info.iters < 60
    block = sum(sk.launches()[k] for k in ("stencil3d_block", "zero3_block",
                                           "sweep3_block", "residual3_block"))
    assert block > info.iters * (1 if n_bg == 8 else 5)
    n = prob.error_norms(M.mv(x))
    n_lu = prob.error_norms(M.mv(solve_ksp(A, b, method="direct")[0]))
    for k in ("L2", "H10"):
        assert abs(n[k] - n_lu[k]) < 1e-8 * n_lu[k]


@pytest.mark.gpu
def test_torch_single_level_coarse_inverse_on_card():
    """3D Poisson n_bg=8 is one 9³ level, so the dense Newton–Schulz coarse
    inverse is the whole preconditioner: the card's f32 MG-PCG iteration
    count stays within 2x of the host's (the f32 iteration took ~900 there
    against 32)."""
    dev = _card()
    info = {}
    for d in ("cpu", dev):
        mesh, M = immersed_cube_problem(n_fg=10, n_bg=8, device=d)
        prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=d)
        _, info[d] = BinnedLatticeSolver(prob, M, (9, 9, 9),
                                         device=d).solve(rtol=1e-10)
    assert info[dev]["rel_residual"] < 1e-10
    assert info[dev]["cg_iters"] <= 2 * max(info["cpu"]["cg_iters"], 32)


@pytest.mark.gpu
def test_torch_asm_on_card():
    """pc='asm' on the card: the host's GMRES iteration count (the patch
    tables are the same), the residual, fewer iterations than Jacobi."""
    dev = _card()
    kw = dict(sym=True, beta_value=10)
    _, _, A, b = _system(immersed_square_problem, PoissonProblem, dev, 48,
                         24, **kw)
    _, _, A_h, b_h = _system(immersed_square_problem, PoissonProblem, "cpu",
                             48, 24, **kw)
    solve = dict(method="gmres", rtol=1e-10, monitor=False)
    x, info = solve_ksp(A, b, pc="asm", **solve)
    _, info_h = solve_ksp(A_h, b_h, pc="asm", **solve)
    _, info_j = solve_ksp(A, b, pc="jacobi", **solve)
    assert x.is_cuda and info.converged
    assert abs(info.iters - info_h.iters) <= 1 and info.iters < info_j.iters
    assert float(torch.linalg.vector_norm(b - A.mv(x))) <= 1.5e-10 * float(
        torch.linalg.vector_norm(b))


def _diffusion_form(mesh, device):
    """−∇·((1 + u²)∇u) + u = 1 on the cut square, no boundary term."""
    V = FunctionSpace(mesh, degree=1, n_fields=1)

    def kern(u_loc, aux_loc, ctx, params):
        uq = torch.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        r = torch.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq ** 2, gu, ctx.gphi)
        r = r + torch.einsum("q,q,qb->b", ctx.w, uq - 1.0, ctx.phi)
        return r[:, None]

    cells = (mesh.material == 2).nonzero()[0]
    return Form(V, [Term(build_cell_domain(V, cells, 3, device=device),
                         kern)])


@pytest.mark.gpu
def test_torch_newton_mg_on_card():
    """solve_nonlinear(linear_pc='mg') on the card: every Newton step's
    linear solve on the stencil kernels, and the host run's foreground
    field over the block in L2 to 1e-5 relative (the form has no boundary
    term: background dofs outside the block are determined only in
    combination)."""
    dev = _card()
    out = {}
    for d in ("cpu", dev):
        mesh, M = immersed_square_problem(n_fg=96, n_bg=64, device=d)
        form = _diffusion_form(mesh, d)
        u0 = torch.zeros(M.n_bg_dofs, dtype=torch.float64, device=d)
        sk.reset_launches()
        u_p, u_f = solve_nonlinear(
            form, M.mv(u0), M, u0, max_iters=30, relative_tolerance=1e-8,
            monitor_newton=False, linear_method="cg", linear_pc="mg",
            lattice_shape=(65, 65))
        out[d] = (u_p, form, M, u_f)
    assert out[dev][0].is_cuda and sk.launches()["smooth"] > 0
    _, form, _, u_f = out["cpu"]
    dom = form.terms[0][0]
    diff = l2_norm(out[dev][3].cpu() - u_f, dom) / l2_norm(u_f, dom)
    assert diff <= 1e-5


def _biharmonic(device, n_bg):
    mesh, M, shape = immersed_square_bspline_problem(n_fg=2 * n_bg,
                                                     n_bg=n_bg, device=device)
    prob = BiharmonicProblem(mesh, device=device)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=device), M)
    return prob, M, shape, A, b


@pytest.mark.gpu
@pytest.mark.parametrize("n_bg", [15, 63])
def test_torch_biharmonic_mg_on_card(n_bg):
    """solve_ksp(gmres, mg, stencil_radius=3) on the card: the f64 route by
    default (the radius-3 f64 kernel instances) with the host's iteration
    count within 2 and its solution to 1e-8 in L2 over the cell domain;
    the f32-mixed route converges too; radius 3 with several fields is
    refused."""
    dev = _card()
    prob, M, shape, A, b = _biharmonic(dev, n_bg)
    prob_h, M_h, _, A_h, b_h = _biharmonic("cpu", n_bg)
    solve = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=shape,
                 stencil_radius=3, monitor=False)
    x_h, info_h = solve_ksp(A_h, b_h, **solve)
    sk.reset_launches()
    x, info = solve_ksp(A, b, **solve)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged and abs(info.iters - info_h.iters) <= 2
    assert sk.stencil_mv.launches > 0
    # a 17² net is one level (its dense inverse); 65² smooths 65² and 33²
    assert (sk.jacobi_smooth.launches + sk.smooth.launches > 0) == (n_bg > 15)
    u_h = M_h.mv(x_h)
    diff = l2_norm(M.mv(x).cpu() - u_h, prob_h.cell_dom)
    assert diff <= 1e-8 * l2_norm(u_h, prob_h.cell_dom)
    x32, info32 = solve_ksp(A, b, mixed=True, **solve)
    r = b - A.mv(x32)
    assert info32.converged and float(torch.linalg.vector_norm(r)) < 1e-10 * \
        float(torch.linalg.vector_norm(b))
    with pytest.raises(NotImplementedError, match="14c"):
        solve_ksp(None, torch.zeros(2 * 17 ** 2, dtype=torch.float64,
                                    device=dev),
                  **{**solve, "lattice_shape": (17, 17)}, n_fields=2)


def _biharmonic3(device, n_bg):
    mesh, M, shape = immersed_cube_bspline_problem(n_fg=2 * n_bg, n_bg=n_bg,
                                                   device=device)
    prob = BiharmonicProblem(mesh, device=device)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=device), M)
    return prob, M, shape, A, b


@pytest.mark.gpu
@pytest.mark.parametrize("n_bg", [7, 15])
def test_torch_biharmonic3d_mg_on_card(n_bg):
    """The 3D biharmonic (``demos/biharmonic.py --dim 3``'s problem): on the
    card solve_ksp(gmres, mg, stencil_radius=3) runs the radius-3 f64
    instances of the 3D kernels, with the host's iteration count within 2
    and its error norms to 1e-6 relative; a 9³ net is one dense level, a
    17³ net smooths 17³ on the kernels."""
    dev = _card()
    prob, M, shape, A, b = _biharmonic3(dev, n_bg)
    prob_h, M_h, _, A_h, b_h = _biharmonic3("cpu", n_bg)
    solve = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=shape,
                 stencil_radius=3, monitor=False)
    x_h, info_h = solve_ksp(A_h, b_h, **solve)
    sk.reset_launches()
    x, info = solve_ksp(A, b, **solve)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged and abs(info.iters - info_h.iters) <= 2
    assert sk.stencil_mv3.launches > 0
    # the 17³ level smooths as Chebyshev passes or in one smooth3 launch a
    # call, as the plan routes it
    assert (sk.launches()["cheb_step3"] + sk.smooth3.launches > 0) == (
        n_bg > 7)
    n, n_h = prob.error_norms(M.mv(x)), prob_h.error_norms(M_h.mv(x_h))
    for k in ("L2_rel", "H1_rel", "H2_rel"):
        assert abs(n[k] - n_h[k]) <= 1e-6 * n_h[k], k


@pytest.mark.gpu
def test_torch_tg_step_on_card():
    """Two Taylor-Green time steps of the demo at ref 2 with --pc mg and the
    pressure pinned, on the card (the three-field kernel instances) and on
    the host: the same step count, error norms within 1e-6 relative (the
    card's MG-GMRES runs in f32 refined to the same f64 tolerance)."""
    import contextlib
    import io

    from iifea_tpu_torch.demos import tg_vortex

    dev = _card()
    argv = ["--ref", "2", "--T", "0.17", "--mesh-root", "synthetic",
            "--pc", "mg", "--pin-pressure", "True"]
    out = {}
    for d in ("cpu", dev):
        sk.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            out[d] = tg_vortex.main(argv + ["--device", d])
    launched = sk.launches()
    assert out[dev]["up_f"].is_cuda and out[dev]["n_steps"] == 2
    assert launched["jacobi_smooth"] + launched["smooth"] > 0
    assert launched["stencil_mv_block"] > 0
    for k, v in out["cpu"]["norms"].items():
        assert abs(out[dev]["norms"][k] - v) <= 1e-6 * v, k


@pytest.mark.gpu
def test_torch_pinned_shell_on_card():
    """The pinned Kirchhoff-Love shell demo at --ref 1 on the card (element
    Hessians assembled on the device, host LU) and on the host: the same
    Newton iterations, the centre displacement to 1e-8 relative."""
    import contextlib
    import io

    from iifea_tpu_torch.demos.background_unfitted import (
        pinned_shell_unfitted as demo,
    )

    dev = _card()
    out = {}
    for d in ("cpu", dev):
        with contextlib.redirect_stdout(io.StringIO()):
            out[d] = demo.main(["--ref", "1", "--device", d])
    assert out[dev]["u_f"].is_cuda
    assert out[dev]["newton_iters"] == out["cpu"]["newton_iters"]
    z, z_host = out[dev]["disp"][2], out["cpu"]["disp"][2]
    assert abs(z - z_host) <= 1e-8 * abs(z_host)
