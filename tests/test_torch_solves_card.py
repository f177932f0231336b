"""The port's solves on a card against its own host runs: ``solve_ksp(pc=
'mg')`` for scalar 2D (CG, GMRES), 2D and 3D elasticity (the block
kernels), the single-level 3D case whose coarse inverse is the whole
preconditioner, ``pc='asm'`` and ``solve_nonlinear(linear_pc='mg')``. Every
case skips without a CUDA device.

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
    immersed_cube_problem,
    immersed_square_problem,
)
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
    with pytest.raises(ValueError, match="f32 stencil kernels"):
        solve_ksp(A, b, mixed=False, **{**solve, "rtol": 1e-8})


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
    apply, residual and sweep a stencil3d_block launch (n_bg=8 is one
    dense 9³ level: applies only), host LU's error norms to 1e-8."""
    dev = _card()
    prob, M, A, b = _system(immersed_cube_problem, ImmersedElasticityProblem,
                            dev, 2 * n_bg, n_bg, 3)
    sk.reset_launches()
    x, info = solve_ksp(A, b, method="cg", pc="mg", rtol=1e-10,
                        lattice_shape=(n_bg + 1,) * 3, n_fields=3,
                        monitor=False)
    torch.cuda.synchronize()
    assert x.is_cuda and info.converged and info.iters < 60
    assert sk.stencil3d_block.launches > info.iters * (1 if n_bg == 8 else 5)
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
