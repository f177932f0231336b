"""The port's general assembly engine, BackgroundOperator (mv, mv_t, diag,
to_scipy, with and without trim and shift), assemble_background_system,
extraction helpers and the api module vs the JAX package, from identical
numpy state (the specs are tests/test_assembly.py,
tests/test_extraction.py and tests/test_poisson.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu import api as japi
from iifea_tpu.mesh.generators import immersed_cube_problem as j_cube
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.assembly import Form as JForm
from iifea_tpu.ops.assembly import Term as JTerm
from iifea_tpu.ops.extraction import ExtractionOperator as JExtraction
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu_torch import api
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.assembly import Form, Term
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.projection import assemble_background_system

SIZES = {2: (24, 12), 3: (8, 6)}     # (n_fg, n_bg)


def j_assemble_jit(form, M):
    """The JAX package's assemble_background_system at u = 0 as one jitted
    call (one XLA compile, ~10x faster on the CPU than op by op); the
    operator is rebuilt on the original form and M, whose host-side
    tables jit's outputs do not carry."""
    A, b = jax.jit(lambda u: j_assemble(form, u, M))(jnp.zeros(form.n_dofs))
    return JBackgroundOperator(form, A.blocks, M), b


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _build(dim):
    n_fg, n_bg = SIZES[dim]
    mesh_j, M_j = (j_square if dim == 2 else j_cube)(n_fg=n_fg, n_bg=n_bg)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10)
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu")
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    A_j, b_j = j_assemble_jit(prob_j.form, M_j)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64),
        st.M)
    return dict(mesh_j=mesh_j, M_j=M_j, prob_j=prob_j, A_j=A_j, b_j=b_j,
                st=st, prob=prob, A=A, b=b)


@pytest.fixture(scope="module")
def sys2():
    return _build(2)


@pytest.fixture(scope="module")
def sys3():
    return _build(3)


def _variants(s, rng):
    """(port operator, JAX operator) pairs: plain, trimmed, shifted, both."""
    A, A_j = s["A"], s["A_j"]
    n = A.n
    d = np.asarray(A_j.diag())
    mask = d <= 1e-3 * d.max()
    shift = rng.uniform(0.5, 1.5, n)
    tm, tm_j = torch.from_numpy(mask), jnp.asarray(mask)
    sh, sh_j = torch.from_numpy(shift), jnp.asarray(shift)
    return {
        "plain": (A, A_j),
        "trim": (A.with_trim(tm), A_j.with_trim(tm_j)),
        "shift": (A.with_shift(sh), A_j.with_shift(sh_j)),
        "trim+shift": (A.with_trim(tm).with_shift(sh),
                       A_j.with_trim(tm_j).with_shift(sh_j)),
    }


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_assemble_background_system(dim, sys2, sys3):
    s = sys2 if dim == 2 else sys3
    assert _rel(s["b"], s["b_j"]) < 1e-12
    for K, K_j in zip(s["A"].blocks, s["A_j"].blocks):
        assert K.shape == K_j.shape and _rel(K, K_j) < 1e-12
    assert s["b"].device.type == "cpu"


@pytest.mark.parametrize("dim", [2, 3])
def test_torch_background_operator(dim, sys2, sys3):
    s = sys2 if dim == 2 else sys3
    rng = np.random.default_rng(dim)
    x = rng.standard_normal(s["A"].n)
    for name, (A, A_j) in _variants(s, rng).items():
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        assert _rel(A.mv(xt), A_j.mv(xj)) < 1e-12, name
        assert _rel(A.mv_t(xt), A_j.mv_t(xj)) < 1e-12, name
        assert _rel(A.diag(chunk=37), A_j.diag(chunk=37)) < 1e-12, name
        A_sp, A_sp_j = A.to_scipy(), A_j.to_scipy()
        assert _rel(A_sp.toarray(), A_sp_j.toarray()) < 1e-12, name
        # the explicit matrix is the operator
        assert _rel(A_sp @ x, A_j.mv(xj)) < 1e-12, name


def test_torch_extraction_helpers(sys2):
    s = sys2
    M, M_j = s["st"].M, s["M_j"]
    assert _rel(M.to_scipy().toarray(), M_j.to_scipy().toarray()) == 0.0
    dom, dom_j = s["prob"].cell_dom, s["prob_j"].cell_dom
    idx, val = M.row_blocks(dom.eldofsT)
    idx_j, val_j = M_j.row_blocks(dom_j.eldofsT)
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    assert np.array_equal(val.numpy(), np.asarray(val_j))
    I = ExtractionOperator.identity(5, device="cpu")
    I_j = JExtraction.identity(5)
    assert np.array_equal(I.to_scipy().toarray(), I_j.to_scipy().toarray())
    v = np.arange(5.0)
    assert np.array_equal(I.mv(torch.from_numpy(v)).numpy(), v)


def _reaction_kernel(lib):
    """∫ ∇u·∇v + c·w·u·v − x₀ v: a kernel reading an aux field w and a
    parameter c."""
    ein = torch.einsum if lib == "torch" else jnp.einsum

    def kern(u_loc, aux_loc, ctx, params):
        U, W = u_loc[:, 0], aux_loc["w"][:, 0]
        gu = ein("qbd,b->qd", ctx.gphi, U)
        uq = ein("qb,b->q", ctx.phi, U)
        wq = ein("qb,b->q", ctx.phi, W)
        r = ein("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
        r = r + params["c"] * ein("q,q,q,qb->b", ctx.w, wq, uq ** 3, ctx.phi)
        r = r - ein("q,q,qb->b", ctx.w, ctx.x[:, 0], ctx.phi)
        return r[:, None]

    return kern


def test_torch_form_aux_params(sys2):
    s = sys2
    prob, prob_j = s["prob"], s["prob_j"]
    form = Form(prob.space, [Term(prob.cell_dom, _reaction_kernel("torch"))])
    form_j = JForm(prob_j.space, [JTerm(prob_j.cell_dom,
                                        _reaction_kernel("jax"))])
    rng = np.random.default_rng(4)
    u = rng.standard_normal(prob.space.n_dofs)
    w = rng.uniform(0.5, 2.0, prob.space.n_dofs)
    aux, aux_j = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    ut, uj = torch.from_numpy(u), jnp.asarray(u)
    K = form.jacobian_blocks(ut, aux, {"c": 0.7})
    K_j = form_j.jacobian_blocks(uj, aux_j, {"c": 0.7})
    assert _rel(K[0], K_j[0]) < 1e-12
    assert _rel(form.residual(ut, aux, {"c": 0.7}),
                form_j.residual(uj, aux_j, {"c": 0.7})) < 1e-12
    x = rng.standard_normal(prob.space.n_dofs)
    assert _rel(form.matvec_t(K, torch.from_numpy(x)),
                form_j.matvec_t(K_j, jnp.asarray(x))) < 1e-12


def test_torch_api_parity(sys2):
    s = sys2
    prob, prob_j, M, M_j = s["prob"], s["prob_j"], s["st"].M, s["M_j"]
    mesh, mesh_j = s["st"].mesh, s["mesh_j"]
    assert api.average_cell_diagonal(mesh) == pytest.approx(
        japi.average_cell_diagonal(mesh_j), rel=1e-14)
    assert np.allclose(api.cell_metric(mesh), japi.cell_metric(mesh_j),
                       rtol=1e-14)
    V = api.mixed_scalar_space(mesh)
    assert V.n_dofs == japi.mixed_scalar_space(mesh_j).n_dofs
    assert api.zero_dof_background(M).shape == (M.n_bg_dofs,)

    def expr(x, lib):
        sin = torch.sin if lib == "torch" else jnp.sin
        return (sin(2.0 * x[0]) * x[1]).reshape(1)

    u_p, u_f = api.l2_project(lambda x: expr(x, "torch"), prob.space,
                              prob.cell_dom, M)
    u_p_j, u_f_j = japi.l2_project(lambda x: expr(x, "jax"), prob_j.space,
                                   prob_j.cell_dom, M_j)
    A_sp = s["A"].to_scipy()
    alive = np.abs(A_sp.diagonal()) > 0
    scale = np.abs(np.asarray(u_p_j)).max()
    assert np.abs(u_p.numpy() - np.asarray(u_p_j))[alive].max() <= 1e-6 * scale
    assert np.allclose(api.transfer_to_foreground(u_p, M).numpy(), u_f.numpy())
    assert api.l2_norm(u_f, prob.cell_dom) == pytest.approx(
        japi.l2_norm(u_f_j, prob_j.cell_dom), rel=1e-6)


@pytest.mark.parametrize("dim,rot", [(2, False), (2, True), (3, True)])
def test_torch_generate_unfitted_mesh(dim, rot):
    from iifea_tpu_torch.mesh.generators import generate_unfitted_mesh

    mf, mb = generate_unfitted_mesh(2.0, 2.4, 6, 4, dim=dim, rotate_f=rot,
                                    rotate_b=rot)
    mf_j, mb_j = japi.generate_unfitted_mesh(2.0, 2.4, 6, 4, dim=dim,
                                             rotate_f=rot, rotate_b=rot)
    for m, m_j in ((mf, mf_j), (mb, mb_j)):
        assert np.allclose(m.coords, m_j.coords, rtol=0, atol=1e-15)
        assert np.array_equal(m.cells, m_j.cells)


def test_torch_port_front_end_imports_no_jax():
    """No module of the port imports jax or the JAX package, nor do the
    card tests and the card-side comparison scripts, which run on a machine
    without JAX."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "iifea_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    files += sorted((root / "tests").glob("test_torch_*_card.py"))
    files.append(root / "tests" / "compare_coarse_pinv.py")
    files.append(root / "tests" / "compare_determinism.py")
    files.append(root / "tests" / "torch_parallel_ranks.py")
    for name in ("ksp.py", "newton.py", "precond.py", "logging.py",
                 "sharding.py", "stencil.py", "multigrid.py",
                 "test_torch_kernels_card.py", "test_torch_solves_card.py",
                 "test_torch_parallel_card.py", "torch_parallel_ranks.py"):
        assert any(f.name == name for f in files), name
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "iifea_tpu"), (f, name)
