"""The coloured general probe (StencilOperator2D/3D.probe_multi through
BackgroundOperator.mv_multi) vs the JAX package's, and the solve_ksp
(pc='mg') routes it opens: a BFR trim mask, a diagonal shift and a stencil
radius other than 2, in 2D (cut square, n_bg=16) and 3D (cut cube,
n_bg=4), from identical numpy state. Planes to 1e-12 (f64)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_cube_problem as j_cube
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil2D
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3D
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import StencilOperator2D, StencilOperator3D
from iifea_tpu_torch.solvers.ksp import solve_ksp

SIZES = {2: (24, 16), 3: (6, 4)}     # (n_fg, n_bg)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Poisson:
    """The immersed Poisson problem in both packages, assembled at u = 0."""

    def __init__(self, dim):
        n_fg, n_bg = SIZES[dim]
        mesh_j, M_j = (j_square if dim == 2 else j_cube)(n_fg=n_fg,
                                                         n_bg=n_bg)
        prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10)
        A, self.b_j = jax.jit(lambda u: j_assemble(prob_j.form, u, M_j))(
            jnp.zeros(prob_j.form.n_dofs))
        self.A_j = JBackgroundOperator(prob_j.form, A.blocks, M_j)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=M_j.idx_np, val=M_j.val_np,
            n_bg_dofs=M_j.n_bg_dofs, device="cpu")
        self.M = st.M
        self.prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                                   device="cpu")
        self.A, self.b = assemble_background_system(
            self.prob.form,
            torch.zeros(self.prob.space.n_dofs, dtype=torch.float64), st.M)
        self.shape = (n_bg + 1,) * dim

    def solve_both(self, shift=None, **kw):
        A, A_j = self.A, self.A_j
        if shift is not None:
            A = A.with_shift(torch.from_numpy(shift))
            A_j = A_j.with_shift(jnp.asarray(shift))
        kw = dict(method="cg", pc="mg", rtol=1e-10,
                  lattice_shape=self.shape, **kw)
        x_j, info_j = j_solve_ksp(A_j, self.b_j, monitor=False, **kw)
        x, info = solve_ksp(A, self.b, monitor=False, **kw)
        assert info.converged
        return x, info.iters, np.asarray(x_j), int(info_j.iters)


@pytest.fixture(scope="module")
def systems():
    cache = {}

    def get(dim):
        if dim not in cache:
            cache[dim] = Poisson(dim)
        return cache[dim]

    return get


@pytest.mark.parametrize("dim,radius", [(2, 1), (2, 2), (2, 3), (3, 1),
                                        (3, 2)])
def test_torch_general_probe(systems, dim, radius):
    """The (2r+1)^dim-colour probe of A_b against JAX's, chunked equal to
    unchunked, and its apply against A_b's."""
    s = systems(dim)
    op, jop = ((StencilOperator2D, JStencil2D) if dim == 2
               else (StencilOperator3D, JStencil3D))
    S_j = jop.probe_multi(s.A_j.mv_multi, s.shape, radius=radius,
                          dtype=jnp.float64)
    S = op.probe_multi(s.A.mv_multi, s.shape, radius=radius,
                       dtype=torch.float64, device="cpu")
    assert _rel(S.coeffs, S_j.coeffs) < 1e-12
    S5 = op.probe_multi(s.A.mv_multi, s.shape, radius=radius,
                        dtype=torch.float64, chunk=5, device="cpu")
    # a chunk's stacked products may sum in another order: last bits only
    assert _rel(S5.coeffs, S.coeffs) < 1e-14
    # A_b couples background nodes up to 2 apart: radius ≥ 2 is exact,
    # radius 1 drops the outer ring (the probe aliases it, as JAX's does)
    if radius >= 2:
        assert S.verify(s.A.mv) < 1e-12


def test_torch_mg_trimmed_2d(systems):
    """pc='mg' with bfr_tol trimming takes the general probe: JAX's
    iterations and solution."""
    s = systems(2)
    x, it, x_j, it_j = s.solve_both(bfr_tol=1e-9)
    assert it == it_j and _rel(x, x_j) < 1e-8


def test_torch_mg_shifted_and_radius3_2d(systems):
    """pc='mg' on A + diag(shift) (pseudo-transient continuation) and with
    stencil_radius=3 (the CPU takes any radius): JAX's iterations and
    solutions."""
    s = systems(2)
    shift = np.random.default_rng(1).uniform(0.05, 0.2, s.A.n)
    x, it, x_j, it_j = s.solve_both(shift=shift)
    assert it == it_j and _rel(x, x_j) < 1e-8
    x, it, x_j, it_j = s.solve_both(stencil_radius=3)
    assert it == it_j and _rel(x, x_j) < 1e-8


def test_torch_mg_trimmed_3d(systems):
    """3D pc='mg' with trimming: the f64 residual of the trimmed system
    below rtol, and JAX's foreground field. The trimmed operator keeps the
    trimmed columns, so it is not symmetric, and the coarse Newton–Schulz
    pseudo-inverse resolves its near-null directions differently in the
    last bits: the background vectors may differ there while M x, what
    the error norms read, agrees."""
    s = systems(3)
    x, _, x_j, _ = s.solve_both(bfr_tol=1e-9)
    from iifea_tpu_torch.solvers.trim import apply_trim_rhs, trim_mask_from_diag

    mask = trim_mask_from_diag(s.A.diag(), 1e-9)
    A, b = s.A.with_trim(mask), apply_trim_rhs(s.b, mask)
    rel = torch.linalg.vector_norm(b - A.mv(x)) / torch.linalg.vector_norm(b)
    assert float(rel) < 1e-10
    n, n_j = (s.prob.error_norms(s.M.mv(torch.from_numpy(np.array(v))))
              for v in (x, x_j))
    for k in ("L2", "H10"):
        assert abs(n[k] - n_j[k]) < 1e-8 * n_j[k]
