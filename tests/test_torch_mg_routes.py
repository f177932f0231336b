"""The multigrid routes added for the card's f64 and radius-3 configurations,
against the JAX package on the CPU from the same numpy inputs:

* every new kernel instance (2D and 3D block operators in f64 at radius
  1–3 and in f32 at radius 3, for 2 and 3 fields; 3D scalar operators in
  f64 at radius 1, 2) through its wrapper on CPU tensors (the plain
  version) against JAX's ``StencilOperatorBlock2D/3D.mv`` and
  ``StencilOperator3D.mv``, and the port's multigrid smoothing call with
  its residual against JAX's ``_smooth``: f64 to 1e-12, f32 to 1e-4;
* ``solve_ksp(gmres, pc='mg', stencil_radius=3, n_fields=2)`` on vector
  elasticity (k = 2) over the quadratic B-spline background at n_bg = 15
  (radius 3 with several fields): iterations within 2, L2 and H10 within
  1e-5 relative.

The CUDA instances are held against these plain versions on a card by
``tests/test_torch_kernels_card.py`` and ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import (
    immersed_square_bspline_problem as j_bspline_square,
)
from iifea_tpu.models.elasticity import (
    ImmersedElasticityProblem as JElasticity,
)
from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.ops.stencil import StencilOperatorBlock2D as JBlock2
from iifea_tpu.ops.stencil import StencilOperatorBlock3D as JBlock3
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.mesh.generators import immersed_square_bspline_problem
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.ops.stencil import (
    StencilOperator3D,
    StencilOperatorBlock2D,
    StencilOperatorBlock3D,
)
from iifea_tpu_torch.solvers.ksp import solve_ksp

TOL = {np.float64: 1e-12, np.float32: 1e-4}
# a single level in both packages: 9 is not above the block cycles' and
# the 3D cycle's min_size (9), so the smoothing call under test is the
# level's own
SHAPES = {2: (9, 9), 3: (7, 7, 7)}
# (dim, fields, radius, dtype) of the instances the f64 and radius-3 routes
# added (fields 0: scalar planes)
NEW = ([(d, nf, r, np.float64) for d in (2, 3) for nf in (2, 3)
        for r in (1, 2, 3)]
       + [(d, nf, 3, np.float32) for d in (2, 3) for nf in (2, 3)]
       + [(3, 0, r, np.float64) for r in (1, 2)])


def _close(a, ref, dtype, scale=None):
    """max|a − ref| ≤ tol·max|scale| (scale: ref unless given; a residual
    is held to the size of its terms, b)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    scale = ref if scale is None else np.asarray(scale, np.float64)
    return np.abs(a - ref).max() <= TOL[dtype] * np.abs(scale).max()


def _planes(dim, n_fields, radius, dtype, seed):
    """A diagonally dominant operator (block planes (nF, nF, m^dim,
    *shape), or scalar planes for n_fields = 0), b and x."""
    shape = SHAPES[dim]
    rng = np.random.default_rng(seed)
    mk = (2 * radius + 1) ** dim
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, mk, *shape))
    for f in range(nF):
        C[f, f, mk // 2] += 4.0
    n = nF * int(np.prod(shape))
    b, x = rng.standard_normal(n), rng.standard_normal(n)
    if n_fields == 0:
        C = C[0, 0]
    return shape, C.astype(dtype), b.astype(dtype), x.astype(dtype)


@pytest.mark.parametrize("dim,n_fields,radius,dtype", NEW)
def test_torch_new_instances_match_jax(dim, n_fields, radius, dtype):
    """The apply through the kernel wrapper (its plain version on CPU
    tensors) against JAX's operator, and the multigrid's pre-smoothing
    call (ν = 2 from zero) with its residual against JAX's ``_smooth`` and
    b − A x by JAX's apply (JAX's hierarchies without their dense coarse
    inverse, which a smoothing call does not use)."""
    shape, C, b, x = _planes(dim, n_fields, radius, dtype,
                             100 * dim + 10 * radius + n_fields)
    Ct, bt, xt = (torch.from_numpy(a) for a in (C, b, x))
    bj, xj = jnp.asarray(b), jnp.asarray(x)
    if n_fields == 0:
        S_j = JStencil3(jnp.asarray(C), shape, radius)
        mv_j = S_j.mv_ref
        mg_j = jmg.StencilMultigrid3D(S_j, coarse_dense=False)
        mg_t = tmg.StencilMultigrid3D(StencilOperator3D(Ct, shape, radius))
        y_t = sk.stencil_mv3(Ct, xt, shape, radius)
    elif dim == 2:
        S_j = JBlock2(jnp.asarray(C), shape, radius)
        mv_j = S_j.mv
        mg_j = jmg.StencilMultigridBlock(S_j, coarse_dense=False)
        mg_t = tmg.StencilMultigridBlock(
            StencilOperatorBlock2D(Ct, shape, radius))
        y_t = sk.stencil_mv_block(Ct, xt, shape, radius)
    else:
        S_j = JBlock3(jnp.asarray(C), shape, radius)
        mv_j = S_j.mv
        mg_j = jmg.StencilMultigridBlock3D(S_j, coarse_dense=False)
        mg_t = tmg.StencilMultigridBlock3D(
            StencilOperatorBlock3D(Ct, shape, radius))
        y_t = sk.stencil3d_block(Ct, xt, shape, radius)
    assert len(mg_j.levels) == len(mg_t.levels) == 1
    assert y_t.dtype == bt.dtype and _close(y_t, mv_j(xj), dtype)
    y_j = mg_j._smooth(0, jnp.zeros_like(bj), bj, 2)
    kw = {"x_zero": True} if n_fields == 0 else {}
    y, r = mg_t._smooth(0, None, bt, 2, with_residual=True, **kw)
    assert y.dtype == bt.dtype
    assert _close(y, y_j, dtype)
    assert _close(r, bj - mv_j(y_j), dtype, scale=b)
    # the level call through the wrapper itself (scalar planes: the
    # Chebyshev steps of the 3D cycle; blocks: point-block sweeps)
    if dim == 2:
        got = sk.smooth(Ct, mg_t.binvs[0], bt, None, 1.0, 2, shape, radius,
                        True)
        ref = sk.smooth_plain(Ct, mg_t.binvs[0], bt, None, 1.0, 2, shape,
                              radius, True)
    else:
        binv = mg_t.inv_diags[0] if n_fields == 0 else mg_t.binvs[0]
        steps = mg_t._steps(2) if n_fields == 0 else [(1.0, 0.0)] * 2
        got = sk.smooth3(Ct, binv, bt, None, steps, shape, radius, True,
                         n_fields == 0)
        ref = sk.smooth3_plain(Ct, binv, bt, None, steps, shape, radius,
                               True, n_fields == 0)
    assert all(torch.equal(g, r_) for g, r_ in zip(got, ref))


N_FG, N_BG = 30, 15


def test_torch_bspline_elasticity_radius3_matches_jax():
    """Radius 3 with two fields (the quadratic B-spline background under
    vector elasticity, k = 2): both packages' solve_ksp(gmres, mg,
    stencil_radius=3, n_fields=2) in f64 on the CPU, the same numpy net and
    foreground; iterations within 2, L2 and H10 within 1e-5 relative."""
    mesh_j, M_j, shape = j_bspline_square(n_fg=N_FG, n_bg=N_BG, n_fields=2)
    prob_j = JElasticity(mesh_j, k=2)
    form_j = prob_j.form
    A, b_j = jax.jit(lambda u: j_assemble(form_j, u, M_j))(
        jnp.zeros(form_j.n_dofs))
    A_j = JBackgroundOperator(form_j, A.blocks, M_j)
    solve = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=shape,
                 stencil_radius=3, n_fields=2, monitor=False)
    x_j, info_j = j_solve_ksp(A_j, b_j, **solve)
    n_j = prob_j.error_norms(M_j.mv(x_j))

    mesh, M, shape_t = immersed_square_bspline_problem(
        n_fg=N_FG, n_bg=N_BG, n_fields=2, device="cpu")
    assert tuple(shape_t) == tuple(shape)
    prob = ImmersedElasticityProblem(mesh, k=2, device="cpu")
    A_t, b_t = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    x, info = solve_ksp(A_t, b_t, **solve)
    n = prob.error_norms(M.mv(x))
    assert info.converged and bool(info_j.converged)
    assert abs(int(info.iters) - int(info_j.iters)) <= 2
    for k in ("L2", "H10"):
        assert abs(n[k] - float(n_j[k])) <= 1e-5 * float(n_j[k])
