"""The port's block apply/residual (``stencil_mv_block``) and level
smoothing call (``smooth``: ν sweeps from x or from zero, and the trailing
residual) against ν calls of the single-sweep plain functions and against
the JAX package's ``StencilMultigrid._smooth`` /
``StencilMultigridBlock._smooth`` plus the residual b − A x by JAX's plain
applies, from the same
numpy inputs: f64 at 1e-12 and f32 at 1e-5 relative (one f32 rounding per
operation in another order). On CPU tensors the wrappers run their plain
versions; the CUDA entries are held against those on a card by
``tests/test_torch_level_kernels_card.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil
from iifea_tpu.ops.stencil import StencilOperatorBlock2D as JBlock
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperatorBlock2D,
)

# sides with (s − 1) odd: neither package coarsens, so each hierarchy is
# the one level whose smoothing call is under test
SHAPE = (12, 14)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _operands(n_fields, radius, dtype, seed, shape=SHAPE):
    """A diagonally dominant nF-field operator (block planes (nF, nF, m²,
    *shape), or scalar planes (m², *shape) for n_fields = 0), b and x."""
    rng = np.random.default_rng(seed)
    m2 = (2 * radius + 1) ** 2
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m2, *shape))
    for f in range(nF):
        C[f, f, m2 // 2] += 4.0
    n = nF * shape[0] * shape[1]
    b, x = rng.standard_normal(n), rng.standard_normal(n)
    if n_fields == 0:
        C = C[0, 0]
    return C.astype(dtype), b.astype(dtype), x.astype(dtype)


def _close(a, ref, dtype, scale=None):
    """max|a − ref| ≤ tol·max|scale| (scale: ref unless given; a residual
    b − A x is held to the size of its terms, b, since the smoothed
    residual itself is small by cancellation)."""
    a, ref = np.asarray(a), np.asarray(ref)
    scale = ref if scale is None else np.asarray(scale)
    return np.abs(a - ref).max() <= TOL[dtype] * np.abs(scale).max()


def _hierarchies(n_fields, radius, dtype, seed):
    C, b, x = _operands(n_fields, radius, dtype, seed)
    if n_fields == 0:
        mg_j = jmg.StencilMultigrid(JStencil(jnp.asarray(C), SHAPE, radius))
        mg_t = tmg.StencilMultigrid(
            StencilOperator2D(torch.from_numpy(C), SHAPE, radius))
    else:
        mg_j = jmg.StencilMultigridBlock(JBlock(jnp.asarray(C), SHAPE,
                                                radius))
        mg_t = tmg.StencilMultigridBlock(
            StencilOperatorBlock2D(torch.from_numpy(C), SHAPE, radius))
    assert len(mg_t.levels) == len(mg_j.levels) == 1
    return mg_j, mg_t, b, x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("radius", [1, 2, 5])
@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
def test_torch_smooth_matches_jax_smooth(n_fields, radius, dtype):
    """``_smooth`` of both packages (n_fields = 0: the scalar hierarchy) for
    ν = 1, 2, 3, from x and from zero, and the residual beside it (radius
    5: what the runtime-radius level kernel computes in one launch)."""
    mg_j, mg_t, b, x = _hierarchies(n_fields, radius, dtype, 10 * radius
                                    + n_fields)
    S_j = mg_j.levels[0]
    mv_j = S_j.mv_ref if n_fields == 0 else S_j.mv    # both plain XLA
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    for sweeps in (1, 2, 3):
        for from_zero in (False, True):
            xj = jnp.zeros_like(bj) if from_zero else jnp.asarray(x)
            y_j = mg_j._smooth(0, xj, bj, sweeps)
            r_j = bj - mv_j(y_j)
            xt = None if from_zero else torch.from_numpy(x)
            y_t, r_t = mg_t._smooth(0, xt, bt, sweeps, with_residual=True)
            assert y_t.dtype == bt.dtype
            assert _close(y_t, y_j, dtype)
            assert _close(r_t, r_j, dtype, scale=b)
            assert torch.equal(mg_t._smooth(0, xt, bt, sweeps), y_t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
def test_torch_smooth_plain_is_repeated_single_sweeps(sweeps, n_fields,
                                                      radius, dtype):
    """``smooth_plain`` against ν calls of the single-sweep plain functions
    (``jacobi_smooth_plain``; the block sweep written out on
    ``stencil_mv_block_plain``), with both flags."""
    C, b, x = (torch.from_numpy(a) for a in _operands(
        n_fields, radius, dtype, 100 + sweeps))
    om = 0.8
    if n_fields == 0:
        binv = 1.0 / C[(2 * radius + 1) ** 2 // 2].reshape(-1)

        def sweep(v):
            return sk.jacobi_smooth_plain(C, binv, b, v, om, SHAPE, radius)

        def mv(v):
            return sk.stencil_mv_plain(C, v, SHAPE, radius)
    else:
        binv = tmg._point_binv(StencilOperatorBlock2D(C, SHAPE, radius))

        def mv(v):
            return sk.stencil_mv_block_plain(C, v, SHAPE, radius)

        def sweep(v):
            r = (b - mv(v)).reshape(n_fields, -1)
            return v + om * torch.einsum("abn,bn->an", binv, r).reshape(-1)

    for start in (x, None):
        y_ref = torch.zeros_like(b) if start is None else start
        for _ in range(sweeps):
            y_ref = sweep(y_ref)
        y, r = sk.smooth_plain(C, binv, b, start, om, sweeps, SHAPE, radius,
                               with_residual=True)
        assert _close(y, y_ref, dtype)
        assert _close(r, b - mv(y_ref), dtype, scale=b)
        assert torch.equal(sk.smooth_plain(C, binv, b, start, om, sweeps,
                                           SHAPE, radius), y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_torch_block_apply_and_residual_match_jax(n_fields, radius, dtype):
    """The block apply's and residual's plain versions, through the
    operator and (f32) through the kernel wrapper on CPU tensors, against
    JAX's block ``mv`` (plain XLA shifted slices)."""
    C, b, x = _operands(n_fields, radius, dtype, 7 * n_fields + radius,
                        shape=(17, 33))
    S_j = JBlock(jnp.asarray(C), (17, 33), radius)
    y_j = S_j.mv(jnp.asarray(x))
    S = StencilOperatorBlock2D(torch.from_numpy(C), (17, 33), radius)
    bt, xt = torch.from_numpy(b), torch.from_numpy(x)
    assert _close(S.mv(xt), y_j, dtype)
    assert _close(sk.residual_plain(S.coeffs, bt, xt, S.shape, radius),
                  jnp.asarray(b) - y_j, dtype, scale=b)
    if dtype == np.float32:
        before = sk.launches()
        assert torch.equal(sk.stencil_mv_block(S.coeffs, xt, S.shape, radius),
                           S.mv(xt))
        assert torch.equal(
            sk.stencil_mv_block(S.coeffs, xt, S.shape, radius, b=bt),
            bt - S.mv(xt))
        assert sk.launches() == before    # CPU never counts a launch


def test_torch_scalar_residual_and_smooth_dispatch():
    """StencilOperator2D.smooth and the residual wrapper: f32 through the
    kernel wrappers (plain on CPU tensors), f64 through the plain versions,
    equal to the written-out forms; no launch is counted on the CPU."""
    for dtype in (np.float32, np.float64):
        C, b, x = (torch.from_numpy(a) for a in _operands(0, 2, dtype, 5))
        S = StencilOperator2D(C, SHAPE, 2)
        invd = 1.0 / S.diag()
        before = sk.launches()
        if dtype == np.float32:
            assert torch.equal(sk.stencil_mv_block(C, x, SHAPE, 2, b=b),
                               b - S.mv_ref(x))
        y = x
        for _ in range(2):
            y = y + 0.67 * invd * (b - S.mv_ref(y))
        ys, rs = S.smooth(invd, b, x, 0.67, 2, with_residual=True)
        assert torch.equal(ys, y) and torch.equal(rs, b - S.mv_ref(y))
        assert sk.launches() == before


def test_torch_level_wrappers_reject_bad_operands():
    C, b, x = (torch.from_numpy(a) for a in _operands(2, 2, np.float32, 6))
    n = b.numel()
    binv = torch.zeros(2, 2, n // 2)
    assert sk.smooth(C, binv, b, x, 1.0, 1, SHAPE, 2).shape == (n,)
    with pytest.raises(ValueError):
        sk.smooth(C, binv, b, x, 1.0, -1, SHAPE, 2)
    with pytest.raises(ValueError):
        sk.smooth(C, binv[0], b, x, 1.0, 1, SHAPE, 2)
    with pytest.raises(ValueError):
        sk.smooth(C, binv, b[:-1], x, 1.0, 1, SHAPE, 2)
    with pytest.raises(TypeError):
        sk.smooth(C, binv, b, x.double(), 1.0, 1, SHAPE, 2)
    with pytest.raises(ValueError):
        sk.smooth(C, binv, b, x, 1.0, 1, SHAPE, 3)
    with pytest.raises(ValueError):
        sk.stencil_mv_block(C, x, (14, 12), 2)
    with pytest.raises(ValueError):
        sk.stencil_mv_block(C, x, SHAPE, 2, b=b[:-1])
    with pytest.raises(ValueError):    # four fields: the kernels take 1 to 3
        sk.stencil_mv_block(torch.zeros(4, 4, 25, *SHAPE),
                            torch.zeros(4 * n // 2), SHAPE, 2)
    with pytest.raises(ValueError):    # scalar planes take the flat 1/diag
        sk.smooth(C[0, 0], binv, b[:n // 2], None, 1.0, 1, SHAPE, 2)
