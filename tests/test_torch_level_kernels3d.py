"""The port's 3D level smoothing call (``smooth3``: sweeps or Chebyshev
steps from x or from zero, and the trailing residual b − A x_ν) against
the JAX package's ``StencilMultigrid3D._smooth`` and
``StencilMultigridBlock3D._smooth`` followed by the residual by JAX's own
apply, from the same numpy inputs: f64 at 1e-12 and f32 at 1e-5 relative
(one rounding per operation, summed in another order). On CPU tensors the
entry runs its plain version, ``smooth3_plain``; the CUDA routes are held
against it on a card by ``tests/test_torch_level_kernels_card.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.ops.stencil import StencilOperatorBlock3D as JBlock3
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D

# sides of 5 to 9: neither package coarsens, so each hierarchy is the one
# level whose smoothing call is under test; two lattices are not cubes (the
# last one radius 5's, the runtime-radius level kernel's)
SHAPES = [(7, 5, 9), (6, 6, 6), (5, 5, 5), (6, 5, 7)]
# (sweeps, from zero): several steps from x, one step from zero (the V-cycle's
# from-zero calls of two and more steps are held against JAX's cycle by
# test_torch_multigrid3d.py and test_torch_block3d.py)
CASES = ((3, False), (1, True))
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _close(a, ref, dtype, scale=None):
    """max|a − ref| ≤ tol·max|scale| (scale: ref unless given; a residual
    is held to the size of its terms, b, since the smoothed residual is
    small by cancellation)."""
    a, ref = np.asarray(a, dtype=np.float64), np.asarray(ref,
                                                         dtype=np.float64)
    scale = ref if scale is None else np.asarray(scale, dtype=np.float64)
    return np.abs(a - ref).max() <= TOL[dtype] * np.abs(scale).max()


def _planes(n_fields, radius, shape, dtype, seed):
    """A diagonally dominant operator (block planes (nF, nF, m³, *shape),
    or scalar planes (m³, *shape) for n_fields = 0), b and x."""
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m3, *shape))
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    n = nF * shape[0] * shape[1] * shape[2]
    b, x = rng.standard_normal(n), rng.standard_normal(n)
    if n_fields == 0:
        C = C[0, 0]
    return C.astype(dtype), b.astype(dtype), x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
@pytest.mark.parametrize("radius", [1, 2, 3, 5])
def test_torch_smooth3_scalar_matches_jax(radius, smoother, dtype):
    """``StencilMultigrid3D._smooth`` with its residual (one ``smooth3``
    call) against JAX's ``_smooth`` and b − S.mv_ref(x): ν = 3 from x, ν = 1
    from zero; the Jacobi option at ω = 0.8."""
    shape = SHAPES[min(radius, 4) - 1]
    C, b, x = _planes(0, radius, shape, dtype, 40 + radius)
    S_j = JStencil3(jnp.asarray(C), shape, radius)
    S_t = from_numpy_state(coeffs=np.asarray(S_j.coeffs), lattice_shape=shape,
                           radius=radius, device="cpu").S
    kw = dict(smoother=smoother, omega=0.8)
    mg_j = jmg.StencilMultigrid3D(S_j, coarse_dense=False, **kw)
    mg_t = tmg.StencilMultigrid3D(S_t, **kw)
    assert len(mg_j.levels) == len(mg_t.levels) == 1
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    for sweeps, from_zero in CASES:
        start = None if from_zero else x
        xj = jnp.zeros_like(bj) if start is None else jnp.asarray(start)
        y_j = mg_j._smooth(0, xj, bj, sweeps)
        r_j = bj - S_j.mv_ref(y_j)
        y_t, r_t = mg_t._smooth(
            0, None if start is None else torch.from_numpy(start), bt,
            sweeps, x_zero=start is None, with_residual=True)
        assert y_t.dtype == torch.from_numpy(b).dtype
        assert _close(y_t, y_j, dtype)
        assert _close(r_t, r_j, dtype, scale=b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("radius", [1, 2, 5])
@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_torch_smooth3_block_matches_jax(n_fields, radius, dtype):
    """``StencilMultigridBlock3D._smooth`` with its residual (one
    ``smooth3`` call) against JAX's ``_smooth`` and b − S.mv(x): ν = 3 from
    x, ν = 1 from zero."""
    shape = SHAPES[3 if radius == 5 else min(n_fields + 2 * radius - 3, 2)]
    C, b, x = _planes(n_fields, radius, shape, dtype, 50 + 3 * radius
                      + n_fields)
    S_j = JBlock3(jnp.asarray(C), shape, radius)
    S_t = StencilOperatorBlock3D(torch.from_numpy(C), shape, radius)
    mg_j = jmg.StencilMultigridBlock3D(S_j, coarse_dense=False)
    mg_t = tmg.StencilMultigridBlock3D(S_t)
    assert len(mg_j.levels) == len(mg_t.levels) == 1
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    for sweeps, from_zero in CASES:
        start = None if from_zero else x
        xj = jnp.zeros_like(bj) if start is None else jnp.asarray(start)
        y_j = mg_j._smooth(0, xj, bj, sweeps)
        r_j = bj - S_j.mv(y_j)
        y_t, r_t = mg_t._smooth(
            0, None if start is None else torch.from_numpy(start), bt,
            sweeps, with_residual=True)
        assert _close(y_t, y_j, dtype)
        assert _close(r_t, r_j, dtype, scale=b)


@pytest.mark.parametrize("cheb", [False, True])
def test_torch_smooth3_plain_is_its_passes(cheb):
    """``smooth3`` on CPU tensors is ``smooth3_plain`` (no launch), and that
    is its steps one after another with the single-pass plain versions:
    from zero the first step is ω·invd·b (Chebyshev: d its result), a
    Chebyshev step carries d, the residual is b − A x_ν; bitwise, f64."""
    shape, r = (7, 5, 9), 3
    C, b, x = (torch.from_numpy(a) for a in _planes(0, r, shape, np.float64,
                                                    60))
    invd = 1.0 / C[171].reshape(-1)
    steps = [(0.7, 0.0), (1.3, 0.4), (1.1, 0.6)]
    before = sk.launches()
    got = sk.smooth3(C, invd, b, None, steps, shape, r, True, cheb)
    assert sk.launches() == before
    xk = 0.7 * invd * b
    d = xk
    for s0, s1 in steps[1:]:
        if cheb:
            xk, d = sk.cheb_step3_plain(C, invd, b, xk, d, s0, s1, shape, r)
        else:
            xk = sk.jacobi_smooth3_plain(C, invd, b, xk, s0, shape, r)
    assert torch.equal(got[0], xk)
    assert torch.equal(got[1], b - sk.stencil_mv3_plain(C, xk, shape, r))
    y = sk.smooth3(C, invd, b, x, steps[:1], shape, r, cheb=cheb)
    assert torch.equal(y, sk.cheb_step3_plain(C, invd, b, x, None, 0.7, 0.0,
                                              shape, r)[0] if cheb else
                       sk.jacobi_smooth3_plain(C, invd, b, x, 0.7, shape, r))


def test_torch_smooth3_refusals():
    """What no instance takes is refused before any route is chosen: the
    Chebyshev smoother on a block operator, a first Chebyshev step with
    s1 ≠ 0, scalar and block planes in a dtype other than f32 and f64, four
    fields. f64 scalar planes at radius 2 and f64 block planes are taken
    (their plain versions, given CPU tensors)."""
    shape = (5, 5, 5)
    C, b, x = (torch.from_numpy(a) for a in _planes(0, 2, shape, np.float64,
                                                    61))
    invd = 1.0 / C[62].reshape(-1)
    Cb, bb, xb = (torch.from_numpy(a)
                  for a in _planes(2, 1, shape, np.float32, 62))
    binv = tmg._point_binv(StencilOperatorBlock3D(Cb, shape, 1))
    with pytest.raises(ValueError, match="scalar planes"):
        sk.smooth3(Cb, binv, bb, xb, [(1.0, 0.0)], shape, 1, cheb=True)
    with pytest.raises(ValueError, match="s1 = 0"):
        sk.smooth3(C.float(), invd.float(), b.float(), x.float(),
                   [(1.0, 0.5)], shape, 2, cheb=True)
    assert torch.equal(
        sk.smooth3(C, invd, b, x, [(1.0, 0.0)], shape, 2),
        sk.smooth3_plain(C, invd, b, x, [(1.0, 0.0)], shape, 2))
    assert torch.equal(
        sk.smooth3(Cb.double(), binv.double(), bb.double(), xb.double(),
                   [(1.0, 0.0)], shape, 1),
        sk.smooth3_plain(Cb.double(), binv.double(), bb.double(),
                         xb.double(), [(1.0, 0.0)], shape, 1))
    with pytest.raises(TypeError, match="float32 or float64"):
        sk.smooth3(C.half(), invd.half(), b.half(), x.half(), [(1.0, 0.0)],
                   shape, 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        sk.smooth3(Cb.half(), binv.half(), bb.half(), xb.half(),
                   [(1.0, 0.0)], shape, 1)
    with pytest.raises(ValueError, match="1 to 3 fields"):
        sk.stencil3d_block(torch.zeros(4, 4, 27, *shape),
                           torch.zeros(4 * 125), shape, 1)
