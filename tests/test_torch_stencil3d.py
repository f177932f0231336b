"""Port 3D stencil apply, Jacobi sweep and Chebyshev step
(iifea_tpu_torch.ops.stencil_kernels) against the JAX ``StencilOperator3D``
``mv_ref`` and the Pallas ``jacobi_smooth3`` kernel (interpret mode).

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are checked against those by the ``gpu`` test, which
skips without a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import pallas_stencil as ps
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import StencilOperator3D

SHAPES = [(9, 9, 9), (13, 10, 17)]


def _operands(shape, radius, dtype, seed=0):
    rng = np.random.default_rng(seed)
    m = 2 * radius + 1
    n = shape[0] * shape[1] * shape[2]
    C = rng.standard_normal((m ** 3, *shape)).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    b = rng.standard_normal(n).astype(dtype)
    invd = rng.uniform(0.5, 2.0, n).astype(dtype)
    d = rng.standard_normal(n).astype(dtype)
    return C, x, b, invd, d


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-4),
                                        (np.float64, 1e-12)])
def test_torch_stencil_mv3_matches_mv_ref(shape, radius, dtype, rtol):
    """The port's 3D apply (StencilOperator3D.mv: the stencil_mv3 wrapper
    for f32, mv_ref for f64) vs the JAX mv_ref, at rtol·max|y|."""
    C, x, *_ = _operands(shape, radius, dtype)
    y_ref = np.asarray(JStencil3(jnp.asarray(C), shape, radius).mv_ref(
        jnp.asarray(x)))
    before = sk.stencil_mv3.launches
    y = StencilOperator3D(torch.from_numpy(C), shape, radius).mv(
        torch.from_numpy(x)).numpy()
    assert sk.stencil_mv3.launches == before    # CPU never counts a launch
    assert np.abs(y - y_ref).max() <= rtol * np.abs(y_ref).max()


@pytest.mark.parametrize("radius", [1, 2])
def test_torch_jacobi_smooth3_matches_pallas(radius):
    """f32 sweep at (11, 9, 14) vs the Pallas kernel in interpret mode and
    vs the JAX mv_ref form, at 1e-4·max|y| (tests/test_pallas_stencil.py)."""
    shape, om = (11, 9, 14), 0.67
    C, x, b, invd, _ = _operands(shape, radius, np.float32, seed=4)
    S = JStencil3(jnp.asarray(C), shape, radius)
    y_pallas = np.asarray(ps.jacobi_smooth3(
        S.cp, S.pad_volume(jnp.asarray(invd)), S.pad_volume(jnp.asarray(b)),
        jnp.asarray(x), om, shape, radius, interpret=True))
    y_ref = np.asarray(jnp.asarray(x) + om * jnp.asarray(invd) * (
        jnp.asarray(b) - S.mv_ref(jnp.asarray(x))))
    St = StencilOperator3D(torch.from_numpy(C), shape, radius)
    y = St.jacobi_smooth(torch.from_numpy(invd), torch.from_numpy(b),
                         torch.from_numpy(x), om).numpy()
    tol = 1e-4 * np.abs(y_ref).max()
    assert np.abs(y - y_pallas).max() <= tol
    assert np.abs(y - y_ref).max() <= tol


@pytest.mark.parametrize("first", [True, False])
def test_torch_cheb_step3_matches_formula(first):
    """One Chebyshev step (f64) vs its definition on the JAX mv_ref:
    r = invd·(b − A x), d' = α r + β d, x' = x + d'."""
    shape, radius = (11, 9, 14), 2
    C, x, b, invd, d = _operands(shape, radius, np.float64, seed=5)
    alpha, beta = (1.7, 0.0) if first else (1.3, 0.45)
    r = invd * (b - np.asarray(JStencil3(jnp.asarray(C), shape, radius)
                               .mv_ref(jnp.asarray(x))))
    d_ref = alpha * r + (0.0 if first else beta * d)
    xn, dn = sk.cheb_step3_plain(
        torch.from_numpy(C), torch.from_numpy(invd), torch.from_numpy(b),
        torch.from_numpy(x), None if first else torch.from_numpy(d), alpha,
        beta, shape, radius)
    assert np.abs(dn.numpy() - d_ref).max() <= 1e-12 * np.abs(d_ref).max()
    assert np.abs(xn.numpy() - (x + d_ref)).max() <= 1e-12 * np.abs(
        x + d_ref).max()


def test_torch_stencil3d_diag_and_layout():
    C, *_ = _operands((7, 13, 10), 1, np.float64, seed=6)
    S_j = JStencil3(jnp.asarray(C), (7, 13, 10), 1)
    S_t = StencilOperator3D(torch.from_numpy(C), (7, 13, 10), 1)
    assert np.array_equal(S_t.diag().numpy(), np.asarray(S_j.diag()))
    assert np.array_equal(S_t.coeffs.numpy(), np.asarray(S_j.coeffs))
    assert S_t.to(torch.float32).dtype == torch.float32


def test_torch_stencil3d_wrappers_reject_bad_operands():
    C = torch.zeros(125, 5, 6, 7)
    x = torch.zeros(210)
    with pytest.raises(TypeError):
        sk.stencil_mv3(C.half(), x.half(), (5, 6, 7), 2)
    with pytest.raises(ValueError):
        sk.stencil_mv3(C, torch.zeros(211), (5, 6, 7), 2)
    with pytest.raises(ValueError):
        sk.stencil_mv3(C, x, (5, 6, 7), 1)
    with pytest.raises(ValueError):
        sk.jacobi_smooth3(C, torch.zeros(209), x, x, 0.67, (5, 6, 7), 2)
    with pytest.raises(ValueError):
        sk.cheb_step3(C, x, x, x, None, 1.0, 0.5, (5, 6, 7), 2)
    with pytest.raises(ValueError):
        sk.cheb_step3(C, x, x, x, x, 1.0, 0.5, (5, 6, 7), 2)   # d aliases x
    with pytest.raises(ValueError):
        sk.stencil_mv3(torch.zeros(25, 14, 15), x, (14, 15), 2)
    with pytest.raises(ValueError):
        StencilOperator3D(C, (7, 6, 5), 2)
