"""Port stencil apply and Jacobi sweep (iifea_tpu_torch.ops.stencil_kernels)
against the JAX Pallas kernels (interpret mode) and the JAX ``mv_ref``.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are checked against those by the ``gpu`` tests, which
skip without a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import pallas_stencil as ps
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import StencilOperator2D

SHAPES = [(17, 17), (33, 129), (40, 200)]


def _operands(shape, radius, dtype, seed=0):
    rng = np.random.default_rng(seed)
    m = 2 * radius + 1
    C = rng.standard_normal((m * m, *shape)).astype(dtype)
    x = rng.standard_normal(shape[0] * shape[1]).astype(dtype)
    return C, x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
def test_torch_stencil_mv_matches_pallas(shape, radius):
    """f32: the port's stencil_mv (plain path on CPU) vs the Pallas kernel
    in interpret mode and vs the JAX mv_ref, at 1e-4·max|y|."""
    C, x = _operands(shape, radius, np.float32)
    S = JStencil(jnp.asarray(C), shape, radius)
    y_pallas = np.asarray(ps.stencil_mv(S.cp, jnp.asarray(x), shape, radius,
                                        interpret=True))
    y_ref = np.asarray(S.mv_ref(jnp.asarray(x)))
    before = sk.stencil_mv.launches
    y = sk.stencil_mv(torch.from_numpy(C), torch.from_numpy(x), shape,
                      radius).numpy()
    assert sk.stencil_mv.launches == before    # CPU never counts a launch
    tol = 1e-4 * np.abs(y_ref).max()
    assert np.abs(y - y_pallas).max() <= tol
    assert np.abs(y - y_ref).max() <= tol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
def test_torch_stencil_mv_ref_f64(shape, radius):
    """f64: StencilOperator2D.mv (→ mv_ref) vs the JAX mv_ref at 1e-12."""
    C, x = _operands(shape, radius, np.float64, seed=1)
    y_ref = np.asarray(JStencil(jnp.asarray(C), shape, radius).mv_ref(
        jnp.asarray(x)))
    S = StencilOperator2D(torch.from_numpy(C), shape, radius)
    y = S.mv(torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


def test_torch_jacobi_smooth_matches_pallas():
    rng = np.random.default_rng(2)
    shape, radius, om = (21, 35), 2, 0.67
    C, x = _operands(shape, radius, np.float32, seed=2)
    n = shape[0] * shape[1]
    b = rng.standard_normal(n).astype(np.float32)
    invd = rng.uniform(0.5, 2.0, n).astype(np.float32)
    S = JStencil(jnp.asarray(C), shape, radius)
    y_pallas = np.asarray(ps.jacobi_smooth(
        S.cp, S.pad_plane(jnp.asarray(invd)), S.pad_plane(jnp.asarray(b)),
        jnp.asarray(x), om, shape, radius, interpret=True))
    y_ref = np.asarray(jnp.asarray(x) + om * jnp.asarray(invd) * (
        jnp.asarray(b) - S.mv_ref(jnp.asarray(x))))
    St = StencilOperator2D(torch.from_numpy(C), shape, radius)
    y = St.smooth(torch.from_numpy(invd), torch.from_numpy(b),
                  torch.from_numpy(x), om, 1).numpy()
    tol = 1e-4 * np.abs(y_ref).max()
    assert np.abs(y - y_pallas).max() <= tol
    assert np.abs(y - y_ref).max() <= tol


def test_torch_stencil_wrappers_reject_bad_operands():
    C = torch.zeros(25, 5, 6)
    x = torch.zeros(30)
    # f32 and f64 operators are taken (the f64 instances), mixed or other
    # dtypes are not
    assert sk.stencil_mv(C.double(), x.double(), (5, 6), 2).dtype == \
        torch.float64
    with pytest.raises(TypeError):
        sk.stencil_mv(C.double(), x, (5, 6), 2)
    with pytest.raises(TypeError):
        sk.stencil_mv(C.half(), x.half(), (5, 6), 2)
    with pytest.raises(ValueError):
        sk.stencil_mv(C, torch.zeros(31), (5, 6), 2)
    with pytest.raises(ValueError):
        sk.stencil_mv(C, x, (5, 6), 3)
    with pytest.raises(ValueError):
        sk.stencil_mv(torch.zeros(25, 6, 5).transpose(1, 2), x, (5, 6), 2)
    with pytest.raises(ValueError):
        sk.jacobi_smooth(C, torch.zeros(29), x, x, 0.67, (5, 6), 2)
    with pytest.raises(ValueError):
        StencilOperator2D(C, (6, 5), 2)


def test_torch_stencil_kernel_build_is_keyed_by_source():
    """The library name follows every source and the flags; nothing is
    compiled at import time."""
    p = sk.library_path()
    assert p.parent == sk.BUILD_DIR
    assert p.name.startswith("libstencil_") and p.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in sk.NVCC_FLAGS
    assert {s.name for s in sk.SOURCES} >= {"stencil2d.cu", "stencil3d.cu"}
    assert all(s.exists() for s in sk.SOURCES)
