"""The port's single-launch CUDA entries against their plain PyTorch
versions, on a card: ``stencil_mv``, ``jacobi_smooth`` (2D), the 2D block
apply through ``StencilOperatorBlock2D.mv``, ``stencil_mv3``,
``jacobi_smooth3``, ``cheb_step3`` and the 3D block entry
``stencil3d_block`` (apply, residual, sweep, sweep from zero; 1 to 3
fields). Every case skips without a CUDA device.

The file imports nothing of JAX, so it also runs on a machine that has a
card and no JAX, without the package's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_card.py -q
"""
import numpy as np
import pytest
import torch

from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import (
    StencilOperatorBlock2D,
    StencilOperatorBlock3D,
)

TOL = 1e-4     # max|y − y_plain| ≤ TOL·max|y_plain| (f32 sum order)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)


def _close(got, ref):
    return float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,radius", [((17, 17), 1), ((33, 129), 2),
                                          ((40, 200), 2), ((40, 200), 1)])
def test_torch_stencil_kernels_on_card(shape, radius):
    """stencil_mv and jacobi_smooth vs their plain versions, one launch
    each."""
    dev = _card()
    rng = np.random.default_rng(3)
    n = shape[0] * shape[1]
    C = _t(rng.standard_normal(((2 * radius + 1) ** 2, *shape)), dev)
    x, b = (_t(rng.standard_normal(n), dev) for _ in range(2))
    invd = _t(rng.uniform(0.5, 2, n), dev)
    n0 = sk.launches()
    y = sk.stencil_mv(C, x, shape, radius)
    s = sk.jacobi_smooth(C, invd, b, x, 0.67, shape, radius)
    torch.cuda.synchronize()
    assert sk.launches() == {**n0, "stencil_mv": n0["stencil_mv"] + 1,
                             "jacobi_smooth": n0["jacobi_smooth"] + 1}
    assert _close(y, sk.stencil_mv_plain(C, x, shape, radius))
    assert _close(s, sk.jacobi_smooth_plain(C, invd, b, x, 0.67, shape,
                                            radius))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 17), (33, 129), (65, 65)])
def test_torch_block_apply_on_card(shape):
    """The 2D block apply on the card is one launch of the block kernel and
    equals the plain block apply; a non-f32 block operator raises there."""
    dev = _card()
    rng = np.random.default_rng(9)
    n = shape[0] * shape[1]
    C = _t(rng.standard_normal((2, 2, 25, *shape)), dev)
    x = _t(rng.standard_normal(2 * n), dev)
    before = sk.launches()
    y = StencilOperatorBlock2D(C, shape, 2).mv(x)
    torch.cuda.synchronize()
    assert sk.launches() == {**before, "stencil_mv_block":
                             before["stencil_mv_block"] + 1}
    assert _close(y, sk.stencil_mv_block_plain(C, x, shape, 2))
    with pytest.raises(TypeError):
        StencilOperatorBlock2D(C.double(), shape, 2).mv(x.double())


def _operands3(shape, radius, dev, seed):
    rng = np.random.default_rng(seed)
    n = shape[0] * shape[1] * shape[2]
    return (_t(rng.standard_normal(((2 * radius + 1) ** 3, *shape)), dev),
            _t(rng.standard_normal(n), dev), _t(rng.standard_normal(n), dev),
            _t(rng.uniform(0.5, 2.0, n), dev),
            _t(rng.standard_normal(n), dev))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,radius", [((9, 9, 9), 1), ((13, 10, 17), 2),
                                          ((105, 105, 105), 2)])
def test_torch_stencil3d_kernels_on_card(shape, radius):
    """stencil_mv3, jacobi_smooth3 and cheb_step3 vs their plain versions,
    one launch each."""
    dev = _card()
    C, x, b, invd, d = _operands3(shape, radius, dev, 7)
    n0 = sk.launches()
    y = sk.stencil_mv3(C, x, shape, radius)
    s = sk.jacobi_smooth3(C, invd, b, x, 0.67, shape, radius)
    c, dc = sk.cheb_step3(C, invd, b, x, d.clone(), 1.3, 0.45, shape, radius)
    torch.cuda.synchronize()
    n1 = sk.launches()
    for name in ("stencil_mv3", "jacobi_smooth3", "cheb_step3"):
        assert n1[name] == n0[name] + 1, name
    c_ref, dc_ref = sk.cheb_step3_plain(C, invd, b, x, d, 1.3, 0.45, shape,
                                        radius)
    assert _close(y, sk.stencil_mv3_plain(C, x, shape, radius))
    assert _close(s, sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape,
                                             radius))
    assert _close(c, c_ref) and _close(dc, dc_ref)


def _block_operands3(n_fields, radius, shape, dev, seed):
    """A diagonally dominant nF-field 3D operator (n_fields = 0: scalar
    planes and the flat 1/diag), its smoother blocks, b and x on the card."""
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m3, *shape))
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    n = nF * shape[0] * shape[1] * shape[2]
    C, b, x = (_t(a, dev) for a in (C, rng.standard_normal(n),
                                    rng.standard_normal(n)))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m3 // 2]).reshape(-1).contiguous(), b, x
    return C, tmg._point_binv(StencilOperatorBlock3D(C, shape, radius)), b, x


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(9, 9, 9), (13, 10, 17), (11, 9, 14),
                                   (25, 25, 25)])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
def test_torch_stencil3d_block_on_card(n_fields, radius, shape):
    """stencil3d_block's four passes on the card: one launch each, equal to
    the plain versions at 1e-4·max|y|, bitwise repeatable; with scalar
    planes equal to stencil_mv3 and jacobi_smooth3 at the same tolerance."""
    dev = _card()
    C, binv, b, x = _block_operands3(n_fields, radius, shape, dev, 21)
    args = (shape, radius)

    def run():
        return (sk.stencil3d_block(C, x, *args),
                sk.stencil3d_block(C, x, *args, b=b),
                sk.stencil3d_block(C, x, *args, b=b, binv=binv, omega=0.8),
                sk.stencil3d_block(C, None, *args, b=b, binv=binv,
                                   omega=0.8))

    before = sk.launches()
    got = run()
    torch.cuda.synchronize()
    assert sk.launches() == {**before, "stencil3d_block":
                             before["stencil3d_block"] + 4}
    y_ref = sk.apply3_block_plain(C, x, *args)
    refs = (y_ref, b - y_ref,
            sk.sweep3_block_plain(C, binv, b, x, 0.8, *args),
            sk.sweep3_block_plain(C, binv, b, None, 0.8, *args))
    for a, a_ref, again in zip(got, refs, run()):
        assert _close(a, a_ref)
        assert torch.equal(a, again)
    if n_fields == 0:
        assert _close(got[0], sk.stencil_mv3(C, x, *args))
        assert _close(got[2], sk.jacobi_smooth3(C, binv, b, x, 0.8, *args))


@pytest.mark.gpu
def test_torch_block3d_operator_on_card():
    """StencilOperatorBlock3D on the card: ``mv`` is one launch, ``smooth``
    one launch per sweep and one for the residual, both equal to the CPU
    operator's plain versions; a non-f32 operator raises."""
    dev = _card()
    shape = (13, 10, 17)
    C, binv, b, x = _block_operands3(3, 2, shape, dev, 22)
    S = StencilOperatorBlock3D(C, shape, 2)
    S_cpu = StencilOperatorBlock3D(C.cpu(), shape, 2)
    before = sk.launches()
    y = S.mv(x)
    xs, r = S.smooth(binv, b, None, 1.0, 2, with_residual=True)
    xp = S.smooth(binv, b, x, 1.0, 2)
    torch.cuda.synchronize()
    assert sk.launches() == {**before, "stencil3d_block":
                             before["stencil3d_block"] + 6}
    xs_ref, r_ref = S_cpu.smooth(binv.cpu(), b.cpu(), None, 1.0, 2,
                                 with_residual=True)
    assert _close(y.cpu(), S_cpu.mv(x.cpu()))
    assert _close(xs.cpu(), xs_ref) and _close(r.cpu(), r_ref)
    assert _close(xp.cpu(), S_cpu.smooth(binv.cpu(), b.cpu(), x.cpu(), 1.0,
                                         2))
    with pytest.raises(TypeError):
        StencilOperatorBlock3D(C.double(), shape, 2).mv(x.double())
