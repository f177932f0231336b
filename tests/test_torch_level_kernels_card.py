"""The port's CUDA entries ``stencil_mv_block`` (block apply and residual,
one launch) and ``smooth`` (a level's ν sweeps and trailing residual; one
launch per pass, or one fused cooperative launch where the level fits)
against their plain PyTorch versions, on a card. Every case skips without
a CUDA device.

The file imports nothing of JAX, so it also runs on a machine that has a
card and no JAX, without the package's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_level_kernels_card.py -q
"""
import numpy as np
import pytest
import torch

from iifea_tpu_torch.ops import multigrid as tmg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import StencilOperatorBlock2D

SHAPES = [(17, 17), (33, 129), (40, 200)]


def _card_operands(n_fields, radius, shape, seed):
    """A diagonally dominant nF-field operator (n_fields = 0: scalar planes
    and the flat 1/diag), its smoother blocks, b and x on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    m2 = (2 * radius + 1) ** 2
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m2, *shape))
    for f in range(nF):
        C[f, f, m2 // 2] += 4.0
    n = nF * shape[0] * shape[1]
    C, b, x = (torch.from_numpy(a.astype(np.float32)).to(dev)
               for a in (C, rng.standard_normal(n), rng.standard_normal(n)))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        binv = (1.0 / C[m2 // 2]).reshape(-1).contiguous()
    else:
        binv = tmg._point_binv(StencilOperatorBlock2D(C, shape, radius))
    return C, binv, b, x


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
def test_torch_block_entry_on_card(n_fields, radius, shape):
    """stencil_mv_block (apply and residual) on the card: one launch each,
    equal to the plain versions at 1e-4·max|y|."""
    C, _, b, x = _card_operands(n_fields, radius, shape, 11)
    before = sk.launches()
    y = sk.stencil_mv_block(C, x, shape, radius)
    r = sk.stencil_mv_block(C, x, shape, radius, b=b)
    torch.cuda.synchronize()
    assert sk.launches() == {**before, "stencil_mv_block":
                             before["stencil_mv_block"] + 2}
    y_ref = sk.apply_plain(C, x, shape, radius)
    lim = 1e-4 * float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) <= lim
    assert float((r - (b - y_ref)).abs().max()) <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [0, 2, 3])
def test_torch_smooth_entry_on_card(n_fields, radius, shape):
    """smooth on the card by both routes, ν = 1, 2, 3, both flags: equal to
    the plain version at 1e-4·max|y|; the fused launch, where the plan says
    the level fits, is one launch a call and bitwise equal to the per-pass
    launches; where the plan says it does not fit, the fused launch is
    refused and raises."""
    C, binv, b, x = _card_operands(n_fields, radius, shape, 12)
    nF = max(n_fields, 1)
    fits = sk._smooth_route(shape, radius, nF, 0) == sk.GRID
    for sweeps in (1, 2, 3):
        for start in (x, None):
            for with_residual in (False, True):
                args = (C, binv, b, start, 0.8, sweeps, shape, radius)
                ref = sk.smooth_plain(*args, with_residual)
                before = sk.launches()
                per_pass = sk._smooth_cuda(sk.PER_PASS, *args, nF,
                                           with_residual)
                assert sk.smooth.launches == before["smooth"]
                got = [per_pass, sk.smooth(*args, with_residual)]
                if fits:
                    before = sk.launches()
                    got.append(sk._smooth_cuda(sk.GRID, *args, nF,
                                               with_residual))
                    assert sk.launches() == {**before, "smooth":
                                             before["smooth"] + 1}
                else:
                    with pytest.raises(RuntimeError):
                        sk._smooth_cuda(sk.GRID, *args, nF, with_residual)
                torch.cuda.synchronize()
                for out in got:
                    for a, a_ref, a_pass in zip(_tuple(out), _tuple(ref),
                                                _tuple(per_pass)):
                        assert float((a - a_ref).abs().max()) <= (
                            1e-4 * float(a_ref.abs().max()))
                        assert torch.equal(a, a_pass)


@pytest.mark.gpu
def test_torch_smooth_refuses_a_level_that_does_not_fit():
    """A level with more tiles than are co-resident takes one launch per
    pass, and its forced fused launch raises instead of running."""
    shape = (1025, 1025)
    C, binv, b, x = _card_operands(0, 2, shape, 13)
    assert sk._smooth_route(shape, 2, 1, 0) == sk.PER_PASS
    with pytest.raises(RuntimeError):
        sk._smooth_cuda(sk.GRID, C, binv, b, x, 0.8, 2, shape, 2, 1, True)
    before = sk.launches()
    y, r = sk.smooth(C, binv, b, None, 0.8, 2, shape, 2, with_residual=True)
    torch.cuda.synchronize()
    assert sk.launches() == {**before,
                             "jacobi_smooth": before["jacobi_smooth"] + 1,
                             "stencil_mv_block":
                                 before["stencil_mv_block"] + 1}
    y_ref, r_ref = sk.smooth_plain(C, binv, b, None, 0.8, 2, shape, 2, True)
    assert float((y - y_ref).abs().max()) <= 1e-4 * float(y_ref.abs().max())
    assert float((r - r_ref).abs().max()) <= 1e-4 * float(b.abs().max())
