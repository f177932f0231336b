"""The port's single-launch CUDA entries against their plain PyTorch
versions, on a card: ``stencil_mv``, ``jacobi_smooth`` (2D; also their
radius-3 and f64 instances with ``stencil_mv_block`` and ``smooth``), the
2D block apply through ``StencilOperatorBlock2D.mv``, ``stencil_mv3``,
``jacobi_smooth3``, ``cheb_step3`` (also their radius-3 f32 and f64
instances, the 3D biharmonic's) and the 3D block entry
``stencil3d_block`` (apply, residual, sweep, sweep from zero; 1 to 3
fields). Every case skips without a CUDA device.

The file imports nothing of JAX, so it also runs on a machine that has a
card and no JAX, without the package's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_card.py -q
"""
from functools import partial

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
TOL64 = 1e-12  # the same for the f64 instances (fma against mul + add)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)


def _close(got, ref):
    tol = TOL64 if ref.dtype == torch.float64 else TOL
    return float((got - ref).abs().max()) <= tol * float(ref.abs().max())


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
@pytest.mark.parametrize("shape", [(17, 17), (40, 200), (129, 129)])
@pytest.mark.parametrize("dtype,radius", [(torch.float32, 3),
                                          (torch.float64, 1),
                                          (torch.float64, 2),
                                          (torch.float64, 3),
                                          (torch.float32, 4),
                                          (torch.float64, 4),
                                          (torch.float32, 5),
                                          (torch.float64, 5)])
def test_torch_stencil_instances_on_card(dtype, radius, shape):
    """The radius-3, radius-4, radius-5 (runtime-radius) and f64 instances
    of the 2D scalar entries (the biharmonic's on the quadratic, cubic and
    quartic nets; at r = 5 a smoothing call is one launch a pass):
    stencil_mv,
    jacobi_smooth, the residual of
    stencil_mv_block and smooth (two sweeps from zero with the residual,
    two from x) against their plain versions, 1e-4 in f32 and 1e-12 in
    f64, in the operands' dtype."""
    dev = _card()
    rng = np.random.default_rng(radius)
    n, m2 = shape[0] * shape[1], (2 * radius + 1) ** 2
    C = torch.tensor(rng.uniform(-0.1, 0.1, (m2, *shape)), dtype=dtype,
                     device=dev)
    C[m2 // 2] += 4.0
    x, b = (torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)
            for _ in range(2))
    invd = (1.0 / C[m2 // 2]).reshape(-1).contiguous()
    tol = 1e-12 if dtype == torch.float64 else TOL

    def close(got, ref):
        assert got.dtype == dtype
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())

    n0 = sk.launches()
    close(sk.stencil_mv(C, x, shape, radius),
          sk.stencil_mv_plain(C, x, shape, radius))
    close(sk.jacobi_smooth(C, invd, b, x, 0.67, shape, radius),
          sk.jacobi_smooth_plain(C, invd, b, x, 0.67, shape, radius))
    close(sk.stencil_mv_block(C, x, shape, radius, b=b),
          sk.residual_plain(C, b, x, shape, radius))
    for start in (None, x):
        got = sk.smooth(C, invd, b, start, 0.67, 2, shape, radius,
                        with_residual=start is None)
        ref = sk.smooth_plain(C, invd, b, start, 0.67, 2, shape, radius,
                              with_residual=start is None)
        for g, r_ in zip(*((got, ref) if start is None else ((got,),
                                                             (ref,)))):
            close(g, r_)
    torch.cuda.synchronize()
    n1 = sk.launches()
    assert n1["stencil_mv"] == n0["stencil_mv"] + 1
    assert n1["stencil_mv_block"] > n0["stencil_mv_block"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 17), (33, 129), (65, 65)])
def test_torch_block_apply_on_card(shape):
    """The 2D block apply on the card is one launch of the block kernel and
    equals the plain block apply, in f32 and in f64 (1e-12); a block
    operator in another dtype raises there."""
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
    y64 = StencilOperatorBlock2D(C.double(), shape, 2).mv(x.double())
    torch.cuda.synchronize()
    assert y64.dtype == torch.float64 and sk.launches()[
        "stencil_mv_block"] == before["stencil_mv_block"] + 2
    assert _close(y64, sk.stencil_mv_block_plain(C.double(), x.double(),
                                                 shape, 2))
    with pytest.raises(TypeError):
        StencilOperatorBlock2D(C.half(), shape, 2).mv(x.half())


def _operands3(shape, radius, dev, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    n = shape[0] * shape[1] * shape[2]

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    return (t(rng.standard_normal(((2 * radius + 1) ** 3, *shape))),
            t(rng.standard_normal(n)), t(rng.standard_normal(n)),
            t(rng.uniform(0.5, 2.0, n)), t(rng.standard_normal(n)))


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


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 11, 13), (13, 10, 17), (17, 17, 17),
                                   (33, 33, 33), (65, 65, 65)])
def test_torch_stencil3d_radius3_on_card(shape, dtype, radius):
    """The radius-3 (343-tap), radius-4 (729-tap) and radius-5 (1,331-tap,
    runtime-radius) instances of
    stencil_mv3, jacobi_smooth3 and cheb_step3 (β = 0 and β ≠ 0), f32 and
    f64, at odd shapes and at the levels of the 3D biharmonic's 65³
    hierarchy, vs their plain versions (f32 1e-4, f64 1e-12 of max|y|), one
    launch each; StencilOperator3D on the card goes through them."""
    from iifea_tpu_torch.ops.stencil import StencilOperator3D

    dev = _card()
    r = radius
    C, x, b, invd, d = _operands3(shape, r, dev, 11, dtype)
    n0 = sk.launches()
    y = sk.stencil_mv3(C, x, shape, r)
    s = sk.jacobi_smooth3(C, invd, b, x, 0.67, shape, r)
    c0, dc0 = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, shape, r)
    c, dc = sk.cheb_step3(C, invd, b, x, d.clone(), 1.3, 0.45, shape, r)
    torch.cuda.synchronize()
    n1 = sk.launches()
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {
        "stencil_mv3": 1, "jacobi_smooth3": 1, "cheb_step3": 2}
    assert _close(y, sk.stencil_mv3_plain(C, x, shape, r))
    assert _close(s, sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape, r))
    for (got, dgot), beta, d_in in (((c0, dc0), 0.0, None),
                                    ((c, dc), 0.45, d)):
        ref, dref = sk.cheb_step3_plain(C, invd, b, x, d_in,
                                        1.7 if d_in is None else 1.3, beta,
                                        shape, r)
        assert _close(got, ref) and _close(dgot, dref)
    S = StencilOperator3D(C, shape, r)
    assert _close(S.mv(x), y) and sk.launches()["stencil_mv3"] == \
        n1["stencil_mv3"] + 1


@pytest.mark.gpu
def test_torch_stencil3d_refuses_other_instances_on_card():
    """A CUDA operator no 3D instance takes raises (another dtype, radius 0;
    never the plain version); f64 at radius 1, 2 through StencilOperator3D
    and radius 3 and 5 through the block entry, refused before, launch
    their instances and equal the plain versions."""
    from iifea_tpu_torch.ops.stencil import StencilOperator3D

    dev = _card()
    for radius in (1, 2):
        C, x, b, invd, _ = _operands3((9, 9, 9), radius, dev, 3,
                                      torch.float64)
        S = StencilOperator3D(C, (9, 9, 9), radius)
        n0 = sk.launches()
        assert _close(S.mv(x), sk.stencil_mv3_plain(C, x, (9, 9, 9), radius))
        assert _close(S.jacobi_smooth(invd, b, x, 0.67),
                      sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, (9, 9, 9),
                                              radius))
        assert sk.launches()["stencil_mv3"] == n0["stencil_mv3"] + 1
        with pytest.raises(TypeError):
            StencilOperator3D(C.half(), (9, 9, 9), radius).mv(x.half())
    C, x, *_ = _operands3((9, 9, 9), 3, dev, 3)
    assert _close(sk.stencil3d_block(C, x, (9, 9, 9), 3),
                  sk.stencil_mv3_plain(C, x, (9, 9, 9), 3))
    C5, x5, *_ = _operands3((9, 9, 9), 5, dev, 3)
    assert _close(sk.stencil3d_block(C5, x5, (9, 9, 9), 5),
                  sk.stencil_mv3_plain(C5, x5, (9, 9, 9), 5))
    with pytest.raises(ValueError, match=">= 1"):
        sk.stencil3d_block(C5[:1], x5, (9, 9, 9), 0)


def _block_operands3(n_fields, radius, shape, dev, seed,
                     dtype=torch.float32):
    """A diagonally dominant nF-field 3D operator (n_fields = 0: scalar
    planes and the flat 1/diag), its smoother blocks, b and x on the card,
    in ``dtype``."""
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m3, *shape))
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    n = nF * shape[0] * shape[1] * shape[2]
    C, b, x = (torch.from_numpy(np.asarray(a)).to(dev, dtype)
               for a in (C, rng.standard_normal(n), rng.standard_normal(n)))
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
    """stencil3d_block's four passes on the card: one launch each, counted
    under its pass's name, equal to the plain versions at 1e-4·max|y|,
    bitwise repeatable; with scalar planes equal to stencil_mv3 and
    jacobi_smooth3 at the same tolerance."""
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
    names = [sk.PASS3_NAMES[p, n_fields > 1]
             for p in ("apply", "residual", "sweep", "zero")]
    assert sk.launches() == {**before, **{k: before[k] + 1 for k in names}}
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
    one ``smooth3`` launch a call where the plan holds the level in one
    launch, else one launch a pass (the sweep from zero, the sweeps, the
    residual); both equal to the CPU operator's plain versions; an f64
    operator runs its f64 instances, one in another dtype raises."""
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
    fused = sk._plan3(shape, 2, 3, dev.index or 0)[1] > 0
    passes = {} if fused else {"zero3_block": 1, "sweep3_block": 3,
                               "residual3_block": 1}
    assert sk.launches() == {
        **before, "stencil3d_block": before["stencil3d_block"] + 1,
        "smooth3": before["smooth3"] + 2 * fused,
        **{k: before[k] + n for k, n in passes.items()}}
    xs_ref, r_ref = S_cpu.smooth(binv.cpu(), b.cpu(), None, 1.0, 2,
                                 with_residual=True)
    assert _close(y.cpu(), S_cpu.mv(x.cpu()))
    assert _close(xs.cpu(), xs_ref) and _close(r.cpu(), r_ref)
    assert _close(xp.cpu(), S_cpu.smooth(binv.cpu(), b.cpu(), x.cpu(), 1.0,
                                         2))
    assert _close(StencilOperatorBlock3D(C.double(), shape, 2).mv(x.double()),
                  sk.apply3_block_plain(C.double(), x.double(), shape, 2))
    with pytest.raises(TypeError):
        StencilOperatorBlock3D(C.half(), shape, 2).mv(x.half())


# the block instances added for the f64, radius-3, radius-4 and radius-5
# (runtime-radius) multigrid routes: (dim, fields, radius, dtype) beside the
# f32 r = 1, 2 ones above
NEW_BLOCK = ([(d, nf, r, torch.float64) for d in (2, 3) for nf in (2, 3)
              for r in (1, 2, 3, 4, 5)]
             + [(d, nf, r, torch.float32) for d in (2, 3) for nf in (2, 3)
                for r in (3, 4, 5)])


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n_fields,radius,dtype", NEW_BLOCK)
def test_torch_block_instances_on_card(dim, n_fields, radius, dtype):
    """The f64 block instances (r = 1–5) and the radius-3 to radius-5 f32
    ones, 2D and 3D, 2 and 3 fields: the apply, the residual, the sweep and the sweep
    from zero, one launch each, and a level's smoothing call (two sweeps
    from zero with the residual) against the plain versions (f32 1e-4, f64
    1e-12), in the operands' dtype."""
    dev = _card()
    shape = (19, 37) if dim == 2 else (11, 9, 14)
    if dim == 2:
        rng = np.random.default_rng(radius * 10 + n_fields)
        m2 = (2 * radius + 1) ** 2
        C = rng.uniform(-0.1, 0.1, (n_fields, n_fields, m2, *shape))
        for f in range(n_fields):
            C[f, f, m2 // 2] += 4.0
        n = n_fields * shape[0] * shape[1]
        C, b, x = (torch.from_numpy(np.asarray(a)).to(dev, dtype)
                   for a in (C, rng.standard_normal(n),
                             rng.standard_normal(n)))
        binv = tmg._point_binv(StencilOperatorBlock2D(C, shape, radius))
        apply = partial(sk.stencil_mv_block, C, x, shape, radius)
        resid = partial(sk.stencil_mv_block, C, x, shape, radius, b=b)
        sweep = partial(sk._sweep_cuda, C, binv, b, x, 0.8, shape, radius,
                        n_fields)
        zero = partial(sk._sweep_cuda, C, binv, b, None, 0.8, shape, radius,
                       n_fields, sk._SWEEP_FROM_ZERO)
        level = partial(sk.smooth, C, binv, b, None, 0.8, 2, shape, radius,
                        True)
        level_ref = partial(sk.smooth_plain, C, binv, b, None, 0.8, 2, shape,
                            radius, True)
        sweep_ref = sk.sweep_plain(C, binv, b, x, 0.8, shape, radius)
        zero_ref = sk.smooth_plain(C, binv, b, None, 0.8, 1, shape, radius)
        y_ref = sk.apply_plain(C, x, shape, radius)
    else:
        C, binv, b, x = _block_operands3(n_fields, radius, shape, dev,
                                         radius * 10 + n_fields, dtype)
        apply = partial(sk.stencil3d_block, C, x, shape, radius)
        resid = partial(sk.stencil3d_block, C, x, shape, radius, b=b)
        sweep = partial(sk.stencil3d_block, C, x, shape, radius, b=b,
                        binv=binv, omega=0.8)
        zero = partial(sk.stencil3d_block, C, None, shape, radius, b=b,
                       binv=binv, omega=0.8)
        level = partial(sk.smooth3, C, binv, b, None, [(0.8, 0.0)] * 2,
                        shape, radius, True)
        level_ref = partial(sk.smooth3_plain, C, binv, b, None,
                            [(0.8, 0.0)] * 2, shape, radius, True)
        sweep_ref = sk.sweep3_block_plain(C, binv, b, x, 0.8, shape, radius)
        zero_ref = sk.sweep3_block_plain(C, binv, b, None, 0.8, shape, radius)
        y_ref = sk.apply3_block_plain(C, x, shape, radius)
    before = sum(sk.launches().values())
    got = (apply(), resid(), sweep(), zero())
    torch.cuda.synchronize()
    assert sum(sk.launches().values()) == before + 4
    for g, ref in zip(got, (y_ref, b - y_ref, sweep_ref, zero_ref)):
        assert g.dtype == dtype and _close(g, ref)
    for g, ref in zip(level(), level_ref()):
        assert g.dtype == dtype and _close(g, ref)
