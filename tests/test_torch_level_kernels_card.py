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
from collections import Counter

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
@pytest.mark.parametrize("side", [513, 257, 129, 65, 33, 17])
def test_torch_three_field_levels_on_card(side):
    """The three-field radius-2 instances (the Taylor-Green cycle's) at its
    level shapes: the apply, the residual, one sweep, the sweep from zero
    and the V-cycle's two smoothing calls (ν = 2; from zero with the
    residual, from x) by every route the plan allows, against the plain
    versions at 1e-4·max|y|; the fused launch bitwise equal to the
    passes."""
    shape = (side, side)
    C, binv, b, x = _card_operands(3, 2, shape, 14)
    ref = sk.apply_plain(C, x, shape, 2)
    lim = 1e-4 * float(ref.abs().max())
    assert float((sk.stencil_mv_block(C, x, shape, 2) - ref).abs().max()) \
        <= lim
    res = sk.stencil_mv_block(C, x, shape, 2, b=b)
    assert float((res - (b - ref)).abs().max()) <= lim
    for start in (x, None):
        one = sk._smooth_cuda(sk.PER_PASS, C, binv, b, start, 0.8, 1, shape,
                              2, 3, False)
        one_ref = sk.smooth_plain(C, binv, b, start, 0.8, 1, shape, 2)
        assert float((one - one_ref).abs().max()) <= (
            1e-4 * float(one_ref.abs().max()))
    routes = [sk.PER_PASS]
    if sk._smooth_route(shape, 2, 3, 0) == sk.GRID:
        routes.append(sk.GRID)
    for start, with_residual in ((None, True), (x, False)):
        ref = _tuple(sk.smooth_plain(C, binv, b, start, 0.8, 2, shape, 2,
                                     with_residual))
        outs = [_tuple(sk._smooth_cuda(route, C, binv, b, start, 0.8, 2,
                                       shape, 2, 3, with_residual))
                for route in routes]
        torch.cuda.synchronize()
        for out in outs:
            for a, a_ref, a_pass in zip(out, ref, outs[0]):
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


# the runtime-radius level launches (r >= 5): radii, field counts (0: scalar
# planes), dtypes; a 2D and a 3D level shape whose tiles or blocks are all
# co-resident at every one of them, the 3D one ending its (j, k) plane in a
# ragged run
RN_LEVEL_CASES = [(r, nf, dt) for r in (5, 6, 7) for nf in (0, 1, 2, 3)
                  for dt in (torch.float32, torch.float64)]
RN_LEVEL_SHAPE2 = (37, 45)
RN_LEVEL_SHAPE3 = (9, 11, 13)


def _card_operands2(n_fields, radius, shape, dtype, seed):
    """``_card_operands`` in ``dtype``."""
    C, binv, b, x = _card_operands(n_fields, radius, shape, seed)
    return tuple(t.to(dtype) for t in (C, binv, b, x))


@pytest.mark.gpu
@pytest.mark.parametrize("radius,n_fields,dtype", RN_LEVEL_CASES)
def test_torch_smooth_rn_level_on_card(radius, n_fields, dtype):
    """smooth at r = 5-7 (the runtime-radius level kernel): the plan gives
    the co-resident level one launch; for ν = 1, 2, 3 from x and from
    zero, with and without the residual, the fused call is one ``smooth``
    launch, bitwise equal to the per-pass route and to the routed call,
    and within 1e-4 (f32) / 1e-12 (f64) of the plain version."""
    shape = RN_LEVEL_SHAPE2
    C, binv, b, x = _card_operands2(n_fields, radius, shape, dtype,
                                    90 + radius + n_fields)
    nF = max(n_fields, 1)
    f64 = dtype == torch.float64
    assert sk._smooth_route(shape, radius, nF, 0, f64) == sk.GRID
    for sweeps in (1, 2, 3):
        for start in (x, None):
            for with_residual in (False, True):
                args = (C, binv, b, start, 0.8, sweeps, shape, radius)
                ref = sk.smooth_plain(*args, with_residual)
                per_pass = sk._smooth_cuda(sk.PER_PASS, *args, nF,
                                           with_residual)
                before = sk.launches()
                fused = sk._smooth_cuda(sk.GRID, *args, nF, with_residual)
                assert sk.launches() == {**before, "smooth":
                                         before["smooth"] + 1}
                routed = sk.smooth(*args, with_residual)
                torch.cuda.synchronize()
                for a, a_ref, a_pass, a_routed, scale in zip(
                        _tuple(fused), _tuple(ref), _tuple(per_pass),
                        _tuple(routed), (None, b)):
                    assert _err_ok(a, a_ref, dtype, scale)
                    assert torch.equal(a, a_pass)
                    assert torch.equal(a, a_routed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_fields", [0, 3])
def test_torch_smooth_rn_refuses_a_level_that_does_not_fit(n_fields, dtype):
    """At r = 5 a level with more tiles than are co-resident (1025²) takes
    one launch per pass, and its forced fused launch raises."""
    shape = (1025, 1025)
    C, binv, b, x = _card_operands2(n_fields, 5, shape, dtype, 15)
    nF = max(n_fields, 1)
    assert sk._smooth_route(shape, 5, nF, 0,
                            dtype == torch.float64) == sk.PER_PASS
    with pytest.raises(RuntimeError, match="stencil2d_smooth"):
        sk._smooth_cuda(sk.GRID, C, binv, b, x, 0.8, 2, shape, 5, nF, True)


# -- 3D: smooth3 (a level's sweeps or Chebyshev steps and residual) --------

# the 3D cycles' small level shapes, one non-cube, and one whose
# (j, k) plane ends in a ragged run (19·37 = 703 points: 2 runs of 256 and
# one of 191)
SHAPES3 = [(13, 13, 13), (17, 17, 17), (25, 25, 25), (33, 33, 33),
           (13, 10, 17), (11, 19, 37)]
# (fields, radius, dtype, Chebyshev): the block instances (fields ≥ 1),
# and the scalar ones (fields 0) with Jacobi sweeps and Chebyshev steps,
# f32 and f64 at radius 1 to 4 and at radius 5 (the runtime-radius
# instances, one launch a pass)
INSTANCES3 = ([(nf, r, dt, False) for dt in (torch.float32, torch.float64)
               for nf in (1, 2, 3) for r in (1, 2, 3, 4, 5)]
              + [(0, r, dt, cheb) for dt in (torch.float32, torch.float64)
                 for r in (1, 2, 3, 4, 5) for cheb in (False, True)])
STEPS3 = [(0.9, 0.0), (1.2, 0.35), (1.1, 0.5)]


def _card_operands3(n_fields, radius, shape, dtype, seed):
    """A diagonally dominant 3D operator on the card (n_fields = 0: scalar
    planes and the flat 1/diag), its smoother blocks, b and x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    nF = max(n_fields, 1)
    n = nF * shape[0] * shape[1] * shape[2]
    C = rng.uniform(-0.1, 0.1, (nF, nF, m3, *shape))
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    C, b, x = (torch.from_numpy(a).to(dev, dtype)
               for a in (C, rng.standard_normal(n), rng.standard_normal(n)))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m3 // 2]).reshape(-1).contiguous(), b, x
    return C, tmg._point_binv(StencilOperatorBlock3D(C, shape, radius)), b, x


def _err_ok(a, ref, dtype, scale=None):
    """f32 within 1e-4·max|scale| (the sum order), f64 within 1e-12; scale
    is ref unless given (a smoothed residual is held to the size of its
    terms, b: it is small by cancellation)."""
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    scale = ref if scale is None else scale
    return float((a - ref).abs().max()) <= tol * float(scale.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES3)
@pytest.mark.parametrize("n_fields,radius,dtype,cheb", INSTANCES3)
def test_torch_smooth3_entry_on_card(n_fields, radius, dtype, cheb, shape):
    """smooth3 on the card, ν = 1, 2, 3, from x and from zero, with and
    without the residual: the per-pass route and the routed call equal the
    plain version (f32 1e-4, f64 1e-12 relative); the per-pass route's
    launches are counted under their passes' names; the fused route, where
    the level's blocks are co-resident, is one launch a call and bitwise
    equal to the per-pass launches, and is refused where they are not."""
    C, binv, b, x = _card_operands3(n_fields, radius, shape, dtype,
                                    7 * radius + n_fields)
    nF = max(n_fields, 1)
    split, _, level_blocks, _ = sk._plan3(shape, radius, nF, 0,
                                          dtype == torch.float64)
    runs = -(-shape[1] * shape[2] // (256 // split))
    fits = runs * shape[0] <= level_blocks
    for sweeps in (1, 2, 3):
        steps = STEPS3[:sweeps]
        for start in (x, None):
            for with_residual in (False, True):
                args = (C, binv, b, start, steps, shape, radius)
                ref = sk.smooth3_plain(*args, with_residual, cheb)
                before = sk.launches()
                per_pass = sk._smooth3_cuda(sk.PER_PASS, *args, nF,
                                            with_residual, cheb)
                made = Counter(
                    sk.PASS3_NAMES[
                        p if isinstance(p, str)
                        else "cheb" if cheb else "sweep", nF > 1]
                    for p in sk.passes3(sweeps, start is None, with_residual))
                assert sk.launches() == {**before, **{
                    k: before[k] + n for k, n in made.items()}}
                got = [per_pass, sk.smooth3(*args, with_residual, cheb)]
                if fits:
                    before = sk.launches()
                    got.append(sk._smooth3_cuda(sk.GRID, *args, nF,
                                                with_residual, cheb))
                    assert sk.launches() == {**before, "smooth3":
                                             before["smooth3"] + 1}
                else:
                    # the library's refusal (the level launch stages every
                    # field's planes at r <= 4, none from r = 5)
                    with pytest.raises(RuntimeError, match="stencil3d_level"):
                        sk._smooth3_cuda(
                            sk.GRID, *args, nF, with_residual, cheb,
                            staging=sk.UNSTAGED if radius >= sk.RN_RADIUS
                            else sk.ALL_FIELDS)
                torch.cuda.synchronize()
                for out in got:
                    for a, a_ref, a_pass, scale in zip(
                            _tuple(out), _tuple(ref), _tuple(per_pass),
                            (None, b)):
                        assert _err_ok(a, a_ref, dtype, scale)
                        assert torch.equal(a, a_pass)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES3)
@pytest.mark.parametrize("n_fields,radius,dtype", sorted(
    {(nf, r, dt) for nf, r, dt, _ in INSTANCES3}, key=str))
def test_torch_stencil3d_passes_on_card(n_fields, radius, dtype, shape):
    """Each pass of the marching kernel through its wrapper (scalar:
    jacobi_smooth3, cheb_step3 with β = 0 and β ≠ 0; block: stencil3d_block
    apply, residual, sweep, sweep from zero) against the plain version, and
    a sweep at every split the shape can take."""
    C, binv, b, x = _card_operands3(n_fields, radius, shape, dtype,
                                    11 * radius + n_fields)
    nF = max(n_fields, 1)
    a = (shape, radius)
    if n_fields == 0:
        d = torch.randn_like(x)
        got = {"jacobi": sk.jacobi_smooth3(C, binv, b, x, 0.7, *a),
               "cheb0": sk.cheb_step3(C, binv, b, x, None, 1.3, 0.0, *a)[0],
               "cheb": sk.cheb_step3(C, binv, b, x, d.clone(), 1.3, 0.45,
                                     *a)[0]}
        ref = {"jacobi": sk.jacobi_smooth3_plain(C, binv, b, x, 0.7, *a),
               "cheb0": sk.cheb_step3_plain(C, binv, b, x, None, 1.3, 0.0,
                                            *a)[0],
               "cheb": sk.cheb_step3_plain(C, binv, b, x, d, 1.3, 0.45,
                                           *a)[0]}
    else:
        got = {"apply": sk.stencil3d_block(C, x, *a),
               "residual": sk.stencil3d_block(C, x, *a, b=b),
               "sweep": sk.stencil3d_block(C, x, *a, b=b, binv=binv,
                                           omega=0.8),
               "zero": sk.stencil3d_block(C, None, *a, b=b, binv=binv,
                                          omega=0.8)}
        ref = {"apply": sk.apply3_block_plain(C, x, *a),
               "residual": sk.residual3_block_plain(C, b, x, *a),
               "sweep": sk.sweep3_block_plain(C, binv, b, x, 0.8, *a),
               "zero": sk.sweep3_block_plain(C, binv, b, None, 0.8, *a)}
    torch.cuda.synchronize()
    for k in got:
        assert _err_ok(got[k], ref[k], dtype), k
    sweep = sk.sweep3_block_plain(C, binv, b, x, 0.8, *a)
    for split in (1, 2, 4, 8, 16):
        if split >= 2 * nF * (2 * radius + 1):
            break
        y = sk._pass3(sk._SWEEP, C, x, b, binv, *a, nF, s0=0.8, split=split)
        torch.cuda.synchronize()
        assert _err_ok(y, sweep, dtype), split


# the level shapes of the 3D paths: elasticity (3 fields, r = 2), Poisson
# (scalar f32 r = 2), biharmonic (scalar f64 r = 3)
PATH_LEVELS3 = {
    "elasticity": (3, 2, False, [(97,) * 3, (49,) * 3, (25,) * 3,
                                 (13,) * 3]),
    "poisson": (1, 2, False, [(105,) * 3, (53,) * 3, (27,) * 3]),
    "biharmonic": (1, 3, True, [(65,) * 3, (33,) * 3, (17,) * 3]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATH_LEVELS3))
def test_torch_plan3_at_path_levels(path):
    """The plan at every level shape of the three 3D paths: a power-of-two
    split, and the level launch only where its blocks are co-resident — on
    the smallest level of each path but not the largest; a level launch
    that does not fit is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    nF, radius, f64, shapes = PATH_LEVELS3[path]
    plans = [sk._plan3(sh, radius, nF, 0, f64) for sh in shapes]
    for sh, (split, level, level_blocks, staging) in zip(shapes, plans):
        assert split in (1, 2, 4, 8, 16) and level in (0, 1)
        assert staging == sk.ALL_FIELDS
        runs = -(-sh[1] * sh[2] // (256 // split))
        assert level_blocks > 0
        if level:
            assert runs * sh[0] <= level_blocks
    assert plans[0][1] == 0
    assert plans[-1][1] == 1
    # the largest level forced into one launch
    sh, dt = shapes[0], torch.float64 if f64 else torch.float32
    n = sh[0] * sh[1] * sh[2]
    m3 = (2 * radius + 1) ** 3
    C = torch.zeros((m3, *sh) if nF == 1 else (nF, nF, m3, *sh), dtype=dt,
                    device="cuda")
    binv = torch.zeros((n,) if nF == 1 else (nF, nF, n), dtype=dt,
                       device="cuda")
    b = torch.zeros(nF * n, dtype=dt, device="cuda")
    with pytest.raises(RuntimeError, match="stencil3d_level"):
        sk._smooth3_cuda(sk.GRID, C, binv, b, torch.zeros_like(b), STEPS3[:2],
                         sh, radius, nF, True, False)


@pytest.mark.gpu
def test_torch_smooth3_refuses_other_instances_on_card():
    """Instances that do not exist raise on the card too: the Chebyshev
    smoother on block planes, planes in another dtype than f32 and f64,
    radius 0. f64 block planes and f64 scalar planes at radius 2, and
    radius 5 (the runtime-radius instances: a level's call in one
    cooperative launch where the plan says so), refused before, run their
    instances."""
    C, binv, b, x = _card_operands3(2, 1, (9, 9, 9), torch.float32, 5)
    with pytest.raises(ValueError, match="scalar planes"):
        sk.smooth3(C, binv, b, x, STEPS3[:1], (9, 9, 9), 1, cheb=True)
    with pytest.raises(TypeError, match="float32 or float64"):
        sk.smooth3(C.half(), binv.half(), b.half(), x.half(),
                   STEPS3[:1], (9, 9, 9), 1)
    C64, binv64, b64, x64 = (t.double() for t in (C, binv, b, x))
    assert _err_ok(sk.smooth3(C64, binv64, b64, x64, STEPS3[:1], (9, 9, 9),
                              1),
                   sk.smooth3_plain(C64, binv64, b64, x64, STEPS3[:1],
                                    (9, 9, 9), 1), torch.float64)
    Cs, invd, bs, xs = _card_operands3(0, 2, (9, 9, 9), torch.float64, 6)
    assert _err_ok(sk.smooth3(Cs, invd, bs, xs, STEPS3[:1], (9, 9, 9), 2),
                   sk.smooth3_plain(Cs, invd, bs, xs, STEPS3[:1], (9, 9, 9),
                                    2), torch.float64)
    C3, binv3, b3, x3 = _card_operands3(1, 1, (9, 9, 9), torch.float32, 7)
    with pytest.raises(ValueError, match=">= 1"):
        sk.smooth3(C3, binv3, b3, x3, STEPS3[:1], (9, 9, 9), 0)
    C5, binv5, b5, x5 = _card_operands3(1, 5, (9, 9, 9), torch.float32, 8)
    assert _err_ok(sk.smooth3(C5, binv5, b5, x5, STEPS3[:2], (9, 9, 9), 5),
                   sk.smooth3_plain(C5, binv5, b5, x5, STEPS3[:2], (9, 9, 9),
                                    5), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("radius,n_fields,dtype", RN_LEVEL_CASES)
def test_torch_smooth3_rn_level_on_card(radius, n_fields, dtype):
    """smooth3 at r = 5-7 (march_rn_level_kernel) on a level whose blocks
    are all co-resident: for ν = 1, 2, 3 sweeps (scalar planes also
    Chebyshev steps) from x and from zero, with and without the residual,
    the fused call is one ``smooth3`` launch, bitwise equal to the per-pass
    route and to the routed call (one launch where the plan's rule gives
    it), and within 1e-4 (f32) / 1e-12 (f64) of the plain version."""
    shape = RN_LEVEL_SHAPE3
    C, binv, b, x = _card_operands3(n_fields, radius, shape, dtype,
                                    100 + radius + n_fields)
    nF = max(n_fields, 1)
    plan = sk._plan3(shape, radius, nF, 0, dtype == torch.float64)
    runs = -(-shape[1] * shape[2] // (256 // plan[0]))
    assert runs * shape[0] <= plan[2] and plan[3] == sk.UNSTAGED
    for cheb in (False, True) if n_fields == 0 else (False,):
        for sweeps in (1, 2, 3):
            steps = STEPS3[:sweeps]
            for start in (x, None):
                for with_residual in (False, True):
                    args = (C, binv, b, start, steps, shape, radius)
                    ref = sk.smooth3_plain(*args, with_residual, cheb)
                    per_pass = sk._smooth3_cuda(sk.PER_PASS, *args, nF,
                                                with_residual, cheb)
                    before = sk.launches()
                    fused = sk._smooth3_cuda(sk.GRID, *args, nF,
                                             with_residual, cheb)
                    assert sk.launches() == {**before, "smooth3":
                                             before["smooth3"] + 1}
                    routed = sk.smooth3(*args, with_residual, cheb)
                    torch.cuda.synchronize()
                    for a, a_ref, a_pass, a_routed, scale in zip(
                            _tuple(fused), _tuple(ref), _tuple(per_pass),
                            _tuple(routed), (None, b)):
                        assert _err_ok(a, a_ref, dtype, scale)
                        assert torch.equal(a, a_pass)
                        assert torch.equal(a, a_routed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_fields", [0, 3])
def test_torch_smooth3_rn_refuses_a_level_that_does_not_fit(n_fields, dtype):
    """At r = 5 a level whose blocks are not all co-resident (65³) takes
    one launch a pass, its forced one launch raises, and asking that
    launch for a staged route is a ValueError."""
    shape = (65, 65, 65)
    C, binv, b, x = _card_operands3(n_fields, 5, shape, dtype, 16)
    nF = max(n_fields, 1)
    plan = sk._plan3(shape, 5, nF, 0, dtype == torch.float64)
    assert plan[1] == 0
    with pytest.raises(RuntimeError, match="stencil3d_level"):
        sk._smooth3_cuda(sk.GRID, C, binv, b, x, STEPS3[:2], shape, 5, nF,
                         True, False)
    with pytest.raises(ValueError, match="one launch"):
        sk._smooth3_cuda(sk.GRID, C, binv, b, x, STEPS3[:2], shape, 5, nF,
                         True, False, staging=sk.ALL_FIELDS)


# -- 3D: the per-field staging (f64, r = 4, 2 and 3 fields) -----------------


@pytest.mark.gpu
@pytest.mark.parametrize("n_fields,shape", [(3, (65, 65, 65)),
                                            (3, (13, 10, 17)),
                                            (2, (11, 19, 37)),
                                            (3, (17, 17, 17)),
                                            (3, (9, 9, 9))])
def test_torch_stencil3d_per_field_staging_bitwise(n_fields, shape):
    """f64, r = 4, where a block holds every field's x planes: each pass of
    stencil3d_block (apply, residual, sweep, sweep from zero) with one
    field's planes staged at a time equals the all-field staging bitwise at
    the plan's split, as does a level's smoothing call (two sweeps from
    zero with the residual) by one launch a pass. A level's one launch
    stages every field: where the plan gives the level one, it equals the
    per-pass route, and asking it for the per-field staging is refused."""
    C, binv, b, x = _card_operands3(n_fields, 4, shape, torch.float64,
                                    40 + n_fields)
    split, level, _, staging = sk._plan3(shape, 4, n_fields, 0, True)
    assert staging == sk.ALL_FIELDS
    passes = [(sk._APPLY, x, None), (sk._RESIDUAL, x, None),
              (sk._SWEEP, x, binv), (sk._ZERO, None, binv)]
    for pass_, start, bi in passes:
        got = [sk._pass3(pass_, C, start, b, bi, shape, 4, n_fields,
                         omega0=0.8, s0=0.8, split=split, staging=st)
               for st in (sk.ALL_FIELDS, sk.PER_FIELD)]
        assert torch.equal(got[0], got[1]), pass_
    steps = [(0.8, 0.0)] * 2
    ref = sk.smooth3_plain(C, binv, b, None, steps, shape, 4, True)

    def smooth(route, st):
        return sk._smooth3_cuda(route, C, binv, b, None, steps, shape, 4,
                                n_fields, True, False, split=split,
                                staging=st)

    per_pass = [smooth(sk.PER_PASS, st)
                for st in (sk.ALL_FIELDS, sk.PER_FIELD)]
    for a, a_pf, a_ref, scale in zip(*per_pass, ref, (None, b)):
        assert torch.equal(a, a_pf)
        assert _err_ok(a_pf, a_ref, torch.float64, scale)
    if level:
        for a, a_grid in zip(per_pass[0], smooth(sk.GRID, sk.ALL_FIELDS)):
            assert torch.equal(a, a_grid)
    with pytest.raises(ValueError, match="every field"):
        smooth(sk.GRID, sk.PER_FIELD)


@pytest.mark.gpu
@pytest.mark.parametrize("side,staging", [(65, 0), (73, 1), (97, 1)])
def test_torch_plan3_per_field_from_73(side, staging):
    """f64, r = 4, three fields: the plan stages every field's x planes at
    65³ and one field's at a time from 73³ on (3 × 97³: the cubic 3D
    elasticity at the 3D elasticity cell's width), where a block cannot
    hold every field's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    shape = (side,) * 3
    assert sk._plan3(shape, 4, 3, 0, True)[3] == staging


# -- 3D: the runtime-radius marching kernel and its unstaged route ----------

# (radius, shape, fields): r = 5-7 at two odd shapes (the second's (j, k)
# plane ends in a ragged run), scalar planes and 2-3 fields
RN3_CASES = [(r, sh, nf) for r in (5, 6, 7)
             for sh in ((9, 11, 13), (13, 10, 17)) for nf in (0, 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radius,shape,n_fields", RN3_CASES)
def test_torch_stencil3d_rn_stagings_on_card(radius, shape, n_fields, dtype):
    """The runtime-radius marching kernel (r = 5-7): the plan reads x
    through the read-only cache (its only route) and gives a level's
    smoothing call one launch only where the level's blocks are
    co-resident; the apply, residual, sweep and
    (scalar planes) Chebyshev step at the plan's split and at 16 equal
    their plain versions (f32 1e-4, f64 1e-12), and a second launch
    repeats each bitwise."""
    C, binv, b, x = _card_operands3(n_fields, radius, shape, dtype,
                                    50 + 3 * radius + n_fields)
    nF = max(n_fields, 1)
    plan = sk._plan3(shape, radius, nF, 0, dtype == torch.float64)
    assert plan[3] == sk.UNSTAGED and plan[2] > 0
    runs = -(-shape[1] * shape[2] // (256 // plan[0]))
    assert not plan[1] or runs * shape[0] <= plan[2]
    y_ref = sk.apply3_block_plain(C, x, shape, radius)
    refs = {sk._APPLY: y_ref, sk._RESIDUAL: b - y_ref,
            sk._SWEEP: sk.sweep3_block_plain(C, binv, b, x, 0.8, shape,
                                             radius)}
    d = torch.randn_like(x)
    if n_fields == 0:
        refs[sk._CHEB] = sk.cheb_step3_plain(C, binv, b, x, d, 1.3, 0.45,
                                             shape, radius)[0]
    for pass_, ref in refs.items():
        for split in sorted({plan[0], 16}):
            got = [sk._pass3(pass_, C, x, b, binv, shape, radius, nF,
                             s0=1.3 if pass_ == sk._CHEB else 0.8, s1=0.45,
                             d=d.clone(), split=split)
                   for _ in range(2)]
            torch.cuda.synchronize()
            assert _err_ok(got[0], ref, dtype), (pass_, split)
            assert torch.equal(got[0], got[1]), (pass_, split)


@pytest.mark.gpu
@pytest.mark.parametrize("radius,n_fields", [(4, 0), (4, 3), (6, 0),
                                             (6, 2)])
def test_torch_stencil3d_unstaged_only_on_card(radius, n_fields):
    """f64 at (5, 6, 700), a long k row: no block stages even one field's x
    planes at r = 4 or 6 (at r = 4 the fixed-radius plan answers "too
    wide"), so the plan gives the runtime-radius kernel's unstaged route,
    and the apply (stencil_mv3 on scalar planes), residual and sweep equal
    their plain versions (1e-12); ``solve_ksp``'s refusal takes the
    lattice."""
    from iifea_tpu_torch.solvers import ksp

    shape = (5, 6, 700)
    C, binv, b, x = _card_operands3(n_fields, radius, shape, torch.float64,
                                    60 + radius + n_fields)
    nF = max(n_fields, 1)
    assert sk._plan3(shape, radius, nF, 0, True)[3] == sk.UNSTAGED
    a = (shape, radius)
    before = sk.launches()
    y = (sk.stencil_mv3(C, x, *a) if n_fields == 0
         else sk.stencil3d_block(C, x, *a))
    got = {"apply": y, "residual": sk.stencil3d_block(C, x, *a, b=b),
           "sweep": sk.stencil3d_block(C, x, *a, b=b, binv=binv, omega=0.8)}
    torch.cuda.synchronize()
    assert sum(sk.launches().values()) == sum(before.values()) + 3
    y_ref = sk.apply3_block_plain(C, x, *a)
    ref = {"apply": y_ref, "residual": b - y_ref,
           "sweep": sk.sweep3_block_plain(C, binv, b, x, 0.8, *a)}
    for k in got:
        assert _err_ok(got[k], ref[k], torch.float64), k
    assert ksp._cuda_mg_refusal(shape, nF, radius, torch.float64) is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(13, 10, 17), (33, 33, 33)])
def test_torch_stencil_mv3_marching_apply_on_card(shape, radius, dtype):
    """stencil_mv3 is the marching kernel's apply pass at every radius: one
    launch, counted under ``stencil_mv3`` and not under ``apply3``, equal
    to the plain version and bitwise to the apply pass of stencil3d_block
    on the same scalar planes (counted under ``apply3``)."""
    C, _, _, x = _card_operands3(0, radius, shape, dtype, 70 + radius)
    before = sk.launches()
    y = sk.stencil_mv3(C, x, shape, radius)
    torch.cuda.synchronize()
    assert sk.launches() == {**before,
                             "stencil_mv3": before["stencil_mv3"] + 1}
    y_block = sk.stencil3d_block(C, x, shape, radius)
    assert sk.launches()["apply3"] == before["apply3"] + 1
    assert _err_ok(y, sk.stencil_mv3_plain(C, x, shape, radius), dtype)
    assert torch.equal(y, y_block)


# -- 3D: the taps outside the lattice are never read -------------------------

# (radius, fields): r = 2-7, scalar planes and 2-3 fields (the fixed-radius
# kernels at r <= 4 with every staging and a level's one launch, the
# runtime-radius one from 5 and its unstaged route at every radius)
PADDING_CASES = [(r, nf) for r in (2, 3, 4, 5, 6, 7) for nf in (0, 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radius,n_fields", PADDING_CASES)
def test_torch_stencil3d_padding_not_read_on_card(radius, n_fields, dtype):
    """With NaN in every tap whose x lies outside the lattice, each 3D
    marching route gives bitwise the output it gives with zeros there:
    every pass (apply, residual, sweep, sweep from zero, the Chebyshev
    step on scalar planes) staged (every field's planes, one field's at a
    time) and unstaged, at the plan's split and at 16, and a level's
    smoothing call in one launch where it fits (r <= 4 staging every
    field's planes, from r = 5 none); the outputs with zeros there equal
    the plain versions (f32 1e-4, f64 1e-12)."""
    shape = (13, 10, 17)
    C, binv, b, x = _card_operands3(n_fields, radius, shape, dtype,
                                    80 + 3 * radius + n_fields)
    nF = max(n_fields, 1)
    outside = sk.outside_taps(shape, radius, C.device)
    C[..., outside] = 0.0
    C_nan = C.clone()
    C_nan[..., outside] = float("nan")
    plan = sk._plan3(shape, radius, nF, 0, dtype == torch.float64)
    stagings = ([sk.ALL_FIELDS] + [sk.PER_FIELD] * (nF > 1)
                if radius <= 4 else [plan[3]]) + [sk.UNSTAGED]
    y_ref = sk.apply3_block_plain(C, x, shape, radius)
    refs = {sk._APPLY: y_ref, sk._RESIDUAL: b - y_ref,
            sk._SWEEP: sk.sweep3_block_plain(C, binv, b, x, 0.8, shape,
                                             radius),
            sk._ZERO: sk.sweep3_block_plain(C, binv, b, None, 0.8, shape,
                                            radius)}
    d = torch.randn_like(x)
    if n_fields == 0:
        refs[sk._CHEB] = sk.cheb_step3_plain(C, binv, b, x, d, 1.3, 0.45,
                                             shape, radius)[0]
    for split in sorted({plan[0], 16}):
        for st in dict.fromkeys(stagings):
            for pass_, ref in refs.items():
                def run(planes):
                    return sk._pass3(
                        pass_, planes, None if pass_ == sk._ZERO else x, b,
                        binv, shape, radius, nF, omega0=0.8,
                        s0=1.3 if pass_ == sk._CHEB else 0.8,
                        s1=0.45 if pass_ == sk._CHEB else 0.0, d=d.clone(),
                        split=split, staging=st)
                y = run(C)
                torch.cuda.synchronize()
                assert _err_ok(y, ref, dtype), (split, st, pass_)
                assert torch.equal(run(C_nan), y), (split, st, pass_)
    def level(planes):
        return sk._smooth3_cuda(sk.GRID, planes, binv, b, None, STEPS3[:2],
                                shape, radius, nF, True, n_fields == 0,
                                split=plan[0],
                                staging=sk.UNSTAGED if radius >= sk.RN_RADIUS
                                else sk.ALL_FIELDS)
    if plan[1]:
        for a, a_nan in zip(level(C), level(C_nan)):
            assert torch.equal(a, a_nan)
