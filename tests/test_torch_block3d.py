"""The port's 3D block (multi-field) path vs the JAX package, from
identical numpy state: ``StencilOperatorBlock3D`` (apply, diagonals, the
nF·(2r+1)³-colour probe of the assembled 3D elasticity operator), the plain
residual and sweep, ``_coarsen_block3`` and ``StencilMultigridBlock3D``.
f64: 1e-12 relative, the V-cycle 1e-10. The solves are in
test_torch_elasticity3d.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.stencil import StencilOperatorBlock3D as JBlock3
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.ops import multigrid as mg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D
from torch_elastic3_pair import elastic3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _random_pair(n_fields, radius, shape, seed, dominant=False):
    """The same random block planes as both packages' operators."""
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    if dominant:
        C = rng.uniform(-0.1, 0.1, (n_fields, n_fields, m3, *shape))
        for f in range(n_fields):
            C[f, f, m3 // 2] += 4.0
    else:
        C = rng.standard_normal((n_fields, n_fields, m3, *shape))
    return (StencilOperatorBlock3D(torch.from_numpy(C), shape, radius),
            JBlock3(jnp.asarray(C), shape, radius))


@pytest.mark.parametrize("shape", [(9, 9, 9), (7, 5, 9)])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("n_fields", [2, 3])
def test_torch_block3d_apply_and_diagonals(n_fields, radius, shape):
    """mv, diag and point_block_diag on random planes (garbage in the
    off-grid slots, which the zero-padded apply never reads); the f32
    apply on the CPU is the plain version and counts no launch."""
    S, S_j = _random_pair(n_fields, radius, shape, 31)
    x = np.random.default_rng(32).standard_normal(S.n)
    assert S.n == S_j.n and S.nn == S_j.nn
    assert _rel(S.mv(torch.from_numpy(x)), S_j.mv(jnp.asarray(x))) < 1e-12
    assert _rel(S.diag(), S_j.diag()) < 1e-12
    assert _rel(S.point_block_diag(), S_j.point_block_diag()) < 1e-12
    S32, x32 = S.to(torch.float32), torch.from_numpy(x).float()
    before = sk.launches()
    y32 = sk.stencil3d_block(S32.coeffs, x32, shape, radius)
    assert torch.equal(y32, S32.mv(x32)) and sk.launches() == before
    assert _rel(y32, S_j.mv(jnp.asarray(x))) < 1e-4


@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_torch_block3d_plain_residual_and_sweep(n_fields):
    """The plain residual and point-block sweep (from x and from zero)
    against the body of the reference's ``_smooth``; the operator's
    ``smooth`` against repeated sweeps; scalar planes against the scalar
    plain versions."""
    shape, r = (7, 5, 9), 2
    S, S_j = _random_pair(n_fields, r, shape, 33, dominant=True)
    rng = np.random.default_rng(34)
    b, x = rng.standard_normal(S.n), rng.standard_normal(S.n)
    binv, binv_j = mg._point_binv(S), jmg._point_binv(S_j)
    assert _rel(binv, binv_j) < 1e-12
    bt, xt = torch.from_numpy(b), torch.from_numpy(x)

    def sweep_j(xj):
        res = (jnp.asarray(b) - S_j.mv(xj)).reshape(n_fields, S.nn)
        return xj + 0.9 * jnp.einsum("abn,bn->an", binv_j, res).reshape(-1)

    assert _rel(sk.residual3_block_plain(S.coeffs, bt, xt, shape, r),
                jnp.asarray(b) - S_j.mv(jnp.asarray(x))) < 1e-12
    assert _rel(sk.sweep3_block_plain(S.coeffs, binv, bt, xt, 0.9, shape, r),
                sweep_j(jnp.asarray(x))) < 1e-12
    assert _rel(sk.sweep3_block_plain(S.coeffs, binv, bt, None, 0.9, shape,
                                      r), sweep_j(jnp.zeros(S.n))) < 1e-12
    xs, res = S.smooth(binv, bt, None, 0.9, 2, with_residual=True)
    x2 = sweep_j(sweep_j(jnp.zeros(S.n)))
    assert _rel(xs, x2) < 1e-12
    assert _rel(res, jnp.asarray(b) - S_j.mv(x2)) < 1e-12
    assert _rel(S.smooth(binv, bt, xt, 0.9, 1), sweep_j(jnp.asarray(x))) < 1e-12
    assert torch.equal(S.smooth(binv, bt, None, 0.9, 0), torch.zeros_like(bt))
    if n_fields == 1:
        C1, invd = S.coeffs[0, 0].contiguous(), binv.reshape(-1)
        assert _rel(sk.sweep3_block_plain(C1, invd, bt, xt, 0.9, shape, r),
                    sk.jacobi_smooth3_plain(C1, invd, bt, xt, 0.9, shape,
                                            r)) < 1e-14
        assert torch.equal(sk.apply3_block_plain(C1, xt, shape, r),
                           sk.stencil_mv3_plain(C1, xt, shape, r))


def test_torch_block3d_wrapper_rejects_bad_operands():
    S, _ = _random_pair(2, 1, (5, 4, 6), 35)
    S = S.to(torch.float32)
    x = torch.zeros(S.n)
    binv = torch.zeros(2, 2, S.nn)
    with pytest.raises(ValueError):
        sk.stencil3d_block(S.coeffs, None, S.shape, 1)          # no x, no sweep
    with pytest.raises(ValueError):
        sk.stencil3d_block(S.coeffs, x, S.shape, 1, binv=binv)  # sweep, no b
    with pytest.raises(ValueError):
        sk.stencil3d_block(S.coeffs, x[:-1], S.shape, 1)
    with pytest.raises(ValueError):
        sk.stencil3d_block(S.coeffs, x, (5, 4), 1)
    with pytest.raises(ValueError):
        sk.stencil3d_block(S.coeffs, x, S.shape, 1, b=x, binv=binv[0])
    with pytest.raises(TypeError):
        sk.stencil3d_block(S.coeffs.double(), x.double(), S.shape, 1)
    with pytest.raises(ValueError):
        StencilOperatorBlock3D(S.coeffs, (5, 4, 7), 1)
    with pytest.raises(ValueError):
        S.smooth(binv, x, None, 1.0, -1)


@pytest.mark.parametrize("n_fields,radius", [(2, 2), (3, 1)])
def test_torch_coarsen_block3(n_fields, radius):
    """The direct 3D block RAP against JAX's direct conv and JAX's
    re-probing oracle."""
    S, S_j = _random_pair(n_fields, radius, (9, 7, 9), 36)
    Sc = mg._coarsen_block3(S)
    assert isinstance(Sc, StencilOperatorBlock3D) and Sc.shape == (5, 4, 5)
    assert _rel(Sc.coeffs, jmg._coarsen_block3(S_j).coeffs) < 1e-12
    assert _rel(Sc.coeffs, jmg._coarsen_block3_probe(S_j).coeffs) < 1e-12


def test_torch_block3d_multigrid_minv():
    """StencilMultigridBlock3D (9³ → 5³ dense) against JAX's on a random r,
    both cycles given JAX's coarse inverse (the port forms its own with
    the Newton–Schulz iteration in f64 and agrees to ~1e-9 on it)."""
    S, S_j = _random_pair(3, 1, (9, 9, 9), 37, dominant=True)
    mgt = mg.StencilMultigridBlock3D(S, min_size=5)
    mgj = jmg.StencilMultigridBlock3D(S_j, min_size=5)
    assert [lv.shape for lv in mgt.levels] == [(9, 9, 9), (5, 5, 5)]
    for a, b in zip(mgt.binvs, mgj.binvs):
        assert _rel(a, b) < 1e-12
    assert _rel(mgt.coarse_inv, mgj.coarse_inv) < 1e-8
    mgt.coarse_inv = torch.from_numpy(np.array(mgj.coarse_inv))
    r = np.random.default_rng(38).standard_normal(S.n)
    assert _rel(mgt.minv(torch.from_numpy(r)), mgj.minv(jnp.asarray(r))) < 1e-10


@pytest.mark.parametrize("n_bg", [4, 6])
def test_torch_block3d_probe(n_bg):
    """The 3·125-colour block probe of the assembled operator against
    JAX's, chunked equal to unchunked, and its apply against A_b's."""
    s = elastic3(n_bg)
    S = StencilOperatorBlock3D.probe_multi(
        s.A.mv_multi, s.shape, n_fields=3, dtype=torch.float64, device="cpu")
    S_j = JBlock3.probe_multi(s.A_j.mv_multi, s.shape, n_fields=3,
                              dtype=jnp.float64, chunk=125)
    assert tuple(S.coeffs.shape) == (3, 3, 125, *s.shape)
    assert _rel(S.coeffs, S_j.coeffs) < 1e-12
    S7 = StencilOperatorBlock3D.probe_multi(
        s.A.mv_multi, s.shape, n_fields=3, dtype=torch.float64, chunk=7,
        device="cpu")
    assert torch.equal(S7.coeffs, S.coeffs)
    assert S.verify(s.A.mv) < 1e-12
    st = from_numpy_state(coeffs=np.asarray(S_j.coeffs),
                          lattice_shape=s.shape, radius=2, device="cpu")
    assert isinstance(st.S, StencilOperatorBlock3D) and st.S.n_fields == 3
    assert torch.equal(st.S.coeffs, torch.from_numpy(np.asarray(S_j.coeffs)))
