"""What the 3D marching kernels may skip: a coefficient at a tap whose x
lies outside the lattice multiplies the zero padding, so the 3D applies
are the same whatever the planes hold there. Held here for the JAX
package's own 3D applies (the Pallas kernels ``stencil_mv3`` and
``jacobi_smooth3`` in interpret mode, ``StencilOperator3D.mv_ref``,
``StencilOperatorBlock3D.mv``) with random finite values in those taps
against zeros there, and for the port's plain versions (the CPU side of
``stencil_mv3`` and of every ``stencil3d_pass`` pass) against both: f64
to 1e-12, f32 to 1e-5 relative. The CUDA kernels read none of those taps:
``tests/test_torch_level_kernels_card.py`` holds them, on a card, to the
same outputs bitwise with NaN there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops.pallas_stencil import jacobi_smooth3, stencil_mv3
from iifea_tpu.ops.stencil import StencilOperator3D as JStencil3
from iifea_tpu.ops.stencil import StencilOperatorBlock3D as JBlock3
from iifea_tpu_torch.ops import stencil_kernels as sk

TOL = {np.float64: 1e-12, np.float32: 1e-5}
# small odd lattices: at r = 5 most taps of (5, 4, 6) fall outside it
SHAPES = [(5, 4, 6), (7, 6, 5)]


def _close(a, ref, dtype):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() <= TOL[dtype] * np.abs(ref).max()


def _planes(n_fields, radius, shape, dtype, seed):
    """Block planes (nF, nF, m³, *shape) (scalar (m³, *shape) for
    n_fields = 0) with zeros in the taps outside the lattice, the same
    planes with random finite values there, b and x."""
    rng = np.random.default_rng(seed)
    m3 = (2 * radius + 1) ** 3
    nF = max(n_fields, 1)
    C = rng.uniform(-0.1, 0.1, (nF, nF, m3, *shape))
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    out = sk.outside_taps(shape, radius).numpy()
    zero, junk = C.copy(), C.copy()
    zero[..., out] = 0.0
    junk[..., out] = rng.uniform(-1e3, 1e3, junk[..., out].shape)
    n = nF * int(np.prod(shape))
    b, x = rng.standard_normal(n), rng.standard_normal(n)
    if n_fields == 0:
        zero, junk = zero[0, 0], junk[0, 0]
    return tuple(a.astype(dtype) for a in (zero, junk, b, x))


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_torch_pallas3_ignore_outside_taps(shape):
    """r = 2, f32: the JAX package's Pallas stencil_mv3 and jacobi_smooth3
    (interpret mode, as tests/test_pallas_stencil.py runs them) give the
    same output with random values in the outside taps as with zeros, and
    the port's plain versions agree with both."""
    radius, dt = 2, np.float32
    zero, junk, b, x = _planes(0, radius, shape, dt, 3)
    n = int(np.prod(shape))
    invd = np.random.default_rng(4).uniform(0.5, 2.0, n).astype(dt)
    outs = []
    for C in (zero, junk):
        S = JStencil3(jnp.asarray(C), shape, radius)
        y = np.asarray(stencil_mv3(S.cp, jnp.asarray(x), shape, radius,
                                   interpret=True))
        s = np.asarray(jacobi_smooth3(
            S.cp, S.pad_volume(jnp.asarray(invd)),
            S.pad_volume(jnp.asarray(b)), jnp.asarray(x), 0.67, shape,
            radius, interpret=True))
        outs.append((y, s))
    for a, a_junk in zip(*outs):
        np.testing.assert_array_equal(a, a_junk)
    for C in (zero, junk):
        Ct, xt = torch.from_numpy(C), torch.from_numpy(x)
        y = sk.stencil_mv3_plain(Ct, xt, shape, radius)
        s = sk.jacobi_smooth3_plain(Ct, torch.from_numpy(invd),
                                    torch.from_numpy(b), xt, 0.67, shape,
                                    radius)
        for a, ref in zip((y, s), outs[0]):
            assert _close(a, ref, dt)


# (radius, fields, dtype): StencilOperator3D.mv_ref at every radius, and
# StencilOperatorBlock3D.mv for 1-3 fields across the radii, f64 and f32
# (every combination would multiply the JAX package's eager applies, the
# test's time)
CASES = [(3, 0, np.float64), (4, 0, np.float32), (5, 0, np.float64),
         (3, 1, np.float32), (4, 2, np.float64), (5, 3, np.float32)]


@pytest.mark.parametrize("radius,n_fields,dtype", CASES)
def test_torch_apply3_ignores_outside_taps(radius, n_fields, dtype):
    """r = 3-5, scalar planes and 1-3 fields: StencilOperator3D.mv_ref
    (scalar) and StencilOperatorBlock3D.mv (fields) give the same A x
    with random values in the outside taps as with zeros; the port's
    plain passes (apply, residual, sweep, and on scalar planes
    stencil_mv3 and the Chebyshev step) agree with both."""
    for shape in SHAPES[radius % 2:][:1]:
        zero, junk, b, x = _planes(n_fields, radius, shape, dtype,
                                   10 * radius + n_fields)
        nF = max(n_fields, 1)
        n = int(np.prod(shape))
        binv = np.random.default_rng(radius).uniform(
            0.1, 0.3, (n,) if n_fields == 0 else (nF, nF, n)).astype(dtype)
        ys = []
        for C in (zero, junk):
            if n_fields == 0:
                S = JStencil3(jnp.asarray(C), shape, radius)
                ys.append(np.asarray(S.mv_ref(jnp.asarray(x))))
            else:
                S = JBlock3(jnp.asarray(C), shape, radius)
                ys.append(np.asarray(S.mv(jnp.asarray(x))))
        np.testing.assert_array_equal(ys[0], ys[1])
        y_ref = ys[0]
        bx = b.astype(np.float64)
        res_ref = bx - y_ref
        if n_fields == 0:
            swept = binv * res_ref
        else:
            swept = (binv * res_ref.reshape(1, nF, -1)).sum(axis=1).ravel()
        bt, xt, binvt = (torch.from_numpy(a) for a in (b, x, binv))
        for C in (zero, junk):
            Ct = torch.from_numpy(C)
            got = {
                "apply": sk.apply3_block_plain(Ct, xt, shape, radius),
                "residual": sk.residual3_block_plain(Ct, bt, xt, shape,
                                                     radius),
                "sweep": sk.sweep3_block_plain(Ct, binvt, bt, xt, 0.8, shape,
                                               radius)}
            ref = {"apply": y_ref, "residual": res_ref,
                   "sweep": x + 0.8 * swept}
            if n_fields == 0:
                got["mv3"] = sk.stencil_mv3_plain(Ct, xt, shape, radius)
                ref["mv3"] = y_ref
                d = np.random.default_rng(1).standard_normal(n).astype(dtype)
                cx, cd = sk.cheb_step3_plain(Ct, binvt, bt, xt,
                                             torch.from_numpy(d), 1.3, 0.45,
                                             shape, radius)
                dn = 1.3 * binv * res_ref + 0.45 * d
                got["cheb"], ref["cheb"] = cx, x + dn
                got["cheb_d"], ref["cheb_d"] = cd, dn
            for k in got:
                assert _close(got[k], ref[k], dtype), (k, shape)
