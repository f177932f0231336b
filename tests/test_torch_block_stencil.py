"""The port's block (multi-field) path vs the JAX package, from identical
numpy state: the multi-field extraction layout, the stacked applies
(``mv_multi``/``rmv_multi``/``Form.matvec_multi``/
``BackgroundOperator.mv_multi``), ``block_diag`` and ``block_jacobi``, the
block stencil probe, apply and multigrid pieces, on the immersed
elasticity system (tests/test_models.py's workload) at n_bg = 8 and 16.
f64 throughout: 1e-12 relative, the V-cycle 1e-10."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.ops import multigrid as jmg
from iifea_tpu.ops.extraction import ExtractionOperator as JExtraction
from iifea_tpu.solvers import precond as jprecond
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.ops import multigrid as mg
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.stencil import StencilOperatorBlock2D
from iifea_tpu_torch.solvers import precond
from torch_elastic_pair import elastic


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def systems():
    return elastic


@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_torch_from_triples_fields(n_fields):
    """Field-blocked background (node + f·m), interleaved foreground
    (node·nF + f), JAX's last-wins dedup of a repeated (fg, bg) pair."""
    rng = np.random.default_rng(n_fields)
    fg = rng.integers(0, 20, 60)
    bg = rng.integers(0, 15, 60)
    w = rng.standard_normal(60)
    fg = np.concatenate([fg, fg[:3]])
    bg = np.concatenate([bg, bg[:3]])
    w = np.concatenate([w, w[:3] + 1.0])
    Mj = JExtraction.from_triples(fg, bg, w, 20, 15, n_fields=n_fields)
    M = ExtractionOperator.from_triples(fg, bg, w, 20, 15, n_fields=n_fields,
                                        device="cpu")
    assert M.n_bg_dofs == Mj.n_bg_dofs == 15 * n_fields
    np.testing.assert_array_equal(M.idx_np, Mj.idx_np)
    np.testing.assert_array_equal(M.val_np, Mj.val_np)


@pytest.mark.parametrize("variant", ["plain", "trim", "shift"])
def test_torch_stacked_applies(systems, variant):
    """k = 7 stacked columns through M, Mᵀ, A_f and A_b (trimmed, shifted)
    against JAX's, and A_b's stacked apply against its single one."""
    s = systems(8)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((7, s.A.n))
    A, A_j = s.A, s.A_j
    if variant == "trim":
        mask = rng.random(s.A.n) < 0.2
        A, A_j = A.with_trim(torch.from_numpy(mask)), A_j.with_trim(
            jnp.asarray(mask))
    elif variant == "shift":
        sh = rng.uniform(0.1, 1.0, s.A.n)
        A, A_j = A.with_shift(torch.from_numpy(sh)), A_j.with_shift(
            jnp.asarray(sh))
    Xt, Xj = torch.from_numpy(X), jnp.asarray(X)
    Uf = s.M.mv_multi(Xt)
    assert _rel(Uf, s.M_j.mv_multi(Xj)) < 1e-12
    R = rng.standard_normal(tuple(Uf.shape))
    assert _rel(s.M.rmv_multi(torch.from_numpy(R)),
                s.M_j.rmv_multi(jnp.asarray(R))) < 1e-12
    assert _rel(A.form.matvec_multi(A.blocks, torch.from_numpy(R)),
                A_j.form.matvec_multi(A_j.blocks, jnp.asarray(R))) < 1e-12
    Y = A.mv_multi(Xt)
    assert _rel(Y, A_j.mv_multi(Xj)) < 1e-12
    assert _rel(Y, torch.stack([A.mv(x) for x in Xt])) < 1e-12


@pytest.mark.parametrize("variant", ["plain", "trim_shift"])
def test_torch_block_diag_and_block_jacobi(systems, variant):
    s = systems(8)
    A, A_j = s.A, s.A_j
    if variant == "trim_shift":
        rng = np.random.default_rng(3)
        mask = rng.random(A.n) < 0.2
        sh = rng.uniform(0.1, 1.0, A.n)
        A = A.with_trim(torch.from_numpy(mask)).with_shift(
            torch.from_numpy(sh))
        A_j = A_j.with_trim(jnp.asarray(mask)).with_shift(jnp.asarray(sh))
    B, B_j = A.block_diag(2), A_j.block_diag(2)
    assert tuple(B.shape) == (A.n // 2, 2, 2)
    assert _rel(B, B_j) < 1e-12
    assert _rel(A.block_diag(2, chunk=37), B) < 1e-12
    r = np.random.default_rng(4).standard_normal(A.n)
    assert _rel(precond.block_jacobi(B)(torch.from_numpy(r)),
                jprecond.block_jacobi(B_j)(jnp.asarray(r))) < 1e-12


@pytest.mark.parametrize("n_bg", [8, 16])
def test_torch_block_probe(systems, n_bg):
    """The nF·25-colour block probe against JAX's, chunked equal to
    unchunked, and the probed operator's apply against A_b's."""
    s = systems(n_bg)
    assert tuple(s.S.coeffs.shape) == (2, 2, 25, *s.shape)
    assert _rel(s.S.coeffs, s.S_j.coeffs) < 1e-12
    S7 = StencilOperatorBlock2D.probe_multi(
        s.A.mv_multi, s.shape, n_fields=2, dtype=torch.float64, chunk=7,
        device="cpu")
    assert torch.equal(S7.coeffs, s.S.coeffs)
    assert s.S.verify(s.A.mv) < 1e-12
    x = np.random.default_rng(5).standard_normal(s.S.n)
    assert _rel(s.S.mv(torch.from_numpy(x)), s.S_j.mv(jnp.asarray(x))) < 1e-12
    assert _rel(s.S.diag(), s.S_j.diag()) < 1e-12
    assert _rel(s.S.point_block_diag(), s.S_j.point_block_diag()) < 1e-12


def test_torch_block_apply_f32_is_the_plain_version(systems):
    """On the CPU the f32 block apply, and the kernel wrapper given CPU
    tensors, run the plain version and count no kernel."""
    S = systems(8).S.to(torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(S.n)).float()
    before = sk.launches()
    y_ref = sk.stencil_mv_block_plain(S.coeffs, x, S.shape, 2)
    assert torch.equal(S.mv(x), y_ref)
    assert torch.equal(sk.stencil_mv_block(S.coeffs, x, S.shape, 2), y_ref)
    assert sk.launches() == before
    with pytest.raises(ValueError):
        sk.stencil_mv_block(S.coeffs[0], x, S.shape, 2)


def test_torch_coarsen_block_and_dense_inverse(systems):
    s = systems(16)
    Sc = mg._coarsen_block(s.S)
    Sc_j = jmg._coarsen_block(s.S_j)
    assert Sc.shape == tuple(Sc_j.shape) == (9, 9)
    assert _rel(Sc.coeffs, Sc_j.coeffs) < 1e-12
    assert _rel(mg._point_binv(s.S), jmg._point_binv(s.S_j)) < 1e-12
    assert _rel(mg._dense_inverse_block(Sc),
                jmg._dense_inverse_block(Sc_j)) < 1e-12


@pytest.mark.parametrize("k", [1, 2, 3])
def test_torch_adjugate_inv(k):
    rng = np.random.default_rng(k)
    B = rng.standard_normal((50, k, k)) + 3.0 * np.eye(k)
    inv, det = mg._adjugate_inv(torch.from_numpy(B))
    inv_j, det_j = jmg._adjugate_inv(jnp.asarray(B))
    assert _rel(inv, inv_j) < 1e-12 and _rel(det, det_j) < 1e-12
    assert _rel(inv, np.linalg.inv(B)) < 1e-12


def test_torch_block_multigrid_minv(systems):
    """StencilMultigridBlock (17² → 9² dense) against JAX's on a random r."""
    s = systems(16)
    mgt, mgj = mg.StencilMultigridBlock(s.S), jmg.StencilMultigridBlock(s.S_j)
    assert [lv.shape for lv in mgt.levels] == [(17, 17), (9, 9)]
    for a, b in zip(mgt.binvs, mgj.binvs):
        assert _rel(a, b) < 1e-12
    r = np.random.default_rng(8).standard_normal(s.S.n)
    assert _rel(mgt.minv(torch.from_numpy(r)), mgj.minv(jnp.asarray(r))) < 1e-10


@pytest.mark.parametrize("side,min_size,warns", [(65, 65, True),
                                                 (17, 9, False)])
def test_torch_block_multigrid_weak_coarse_warning(side, min_size, warns):
    """The warning fires only when the coarsest level is too large for the
    dense inverse (min_size=65 stops at 2 × 65² dofs > DENSE_CAP_BLOCK),
    not when the hierarchy reaches a dense 9² level (17² → 9²)."""
    import warnings

    rng = np.random.default_rng(10)
    C = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, 2, 25, side, side)))
    C[0, 0, 12] += 4.0
    C[1, 1, 12] += 4.0
    S = StencilOperatorBlock2D(C, (side, side), 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = mg.StencilMultigridBlock(S, min_size=min_size)
    assert (m.coarse_inv is None) == warns
    assert m.levels[-1].shape == ((65, 65) if warns else (9, 9))
    assert [str(w.message).startswith("multigrid: the coarsest level")
            for w in caught] == ([True] if warns else [])


def test_torch_convert_block_planes(systems):
    """from_numpy_state carries JAX's 5-D block planes across."""
    s = systems(8)
    st = from_numpy_state(coeffs=np.asarray(s.S_j.coeffs),
                          lattice_shape=s.shape, radius=2, device="cpu")
    assert isinstance(st.S, StencilOperatorBlock2D)
    assert st.S.n_fields == 2 and torch.equal(st.S.coeffs, s.S.coeffs.new_tensor(
        np.asarray(s.S_j.coeffs)))
