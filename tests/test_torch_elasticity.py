"""The port's immersed linear elasticity (models/elasticity.py), its block
solves through solve_ksp (pc='mg' and 'bjacobi' with n_fields=2) and the
synthetic elasticity demo vs the JAX package, from identical numpy state
(the specs are tests/test_models.py::test_immersed_elasticity_* and
demos/linear_elasticity.py --mesh-root synthetic)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.demos import linear_elasticity as demo
from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.solvers.ksp import solve_ksp
from torch_elastic_pair import elastic


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def systems():
    return elastic


def test_torch_elasticity_model(systems):
    """Jacobian blocks and residual of the cell and Nitsche terms at a
    random foreground state, b = −Mᵀr at u = 0, and the error norms."""
    s = systems(8)
    u = np.random.default_rng(0).standard_normal(s.prob.space.n_dofs)
    ut, uj = torch.from_numpy(u), jnp.asarray(u)
    assert s.prob.space.n_fields == 2 and len(s.prob.form.terms) == 2
    # the JAX side jitted: one XLA compile instead of op-by-op dispatch
    blocks_j, res_j = jax.jit(s.prob_j.form.jacobian_and_residual)(uj)
    for K, K_j in zip(s.prob.form.jacobian_blocks(ut), blocks_j):
        assert _rel(K, K_j) < 1e-12
    assert _rel(s.prob.form.residual(ut), res_j) < 1e-12
    assert _rel(s.b, s.b_j) < 1e-12
    n, n_j = s.prob.error_norms(ut), s.prob_j.error_norms(uj)
    for k in ("L2", "H10"):
        assert abs(n[k] - n_j[k]) <= 1e-12 * n_j[k]


@pytest.mark.parametrize("n_bg", [8, 16])
def test_torch_elasticity_block_mg_solve(systems, n_bg):
    """solve_ksp(cg, mg, n_fields=2): JAX's iteration count and solution,
    and the error norms of host LU (test_models.py's criterion)."""
    s = systems(n_bg)
    kw = dict(method="cg", pc="mg", rtol=1e-11, lattice_shape=s.shape,
              n_fields=2)
    x_j, info_j = j_solve_ksp(s.A_j, s.b_j, monitor=False, **kw)
    x, info = solve_ksp(s.A, s.b, monitor=False, **kw)
    assert info.converged and info.iters == int(info_j.iters)
    assert _rel(x, x_j) < 1e-8
    u_lu, _ = solve_ksp(s.A, s.b, method="direct")
    n, n_lu = s.norms(x), s.norms(u_lu)
    for k in ("L2", "H10"):
        assert abs(n[k] - n_lu[k]) < 1e-8 * n_lu[k]


def test_torch_elasticity_bjacobi_solve(systems):
    """Point-block Jacobi CG on the general operator (n_fields=2)."""
    s = systems(8)
    kw = dict(method="cg", pc="bjacobi", rtol=1e-10, n_fields=2)
    x_j, info_j = j_solve_ksp(s.A_j, s.b_j, monitor=False, **kw)
    x, info = solve_ksp(s.A, s.b, monitor=False, **kw)
    assert info.converged and info.iters == int(info_j.iters)
    assert _rel(x, x_j) < 1e-9


def test_torch_elasticity_mixed_mg_solve(systems):
    """The f32 block MG-CG passes with f64 refinement (the CUDA default),
    here on the plain versions: f64 residual below rtol, the host LU's
    error norms."""
    s = systems(16)
    x, info = solve_ksp(s.A, s.b, method="cg", pc="mg", rtol=1e-11,
                        lattice_shape=s.shape, n_fields=2, mixed=True,
                        monitor=False)
    rel = float(torch.linalg.vector_norm(s.b - s.A.mv(x))
                / torch.linalg.vector_norm(s.b))
    assert x.dtype == torch.float64 and info.converged and rel < 1e-11
    u_lu, _ = solve_ksp(s.A, s.b, method="direct")
    n, n_lu = s.norms(x), s.norms(u_lu)
    for k in ("L2", "H10"):
        assert abs(n[k] - n_lu[k]) < 1e-8 * n_lu[k]


def test_torch_demo_elasticity_matches_jax(systems, capsys):
    """--ref 2 (n_fg=32, n_bg=16) in-process against the JAX demo's steps."""
    out = demo.main(["--mesh-root", "synthetic", "--k", "1", "--ref", "2",
                     "--device", "cpu"])
    printed = capsys.readouterr().out
    s = systems(16)                  # the demo's problem at --ref 2
    u_p, info_j = j_solve_ksp(s.A_j, s.b_j, method="cg", pc="mg",
                              rtol=1e-10, lattice_shape=(17, 17), n_fields=2,
                              monitor=False)
    ref = s.prob_j.error_norms(s.M_j.mv(u_p))
    assert out["info"].iters == int(info_j.iters)
    for k in ("L2", "H10"):
        assert abs(out["norms"][k] - ref[k]) <= 1e-8 * ref[k], k
        assert f"relative {k} norm: {out['norms'][k]}" in printed
    assert "solv=cg, pc=mg" in printed and "Converged in" in printed


@pytest.mark.parametrize("argv,msg", [
    (["--k", "2"], "item 12d"),
    (["--mesh-root", "meshes"], "item 12e"),
])
def test_torch_demo_elasticity_refuses_unported(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        demo.main(argv + ["--device", "cpu"])
