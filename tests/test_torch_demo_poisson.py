"""The port's Poisson demo (iifea_tpu_torch/demos/poisson.py) at --ref 2 on
the CPU vs the same steps through the JAX package, in-process: the
synthetic cut square (n_fg=32, n_bg=16) → PoissonProblem →
assemble_background_system → solve_ksp(gmres, jacobi) → error_norms, as
``demos/poisson.py --mesh-root synthetic --ref 2`` runs them."""
import jax
import jax.numpy as jnp
import pytest

from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.demos import poisson as demo


def j_assemble_jit(form, M):
    """The JAX package's assemble_background_system at u = 0 as one jitted
    call (one XLA compile, ~10x faster on the CPU than op by op); the
    operator is rebuilt on the original form and M, whose host-side
    tables jit's outputs do not carry."""
    A, b = jax.jit(lambda u: j_assemble(form, u, M))(jnp.zeros(form.n_dofs))
    return JBackgroundOperator(form, A.blocks, M), b


def test_torch_demo_poisson_matches_jax(capsys):
    out = demo.main(["--ref", "2", "--solv", "gmres", "--pc", "jacobi",
                     "--device", "cpu"])
    printed = capsys.readouterr().out
    mesh_j, M_j = j_square(n_fg=32, n_bg=16)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10.0)
    A, b = j_assemble_jit(prob_j.form, M_j)
    u_p, _ = j_solve_ksp(A, b, method="gmres", pc="jacobi", monitor=False)
    ref = prob_j.error_norms(M_j.mv(u_p))
    for k in ("L2", "H10", "H1"):
        assert abs(out["norms"][k] - ref[k]) <= 1e-6 * ref[k], k
        assert f"{k} norm: {out['norms'][k]}" in printed
    assert "Symmetric Nitsche Method" in printed
    assert "Converged in" in printed and out["info"].converged


@pytest.mark.parametrize("argv,msg", [
    (["--k", "3"], "degree is 1 or 2"),
    (["--dim", "3", "--k", "2"], "linear"),
    (["--devices", "2", "--backend", "nccl"], "nccl backend takes CUDA"),
    pytest.param(["--mesh-root", "meshes"],
                 "no meshes/square/Linear/R0/mesh.xdmf",
                 id="argv3-item 12e"),
])
def test_torch_demo_poisson_refuses_unported(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        demo.main(argv + ["--device", "cpu"])
