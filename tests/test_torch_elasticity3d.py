"""``solve_ksp(cg, pc='mg', n_fields=3)`` on 3D immersed elasticity, the
port against the JAX package and host LU from identical numpy state
(tests/test_models.py::test_immersed_elasticity_3d_block_mg's workload):
solves are held by error norms at 1e-8 and by the f64 residual."""
import numpy as np
import pytest
import torch

from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.solvers.ksp import solve_ksp
from torch_elastic3_pair import elastic3


@pytest.mark.parametrize("n_bg,mixed", [(6, False), (6, True), (8, True)])
def test_torch_elasticity3d_mg_solve(n_bg, mixed):
    """solve_ksp(cg, pc='mg', n_fields=3) (the reference's Tier-1 case at
    n_bg=6; n_bg=8 in the mixed mode a card runs): host LU's and JAX's
    direct solution's error norms to 1e-8, under 60 iterations, the f64
    residual below rtol; at n_bg=6 in f64 JAX's own block-MG CG iteration
    count within one check interval (4)."""
    s = elastic3(n_bg)
    u_lu, _ = solve_ksp(s.A, s.b, method="direct")
    u_j, _ = j_solve_ksp(s.A_j, s.b_j, method="direct", monitor=False)
    u, info = solve_ksp(s.A, s.b, method="cg", pc="mg", rtol=1e-10,
                        lattice_shape=s.shape, n_fields=3, monitor=False,
                        mixed=mixed)
    assert info.converged and info.iters < 60
    rel = float(torch.linalg.vector_norm(s.b - s.A.mv(u))
                / torch.linalg.vector_norm(s.b))
    assert rel < 1e-10
    n, n_lu = s.norms(u), s.norms(u_lu)
    n_j = s.norms(torch.from_numpy(np.asarray(u_j)))
    for k in ("L2", "H10"):
        assert abs(n[k] - n_lu[k]) < 1e-8 * n_lu[k]
        assert abs(n[k] - n_j[k]) < 1e-8 * n_j[k]
    if (n_bg, mixed) == (6, False):
        _, info_j = j_solve_ksp(s.A_j, s.b_j, method="cg", pc="mg",
                                rtol=1e-10, lattice_shape=s.shape,
                                n_fields=3, monitor=False, mixed=mixed)
        assert abs(info.iters - int(info_j.iters)) <= 4
