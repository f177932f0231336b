"""The port's restricted additive Schwarz preconditioner vs the JAX
package's on the same CSR matrix: the patch tables (``idx``, ``own``,
``inv``, ``passthrough``) equal, ``minv`` at 1e-12, ``core_size`` and
``overlap`` honoured, and ``solve_ksp(pc='asm')`` for CG and GMRES with
JAX's iteration counts on the immersed Poisson system of
tests/test_solvers.py::test_asm_preconditioner_small."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu.solvers.precond import AdditiveSchwarz as JAdditiveSchwarz
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.solvers.ksp import solve_ksp
from iifea_tpu_torch.solvers.precond import AdditiveSchwarz
from test_torch_ksp import j_assemble_jit


class System:
    def __init__(self, n_fg=48, n_bg=24):
        mesh_j, M_j = j_square(n_fg=n_fg, n_bg=n_bg)
        self.A_j, self.b_j = j_assemble_jit(
            JPoisson(mesh_j, k=1, sym=True, beta_value=10).form, M_j)
        st = from_numpy_state(
            coords=mesh_j.coords, cells=mesh_j.cells,
            material=mesh_j.material, idx=M_j.idx_np, val=M_j.val_np,
            n_bg_dofs=M_j.n_bg_dofs, device="cpu")
        prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                              device="cpu")
        self.A, self.b = assemble_background_system(
            prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64),
            st.M)
        self.csr = self.A.to_scipy()


@pytest.fixture(scope="module")
def system():
    return System()


@pytest.mark.parametrize("core_size,overlap", [(64, 1), (16, 1), (32, 2),
                                               (64, 0)])
def test_torch_asm_tables_and_apply(system, core_size, overlap):
    """Same CSR in, same patches out: the tables equal JAX's (the inverses
    to 1e-12: numpy inverts both), ``minv`` at 1e-12; dead dofs pass
    through; core_size bounds the owned dofs of a patch."""
    asm = AdditiveSchwarz(system.csr, core_size=core_size, overlap=overlap,
                          device="cpu")
    asm_j = JAdditiveSchwarz(system.csr, core_size=core_size, overlap=overlap)
    assert (asm.n_patches, asm.width) == (asm_j.n_patches, asm_j.width)
    assert np.array_equal(asm.idx.numpy(), np.asarray(asm_j.idx))
    assert np.array_equal(asm.own.numpy(), np.asarray(asm_j.own))
    assert np.array_equal(asm.passthrough.numpy(),
                          np.asarray(asm_j.passthrough))
    inv_j = np.asarray(asm_j.inv)
    assert np.abs(asm.inv.numpy() - inv_j).max() <= 1e-12 * np.abs(inv_j).max()
    assert int(asm.own.sum(dim=1).max()) <= core_size
    # every live dof is owned by exactly one patch
    owned = torch.zeros(asm.n + 1).index_add_(
        0, asm.idx.reshape(-1), asm.own.reshape(-1).float())[:asm.n]
    assert torch.equal(owned + asm.passthrough.float(), torch.ones(asm.n))
    r = np.random.default_rng(core_size + overlap).standard_normal(asm.n)
    z, z_j = asm.minv(torch.from_numpy(r)), np.asarray(asm_j.minv(
        jnp.asarray(r)))
    assert np.abs(z.numpy() - z_j).max() <= 1e-12 * np.abs(z_j).max()
    dead = asm.passthrough.bool().numpy()
    assert dead.any() and np.array_equal(z.numpy()[dead], r[dead])


def test_torch_asm_tables_follow_dtype_and_overlap(system):
    """The tables take the requested dtype; more overlap widens the
    patches, a smaller core makes more of them."""
    a = AdditiveSchwarz(system.csr, core_size=32, overlap=1, device="cpu")
    wide = AdditiveSchwarz(system.csr, core_size=32, overlap=2, device="cpu")
    small = AdditiveSchwarz(system.csr, core_size=8, overlap=1, device="cpu",
                            dtype=torch.float32)
    assert wide.width > a.width and wide.n_patches == a.n_patches
    assert small.n_patches > a.n_patches
    assert small.inv.dtype == small.own.dtype == torch.float32
    assert a.inv.dtype == torch.float64 and a.idx.dtype == torch.int64


@pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab"])
def test_torch_solve_ksp_asm(system, method):
    """solve_ksp(pc='asm') against JAX's: the iteration count (within the
    port's check interval), the residual, the solution on supported dofs;
    for GMRES fewer iterations than Jacobi (the reference test's
    criterion)."""
    kw = dict(method=method, pc="asm", rtol=1e-10)
    x, info = solve_ksp(system.A, system.b, monitor=False, **kw)
    x_j, info_j = j_solve_ksp(system.A_j, system.b_j, monitor=False, **kw)
    check = {"cg": 8, "bicgstab": 8, "gmres": 2}[method]
    assert info.converged and abs(info.iters - int(info_j.iters)) < check
    rel = float(torch.linalg.vector_norm(system.b - system.A.mv(x))
                / torch.linalg.vector_norm(system.b))
    assert rel <= 1.5e-10
    d = system.A.diag().abs().numpy() > 0
    x_j = np.asarray(x_j)
    assert np.abs(x.numpy() - x_j)[d].max() <= 1e-7 * max(np.abs(x_j).max(),
                                                         1.0)
    if method == "gmres":
        _, info_jac = solve_ksp(system.A, system.b, method="gmres",
                                pc="jacobi", rtol=1e-10, monitor=False)
        assert info.iters < info_jac.iters


def test_torch_solve_ksp_asm_options(system):
    """asm_core and asm_overlap reach the preconditioner ('ASM' is the
    same spelling): against JAX with the same arguments."""
    kw = dict(method="gmres", pc="ASM", rtol=1e-10, asm_core=16,
              asm_overlap=2)
    x, info = solve_ksp(system.A, system.b, monitor=False, **kw)
    _, info_j = j_solve_ksp(system.A_j, system.b_j, monitor=False, **kw)
    _, info_d = solve_ksp(system.A, system.b, method="gmres", pc="asm",
                          rtol=1e-10, monitor=False)
    assert info.converged and abs(info.iters - int(info_j.iters)) < 2
    assert info.iters != info_d.iters
