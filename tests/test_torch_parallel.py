"""The port's sharded operators (iifea_tpu_torch/parallel/) on CPU ranks
(gloo) against the JAX package's sharded classes on the conftest's 8
virtual devices, from the same numpy planes, vectors and meshes:

* the row-block applies ``ShardedStencil2D``, ``ShardedStencil3D`` and
  ``ShardedStencilBlock2D`` (f64, radius 2; 1e-12 relative), and bitwise
  the port's single-device applies;
* ``ShardedProjectedSystem`` matvec, diag and residual at n_fg=24,
  n_bg=12 (1e-10);
* the whole slice, ``bench.py --devices N``'s sharded MG-PCG refinement at
  n_bg=24: f64 residual < 1e-10, dofs with a diagonal above 0.05 of the
  largest to 1e-7·max|x| of the JAX package's single-device solution (its
  explicitly projected system by host SuperLU, as
  tests/test_torch_slice.py), CG iterations within 2 of the port's
  single-device refinement. (``bench.run_sharded(24, 8)`` compiles for
  ~100 s and JAX's own refinement for ~25 s on this CPU, which the test
  budget does not hold.)

with one spawned world of 4 ranks, whose first three ranks also form a
3-rank mesh (uneven row blocks). Also the pieces the slice added to the
port: ``krylov.cg``'s ``dot`` hook, ``BinnedLatticeSolver.refine``'s
``cg_fn`` hook and pickling, the backend checks and the row partitions.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.ops.stencil import StencilOperator2D as JS2
from iifea_tpu.ops.stencil import StencilOperator3D as JS3
from iifea_tpu.ops.stencil import StencilOperatorBlock2D as JSb
from iifea_tpu.parallel.sharding import ShardedProjectedSystem as JSystem
from iifea_tpu.parallel.sharding import make_device_mesh
from iifea_tpu.parallel.stencil import ShardedStencil2D as JSh2
from iifea_tpu.parallel.stencil import ShardedStencil3D as JSh3
from iifea_tpu.parallel.stencil import ShardedStencilBlock2D as JShb
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import assemble_background_system as j_assemble
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh.generators import immersed_cube_problem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
)
from iifea_tpu_torch.parallel import sharding
from iifea_tpu_torch.solvers import krylov
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

SIZES = (4, 3)
N_BG_REFINE, N_FG_REFINE = 24, 32          # bench.fg_of(24): ratio √2


def _state(mesh_j, M_j):
    return dict(coords=mesh_j.coords, cells=mesh_j.cells,
                material=mesh_j.material, idx=M_j.idx_np, val=M_j.val_np,
                n_bg_dofs=M_j.n_bg_dofs)


@pytest.fixture(scope="module")
def world():
    """Inputs, the JAX package's results and the ranks' results."""
    rng = np.random.default_rng(0)
    d = {"shape2": (13, 13), "shape3": (9, 9, 9)}
    d["C2"] = rng.standard_normal((25, 13, 13))
    d["x2"] = rng.standard_normal(169)
    d["C3"] = rng.standard_normal((125, 9, 9, 9))
    d["x3"] = rng.standard_normal(729)
    d["Cb"] = rng.standard_normal((2, 2, 25, 13, 13))
    d["xb"] = rng.standard_normal(2 * 169)
    jmesh = make_device_mesh(8)
    ref = {
        "y2": jax.jit(JSh2(JS2(jnp.asarray(d["C2"]), d["shape2"], 2),
                           jmesh).mv)(jnp.asarray(d["x2"])),
        "y3": jax.jit(JSh3(JS3(jnp.asarray(d["C3"]), d["shape3"], 2),
                           jmesh).mv)(jnp.asarray(d["x3"])),
        "yb": jax.jit(JShb(JSb(jnp.asarray(d["Cb"]), d["shape2"], 2),
                           jmesh).mv)(jnp.asarray(d["xb"])),
    }

    mesh_j, M_j = j_square(n_fg=24, n_bg=12)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10)
    system = JSystem(prob_j.form, M_j, jmesh)
    d["state"] = _state(mesh_j, M_j)
    d["x_bg"] = rng.standard_normal(M_j.n_bg_dofs)
    d["u_bg"] = 0.1 * rng.standard_normal(M_j.n_bg_dofs)

    @jax.jit
    def applies(x, u):
        blocks = system.assemble_blocks(jnp.zeros(M_j.n_bg_dofs))
        return (system.matvec(blocks, x), system.diag(blocks),
                system.residual_b(u))

    ref["matvec"], ref["diag"], ref["residual"] = applies(
        jnp.asarray(d["x_bg"]), jnp.asarray(d["u_bg"]))

    # the whole slice: the JAX package's projected system, solved directly
    mesh_j, M_j = j_square(n_fg=N_FG_REFINE, n_bg=N_BG_REFINE, degree=1,
                           dtype=np.float64)
    prob_j = JPoisson(mesh_j, k=1, sym=True, beta_value=10, dtype=np.float64)
    A, b = jax.jit(lambda u: j_assemble(prob_j.form, u, M_j))(
        jnp.zeros(prob_j.space.n_dofs))
    A = JBackgroundOperator(prob_j.form, A.blocks, M_j)
    x, _ = j_solve_ksp(A, b, method="direct", monitor=False)
    ref["refine"] = {"x": np.asarray(x), "diag": np.asarray(A.diag())}
    shape = (N_BG_REFINE + 1,) * 2
    st = from_numpy_state(device="cpu", **_state(mesh_j, M_j))
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    solver = BinnedLatticeSolver(prob, st.M, shape, device="cpu")
    b64, K_cell, K_facet = solver.assemble()
    bound = solver.bind(K_cell, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    d["refine"] = (solver, S32, mg, bound, b64)
    _, relres, iters = solver.refine(S32, mg, bound, b64, 1e-10)
    ref["refine"].update(relres=relres, iters=iters)

    out = sharding.launch(ranks.system_checks, 4, "gloo", args=(d,),
                          device="cpu", timeout=600)
    return d, {k: np.asarray(v) if k != "refine" else v
               for k, v in ref.items()}, out


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1.0)


def _rank_results(out, size):
    return [r[size] for r in out[:size]]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["y2", "y3", "yb"])
def test_torch_sharded_stencil_mv_matches_jax(world, key, size):
    """ShardedStencil2D / 3D / Block2D apply == JAX's sharded apply."""
    _, ref, out = world
    for r in _rank_results(out, size):
        assert _close(r[key], ref[key], 1e-12), key


@pytest.mark.parametrize("size", SIZES)
def test_torch_sharded_applies_bitwise_single_device(world, size):
    """An interior row of the extended slab reads the single-device taps
    and x values: the sharded applies equal the port's single-device
    applies to the last bit, and diag2 is the operator's diagonal."""
    d, _, out = world
    S2 = StencilOperator2D(torch.as_tensor(d["C2"]), d["shape2"], 2)
    S3 = StencilOperator3D(torch.as_tensor(d["C3"]), d["shape3"], 2)
    Sb = StencilOperatorBlock2D(torch.as_tensor(d["Cb"]), d["shape2"], 2)
    singles = {"y2": S2.mv(torch.as_tensor(d["x2"])),
               "y3": S3.mv(torch.as_tensor(d["x3"])),
               "yb": Sb.mv(torch.as_tensor(d["xb"]))}
    for r in _rank_results(out, size):
        for key, y in singles.items():
            assert torch.equal(r[key], y), key
        assert torch.equal(r["diag2"], S2.diag())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["matvec", "diag", "residual"])
def test_torch_sharded_system_matches_jax(world, key, size):
    """ShardedProjectedSystem matvec, diag and residual == JAX's
    ShardedProjectedSystem on the same mesh, extraction and vectors."""
    _, ref, out = world
    for r in _rank_results(out, size):
        assert _close(r[key], ref[key], 1e-10), key


@pytest.mark.parametrize("size", SIZES)
def test_torch_sharded_system_one_allreduce_per_apply(world, size):
    """Each rank holds a contiguous, balanced share of every term's cells
    (all cells once), and an apply ends in one collective."""
    _, _, out = world
    results = _rank_results(out, size)
    assert all(r["matvec_collectives"] == 1 for r in results)
    cells = np.array([r["cells"] for r in results])       # (ranks, terms)
    assert (cells.max(0) - cells.min(0) <= 1).all()
    d, _, _ = world
    st = from_numpy_state(device="cpu", **d["state"])
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    assert list(cells.sum(0)) == [dom.n_elem for dom, _ in prob.form.terms]


@pytest.mark.parametrize("size", SIZES)
def test_torch_sharded_refine_matches_jax(world, size):
    """The sharded f32 MG-PCG inside the f64 refinement (bench.py
    --devices N) reaches the f64 residual, agrees with JAX's
    single-device solution on supported dofs and takes the single-device
    refinement's iterations to within 2; every rank returns the same
    bits."""
    _, ref, out = world
    ref = ref["refine"]
    mask = ref["diag"] > 0.05 * ref["diag"].max()
    scale = max(np.abs(ref["x"]).max(), 1.0)
    results = [r["refine"] for r in _rank_results(out, size)]
    for r in results:
        assert r["relres"] < 1e-10
        assert np.abs(r["x"].numpy()[mask] - ref["x"][mask]).max() <= (
            1e-7 * scale)
        assert abs(r["iters"] - ref["iters"]) <= 2
        assert torch.equal(r["x"], results[0]["x"])


# -- the port's hooks and checks (no ranks) ---------------------------------------


def _spd(n=60, seed=1):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = torch.as_tensor(Q @ Q.T + n * np.eye(n))
    return A, torch.as_tensor(rng.standard_normal(n))


def test_torch_cg_dot_hook_keeps_the_iterates():
    """With dot=torch.dot the iterates and the count are the default's,
    bit for bit (only the norms' rounding may differ)."""
    A, b = _spd()
    x0, i0 = krylov.cg(lambda v: A @ v, b, rtol=1e-10, check_every=2)
    x1, i1 = krylov.cg(lambda v: A @ v, b, rtol=1e-10, check_every=2,
                       dot=torch.dot)
    assert torch.equal(x0, x1) and i0.iters == i1.iters
    assert i1.converged


def test_torch_cg_dot_hook_forms_every_inner_product(monkeypatch):
    """Every inner product and norm of cg goes through the hook: 3 before
    the loop (‖b‖, r·z, ‖r‖), then 2 an iteration and 1 a check."""
    A, b = _spd()
    calls = []

    def dot(u, v):
        calls.append(1)
        return (u * v).sum()

    def refuse(*a, **k):
        raise AssertionError("a norm outside the hook")

    monkeypatch.setattr(torch.linalg, "vector_norm", refuse)
    monkeypatch.setattr(torch, "dot", refuse)
    x, info = krylov.cg(lambda v: A @ v, b, rtol=1e-10, check_every=1,
                        dot=dot)
    assert info.converged
    assert len(calls) == 3 + 3 * info.iters


def _refine_solver(n_bg=12):
    mesh_j, M_j = j_square(n_fg=2 * n_bg, n_bg=n_bg)
    st = from_numpy_state(device="cpu", **_state(mesh_j, M_j))
    prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                          device="cpu")
    return BinnedLatticeSolver(prob, st.M, (n_bg + 1,) * 2, device="cpu")


def test_torch_refine_cg_fn_hook():
    """refine(cg_fn=) runs the given CG in every pass; with the solver's
    own CG the result is the default's, bit for bit."""
    solver = _refine_solver()
    b64, K_cell, K_facet = solver.assemble()
    bound = solver.bind(K_cell, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    passes = []

    def cg_fn(S, m, r32, rtol_pass):
        passes.append(rtol_pass)
        return solver.cg(S, m, r32, rtol_pass)

    x0, rel0, it0 = solver.refine(S32, mg, bound, b64, 1e-10)
    x1, rel1, it1 = solver.refine(S32, mg, bound, b64, 1e-10, cg_fn=cg_fn)
    assert torch.equal(x0, x1) and rel0 == rel1 and it0 == it1
    assert rel1 < 1e-10 and len(passes) >= 1


def test_torch_solver_pickles_for_ranks():
    """A 2D solver sent to a rank keeps its tables and refines there; a 3D
    one refuses (its residual needs the problem's form)."""
    solver = _refine_solver()
    b64, K_cell, K_facet = solver.assemble()
    bound = solver.bind(K_cell, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    copy = pickle.loads(pickle.dumps(solver))
    assert not hasattr(copy, "prob")
    x0, rel0, _ = solver.refine(S32, mg, bound, b64, 1e-10)
    x1, rel1, _ = copy.refine(S32, mg, bound, b64, 1e-10)
    assert torch.equal(x0, x1) and rel0 == rel1
    mesh, M = immersed_cube_problem(n_fg=6, n_bg=4, device="cpu")
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device="cpu")
    solver3 = BinnedLatticeSolver(prob, M, (5, 5, 5), device="cpu")
    with pytest.raises(TypeError, match="3D"):
        pickle.dumps(solver3)


def test_torch_backend_checks():
    """nccl needs CUDA and one card per rank; an unknown backend raises."""
    with pytest.raises(ValueError, match="CUDA"):
        sharding.check_backend("nccl", 2, "cpu")
    with pytest.raises(ValueError, match="one rank on each card"):
        sharding.check_backend("nccl", torch.cuda.device_count() + 1,
                               "cuda")
    with pytest.raises(ValueError, match="backend"):
        sharding.check_backend("mpi", 2, "cpu")
    with pytest.raises(ValueError, match="nccl"):
        sharding.DeviceMesh(0, 2, "cpu", "nccl")
    sharding.check_backend("gloo", 4, "cpu")


def test_torch_nested_bounds():
    """Balanced on the coarsest level, each finer boundary twice the
    coarser's, the last at the level's row count; a row block too thin for
    its neighbours' halo raises."""
    rows = [1025, 513, 257, 129, 65]
    for size in (1, 3, 4, 8):
        levels = sharding.nested_bounds(rows, size)
        assert [b[-1] for b in levels] == rows
        assert levels[-1] == sharding.even_bounds(65, size)
        for fine, coarse in zip(levels[:-1], levels[1:]):
            assert fine[:-1] == [2 * c for c in coarse[:-1]]
            assert all(a < b for a, b in zip(fine[:-1], fine[1:]))
    from iifea_tpu_torch.parallel.stencil import RowBlock

    mesh = sharding.DeviceMesh(0, 4, "cpu")
    with pytest.raises(ValueError, match="at least 2 rows"):
        RowBlock((13, 13), 1, sharding.even_bounds(13, 4)[:2] + [4, 5, 13],
                 mesh, 2)


def test_torch_mesh_of_one_rank_is_local():
    """With one rank every collective is local: no halo but zeros, the
    gather and the sum are the identity."""
    mesh = sharding.DeviceMesh(0, 1, "cpu")
    x = torch.arange(12.0).reshape(1, 4, 3)
    ext = mesh.halo(x, 2)
    assert ext.shape == (1, 8, 3) and not ext[:, :2].any()
    assert torch.equal(ext[:, 2:6], x) and not ext[:, 6:].any()
    assert torch.equal(mesh.gather_rows(x, [0, 4]), x)
    assert torch.equal(mesh.all_reduce(x), x)
    assert mesh.collectives == 3 and mesh.route == "gloo"
