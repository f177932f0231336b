"""The port's sharded V-cycles (iifea_tpu_torch/parallel/multigrid.py) on
CPU ranks (gloo) against the JAX package's sharded cycles on the
conftest's 8 virtual devices and against the port's single-device
hierarchies they are built from:

* ``ShardedMultigrid2D`` on the binned immersed operator at n_bg=64 (the
  port's probe of the JAX package's mesh and extraction; the fine level
  sharded, 33² dense; 3e-6·max|z|): against JAX's on the f32 planes cast
  to f64 (in f32 the port's coarse inverse takes 44
  Newton-Schulz steps in f64 where JAX's takes 50 in f32, ROADMAP §3 P2,
  and the two single-device f32 cycles differ by 6% of max|z|), and in f32
  against the port's single-device cycle; at the default
  threshold, through the row-block interface, with a replicated smoothed
  level under a sharded one (the single-device fused calls), with the
  port's Chebyshev smoother (ROADMAP §3 R1: held to the port's
  single-device cycle), and as the preconditioner of a sharded CG;
* ``ShardedMultigrid3D`` on the f64 Dirichlet Laplacian of 33³ (1e-11),
  and its Jacobi option;
* ``ShardedMultigridBlock2D`` on a two-field f64 operator (1e-10), and
  inside a sharded block CG;

with one spawned world of 4 ranks whose first three also form a 3-rank
mesh. Then the demo's ``--devices 2`` against its single-device run, and
a rank's failure failing the launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from iifea_tpu.mesh.generators import immersed_square_problem as j_square
from iifea_tpu.ops.multigrid import StencilMultigridBlock as JMGBlock
from iifea_tpu.ops.multigrid import StencilMultigrid as JMG2
from iifea_tpu.ops.multigrid import StencilMultigrid3D as JMG3
from iifea_tpu.ops.stencil import StencilOperator2D as JS2
from iifea_tpu.ops.stencil import StencilOperatorBlock2D as JSb
from iifea_tpu.ops.stencil import dirichlet_laplace_3d
from iifea_tpu.parallel.multigrid import ShardedMultigrid2D as JShMG2
from iifea_tpu.parallel.multigrid import ShardedMultigrid3D as JShMG3
from iifea_tpu.parallel.multigrid import ShardedMultigridBlock2D as JShMGb
from iifea_tpu.parallel.sharding import make_device_mesh
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos import poisson as demo
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.multigrid import (
    StencilMultigrid,
    StencilMultigrid3D,
    StencilMultigridBlock,
)
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
)
from iifea_tpu_torch.parallel import sharding
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

SIZES = (4, 3)


def block_laplacian(n: int) -> np.ndarray:
    """(2, 2, 25, n, n) radius-2 planes of [[1, ¼], [¼, 1]] ⊗ L, L the
    5-point Dirichlet Laplacian with identity rows on the boundary: an SPD
    two-field operator."""
    L = np.zeros((25, n, n))
    inner = np.zeros((n, n), dtype=bool)
    inner[1:-1, 1:-1] = True
    L[12] = np.where(inner, 4.0, 1.0)
    for k in (7, 17, 11, 13):                 # the four axis neighbours
        L[k] = np.where(inner, -1.0, 0.0)
    return np.einsum("ab,kxy->abkxy", np.array([[1.0, 0.25], [0.25, 1.0]]),
                     L)


@pytest.fixture(scope="module")
def world():
    """Inputs, the JAX package's cycles, the port's single-device cycles
    and the ranks' results."""
    rng = np.random.default_rng(0)
    jmesh = make_device_mesh(8)
    # the binned f32 planes of the immersed operator, probed by the port
    # from the JAX package's mesh and extraction
    n_bg = 64
    mesh_j, M_j = j_square(n_fg=90, n_bg=n_bg, degree=1, dtype=np.float64)
    st = from_numpy_state(
        coords=mesh_j.coords, cells=mesh_j.cells, material=mesh_j.material,
        idx=M_j.idx_np, val=M_j.val_np, n_bg_dofs=M_j.n_bg_dofs,
        device="cpu")
    solver = BinnedLatticeSolver(
        PoissonProblem(st.mesh, k=1, sym=True, beta_value=10, device="cpu"),
        st.M, (n_bg + 1,) * 2, device="cpu")
    b64, K_cell, K_facet = solver.assemble()
    C2 = solver.probe(solver.bind(K_cell, K_facet)).coeffs.numpy()
    r2 = rng.standard_normal(C2[0].size).astype(np.float32)
    mg_j = JMG2(JS2(jnp.asarray(C2, jnp.float64), (n_bg + 1,) * 2, 2))
    ref = {"mg2_f64": jax.jit(JShMG2(mg_j, jmesh, min_shard_rows=40).minv)(
        jnp.asarray(r2, jnp.float64))}

    S3_j = dirichlet_laplace_3d((33, 33, 33))
    r3 = rng.standard_normal(S3_j.n)
    ref["mg3"] = jax.jit(JShMG3(JMG3(S3_j), jmesh, min_shard_rows=32).minv)(
        jnp.asarray(r3))

    Cb = block_laplacian(25)
    rb = rng.standard_normal(2 * 25 * 25)
    Sb_j = JSb(jnp.asarray(Cb), (25, 25), 2)
    ref["mgb"] = jax.jit(JShMGb(JMGBlock(Sb_j), jmesh,
                                min_shard_rows=16).minv)(jnp.asarray(rb))

    S2 = StencilOperator2D(torch.as_tensor(C2), (n_bg + 1,) * 2, 2)
    S3 = StencilOperator3D(torch.as_tensor(np.asarray(S3_j.coeffs)),
                           (33, 33, 33), 1)
    Sb = StencilOperatorBlock2D(torch.as_tensor(Cb), (25, 25), 2)
    d = {"r2": r2, "r3": r3, "rb": rb,
         "mg2": StencilMultigrid(S2),
         "mg2_f64": StencilMultigrid(S2.to(torch.float64)),
         "mg2_deep": StencilMultigrid(S2, min_size=9),
         "mg2_cheb": StencilMultigrid(S2, smoother="chebyshev"),
         "mg3": StencilMultigrid3D(S3),
         "mg3_jacobi": StencilMultigrid3D(S3, smoother="jacobi"),
         "mgb": StencilMultigridBlock(Sb),
         "b2": b64.to(torch.float32)}
    # a block rhs in the operator's range
    d["bb"] = Sb.mv(torch.as_tensor(rng.standard_normal(Sb.n)))
    single = {k: d[k].minv(torch.as_tensor(d[v]))
              for k, v in (("mg2", "r2"), ("mg2_deep", "r2"),
                           ("mg2_cheb", "r2"), ("mg3", "r3"),
                           ("mg3_jacobi", "r3"), ("mgb", "rb"))}
    out = sharding.launch(ranks.mg_checks, 4, "gloo", args=(d,),
                          device="cpu", timeout=600)
    return d, {k: np.asarray(v) for k, v in ref.items()}, single, out


def _rank_results(out, size):
    return [r[size] for r in out[:size]]


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key,rel", [("mg2_f64", 3e-6), ("mg3", 1e-11),
                                     ("mgb", 1e-10)])
def test_torch_sharded_vcycle_matches_jax(world, key, rel, size):
    """ShardedMultigrid2D / 3D / Block2D minv == JAX's sharded minv with
    the fine level sharded and the coarse ones replicated."""
    _, ref, _, out = world
    for r in _rank_results(out, size):
        assert _close(r[key], ref[key], rel), key


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["mg2", "mg2_default", "mg2_local",
                                 "mg2_deep", "mg2_cheb", "mg3",
                                 "mg3_default", "mg3_jacobi", "mgb"])
def test_torch_sharded_vcycle_matches_single_device(world, key, size):
    """Every sharded cycle == the single-device cycle it is built from, to
    f32 (f64) rounding: the default threshold, the row-block interface, a
    replicated smoothed level (fused calls) under a sharded one, the 2D
    Chebyshev and 3D Jacobi smoother options."""
    _, _, single, out = world
    base = key.split("_")[0] if key in ("mg2_default", "mg2_local",
                                        "mg3_default") else key
    rel = 3e-6 if base.startswith("mg2") else 1e-11
    for r in _rank_results(out, size):
        assert _close(r[key], single[base], rel), key


@pytest.mark.parametrize("size", SIZES)
def test_torch_sharded_levels(world, size):
    """min_shard_rows picks the sharded levels as in the JAX package:
    40 shards 65² only; the default max(4·ranks, 16) every level but the
    dense 33²; nested row blocks, balanced on the coarsest sharded
    level."""
    _, _, _, out = world
    for r in _rank_results(out, size):
        assert r["mg2_sharded"] == 1 and r["mg2_default_sharded"] == 1
        assert r["mg2_deep_sharded"] == 1 and r["mgb_sharded"] == 1
        assert r["mg2_bounds"] == [sharding.even_bounds(65, size)]


@pytest.mark.parametrize("size", SIZES)
def test_torch_sharded_mg_pcg(world, size):
    """CG on the row blocks preconditioned by the sharded V-cycle (dots
    summed over the ranks, no gather in the loop) converges like the
    single-device MG-PCG and agrees on supported dofs; the block CG too."""
    d, _, _, out = world
    from iifea_tpu_torch.solvers import krylov

    mg2 = d["mg2"]
    S = mg2.levels[0]
    b = torch.as_tensor(d["b2"])
    x_ref, info_ref = krylov.cg(S.mv, b, minv=mg2.minv, rtol=1e-6,
                                atol=1e-30, max_it=400, check_every=4)
    diag = S.diag()
    mask = diag > 0.05 * diag.max()
    scale = max(float(x_ref.abs().max()), 1.0)
    Sb = d["mgb"].levels[0]
    for r in _rank_results(out, size):
        p = r["pcg2"]
        assert p["converged"] and abs(p["iters"] - info_ref.iters) <= 4
        assert float((p["x"] - x_ref)[mask].abs().max()) <= 2e-4 * scale
        p = r["pcgb"]
        assert p["converged"]
        rel = float(torch.linalg.vector_norm(Sb.mv(p["x"]) - d["bb"])
                    / torch.linalg.vector_norm(d["bb"]))
        assert rel < 1e-6


def test_torch_demo_poisson_devices_matches_single_device(capsys):
    """demos/poisson.py --devices 2 --ref 2 (the cell-sharded Jacobi-CG
    over two gloo ranks) against the single-device demo with the same
    Krylov method (--solv cg): error norms to 1e-8; the route is
    printed."""
    one = demo.main(["--ref", "2", "--solv", "cg", "--device", "cpu"])
    two = demo.main(["--ref", "2", "--devices", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "SPMD solve over 2 ranks (gloo)" in printed
    for k in ("L2", "H10", "H1"):
        assert abs(two["norms"][k] - one["norms"][k]) <= (
            1e-8 * one["norms"][k]), k
    assert two["info"].converged
    assert torch.equal(two["ranks"][0]["u_p"], two["ranks"][1]["u_p"])


def test_torch_launch_fails_with_a_rank():
    """A rank that raises fails the whole launch, with its traceback; the
    other ranks are stopped."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one"):
        sharding.launch(ranks.fail_on_rank_one, 2, "gloo", device="cpu",
                        timeout=120)
