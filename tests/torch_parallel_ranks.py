"""Rank programs of the sharded-port tests (``test_torch_parallel*.py``).

``parallel.sharding.launch`` runs them in spawned processes, which import
this module by name: it imports torch and the port only, never JAX. Each
program runs every check of its test file on the world (4 ranks) and on a
3-rank sub-group of it (uneven row blocks), and returns the results by
world size; the tests assert on them.
"""
import torch
import torch.distributed as dist

from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
)
from iifea_tpu_torch.parallel.multigrid import (
    ShardedMultigrid2D,
    ShardedMultigrid3D,
    ShardedMultigridBlock2D,
    refine_sharded,
)
from iifea_tpu_torch.parallel.sharding import (
    DeviceMesh,
    ShardedProjectedSystem,
)
from iifea_tpu_torch.parallel.stencil import (
    ShardedStencil2D,
    ShardedStencil3D,
    ShardedStencilBlock2D,
)
from iifea_tpu_torch.solvers import krylov


def meshes(mesh: DeviceMesh):
    """[(world size, mesh)]: the world, and the sub-group of its first
    three ranks (on the ranks that belong to it). The checks are small:
    one thread a rank keeps them off the other test workers' cores."""
    torch.set_num_threads(1)
    group = dist.new_group([0, 1, 2])
    out = [(mesh.size, mesh)]
    if mesh.rank < 3:
        out.append((3, DeviceMesh(mesh.rank, 3, mesh.device, mesh.backend,
                                  group)))
    return out


def _t(a, device):
    return torch.as_tensor(a).to(device)


def system_checks(mesh: DeviceMesh, d: dict) -> dict:
    """The sharded applies (2D, 3D, block) on the given planes, the cell-
    sharded background system at the given state, and the sharded MG-PCG
    refinement of the given 2D solver."""
    out = {}
    dev = mesh.device
    for size, m in meshes(mesh):
        r = {}
        S2 = StencilOperator2D(_t(d["C2"], dev), d["shape2"], 2)
        r["y2"] = ShardedStencil2D(S2, m).mv(_t(d["x2"], dev))
        S3 = StencilOperator3D(_t(d["C3"], dev), d["shape3"], 2)
        r["y3"] = ShardedStencil3D(S3, m).mv(_t(d["x3"], dev))
        Sb = StencilOperatorBlock2D(_t(d["Cb"], dev), d["shape2"], 2)
        r["yb"] = ShardedStencilBlock2D(Sb, m).mv(_t(d["xb"], dev))
        Ssh = ShardedStencil2D(S2, m)
        r["diag2"] = Ssh.unshard_vec(Ssh.diag2())

        st = from_numpy_state(device=dev, **d["state"])
        prob = PoissonProblem(st.mesh, k=1, sym=True, beta_value=10,
                              device=dev)
        system = ShardedProjectedSystem(prob.form, st.M, m)
        n = st.M.n_bg_dofs
        blocks = system.assemble_blocks(torch.zeros(n, dtype=torch.float64,
                                                    device=dev))
        c0 = m.collectives
        r["matvec"] = system.matvec(blocks, _t(d["x_bg"], dev))
        r["matvec_collectives"] = m.collectives - c0
        r["diag"] = system.diag(blocks)
        r["residual"] = system.residual_b(_t(d["u_bg"], dev))
        r["cells"] = [t.n_elem for t in system.terms]

        x, relres, iters = refine_sharded(m, *d["refine"], rtol=1e-10)
        r["refine"] = {"x": x, "relres": relres, "iters": iters}
        out[size] = r
    return out


def _pcg(m, S, mg, b, sharded_stencil, sharded_mg, rtol, **mg_kw):
    """Sharded CG preconditioned by the sharded V-cycle, no gather inside
    the loop; returns (global x, info)."""
    smg = sharded_mg(mg, m, **mg_kw)
    Ssh = sharded_stencil(S, m, bounds=smg.bounds0)
    x, info = krylov.cg(Ssh.mv_local, Ssh.shard_vec(b), minv=smg.minv_local,
                        rtol=rtol, atol=1e-30, max_it=400, check_every=4,
                        dot=m.dot)
    return Ssh.unshard_vec(x), info


def mg_checks(mesh: DeviceMesh, d: dict) -> dict:
    """The sharded V-cycles (2D binned f32, with the port's other 2D
    cycles; 3D; block) against their single-device hierarchies, and the
    sharded MG-PCG solves."""
    out = {}
    dev = mesh.device
    for size, m in meshes(mesh):
        r = {}
        mg2, r2 = d["mg2"], _t(d["r2"], dev)
        smg = ShardedMultigrid2D(mg2, m, min_shard_rows=40)
        r["mg2"] = smg.minv(r2)
        r["mg2_sharded"] = smg.n_sharded
        r["mg2_f64"] = ShardedMultigrid2D(d["mg2_f64"], m, 40).minv(
            r2.to(torch.float64))
        smg = ShardedMultigrid2D(mg2, m)
        r["mg2_default"] = smg.minv(r2)
        r["mg2_default_sharded"] = smg.n_sharded
        r["mg2_bounds"] = smg.bounds
        # the slab interface: the fine operator's row blocks are the
        # cycle's, so minv_local takes shard_vec's rows as they are
        Ssh = ShardedStencil2D(mg2.levels[0], m, bounds=smg.bounds0)
        r["mg2_local"] = Ssh.unshard_vec(smg.minv_local(Ssh.shard_vec(r2)))
        # a replicated smoothed level (fused calls) under a sharded one
        smg = ShardedMultigrid2D(d["mg2_deep"], m, min_shard_rows=40)
        r["mg2_deep"] = smg.minv(r2)
        r["mg2_deep_sharded"] = smg.n_sharded
        r["mg2_cheb"] = ShardedMultigrid2D(d["mg2_cheb"], m).minv(r2)
        x, info = _pcg(m, mg2.levels[0], mg2, _t(d["b2"], dev),
                       ShardedStencil2D, ShardedMultigrid2D, 1e-6)
        r["pcg2"] = {"x": x, "iters": info.iters,
                     "converged": info.converged}

        r3 = _t(d["r3"], dev)
        r["mg3"] = ShardedMultigrid3D(d["mg3"], m, min_shard_rows=32).minv(r3)
        r["mg3_default"] = ShardedMultigrid3D(d["mg3"], m).minv(r3)
        r["mg3_jacobi"] = ShardedMultigrid3D(d["mg3_jacobi"], m).minv(r3)

        rb = _t(d["rb"], dev)
        smg = ShardedMultigridBlock2D(d["mgb"], m, min_shard_rows=16)
        r["mgb"] = smg.minv(rb)
        r["mgb_sharded"] = smg.n_sharded
        Sb = d["mgb"].levels[0]
        x, info = _pcg(m, Sb, d["mgb"], _t(d["bb"], dev),
                       ShardedStencilBlock2D, ShardedMultigridBlock2D, 1e-8,
                       min_shard_rows=16)
        r["pcgb"] = {"x": x, "iters": info.iters,
                     "converged": info.converged}
        out[size] = r
    return out


def fail_on_rank_one(mesh: DeviceMesh) -> None:
    """Rank 1 raises; the others wait for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    mesh.barrier()


def card_checks(mesh: DeviceMesh, S, mg) -> dict:
    """The sharded 2D apply and V-cycle on the card against the
    single-device ones, with the kernels each launched on this rank."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator().manual_seed(5)
    r = torch.randn(S.n, generator=gen).to(mesh.device)
    smg = ShardedMultigrid2D(mg, mesh)
    Ssh = ShardedStencil2D(S, mesh, bounds=smg.bounds0)
    sk.reset_launches()
    y = Ssh.mv(r)
    apply_launches = sk.launches()["stencil_mv"]
    z = smg.minv(r)
    counts = {k: v for k, v in sk.launches().items() if v}
    return {"y": y, "y_ref": S.mv(r), "z": z, "z_ref": mg.minv(r),
            "apply_launches": apply_launches, "launches": counts,
            "route": mesh.route}
