#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (iifea_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printed on its own line; the first failure exits non-zero:

  0. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
     requires torch.cuda.is_available().
  1. build: compiles iifea_tpu_torch/csrc/stencil2d.cu with nvcc (sm_90a).
  2. kernels: stencil_mv and jacobi_smooth against their plain PyTorch
     versions on the card; median kernel and plain times at 1025², r=2.
  3. small reference: the card's n_bg=64 solution checked with a host f64
     residual, and the n_bg=24 card and host solutions compared.
  4. main path: BinnedLatticeSolver.solve at n_bg=1024 (1,050,625
     background dofs) once with the kernel launch counters reset, then
     per-stage times, a profiled warm solve (device busy share, top
     kernels), warm end-to-end times and error norms.

The line before the last is the kernel summary JSON, the last line the
device JSON. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SOURCE = "iifea_tpu_torch/csrc/stencil2d.cu"
REPLACES = {
    "stencil_mv": "iifea_tpu/ops/pallas_stencil.py:127",
    "jacobi_smooth": "iifea_tpu/ops/pallas_stencil.py:136",
}
TOL = 1e-4          # max|y - y_plain| <= TOL * max|y_plain| (f32 sum order)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of fn() on the card, one CUDA event pair each."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from iifea_tpu_torch.ops import stencil_kernels as sk

    nv = subprocess.run([sk._nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=nv.stdout.strip().splitlines()[-1] if nv.stdout else None,
          name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())


def phase_build():
    from iifea_tpu_torch.ops import stencil_kernels as sk

    t = time.perf_counter()
    path = sk.build()
    sk._lib()
    dt = time.perf_counter() - t
    log = path.with_suffix(".log")
    ptxas = log.read_text().strip().splitlines() if log.exists() else []
    phase("build", seconds=dt, library=str(path.relative_to(HERE)),
          ptxas=[l for l in ptxas if "Used" in l])


def phase_kernels():
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    worst = {"stencil_mv": 0.0, "jacobi_smooth": 0.0}

    def operands(shape, radius):
        m = 2 * radius + 1
        n = shape[0] * shape[1]
        C = torch.tensor(rng.standard_normal((m * m, *shape)),
                         dtype=torch.float32, device=dev)
        x = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        return C, x, n

    def check(name, y, y_ref, shape, radius):
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        bound = TOL * float(y_ref.abs().max())
        phase("kernel_check", kernel=name, shape=list(shape), radius=radius,
              max_abs_err=err, bound=bound)
        if not err <= bound:
            fail(f"{name} {shape} r={radius}: {err} > {bound}")
        worst[name] = max(worst[name], err)

    for shape in [(17, 17), (33, 129), (40, 200)]:
        for radius in (1, 2):
            C, x, _ = operands(shape, radius)
            check("stencil_mv", sk.stencil_mv(C, x, shape, radius),
                  sk.stencil_mv_plain(C, x, shape, radius), shape, radius)
    timing = {}
    for shape in [(21, 35), (1025, 1025)]:
        C, x, n = operands(shape, 2)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        invd = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
        om = 0.67
        if shape == (1025, 1025):
            check("stencil_mv", sk.stencil_mv(C, x, shape, 2),
                  sk.stencil_mv_plain(C, x, shape, 2), shape, 2)
        check("jacobi_smooth", sk.jacobi_smooth(C, invd, b, x, om, shape, 2),
              sk.jacobi_smooth_plain(C, invd, b, x, om, shape, 2), shape, 2)
        if shape == (1025, 1025):
            timing["stencil_mv"] = (
                cuda_ms(lambda: sk.stencil_mv(C, x, shape, 2)),
                cuda_ms(lambda: sk.stencil_mv_plain(C, x, shape, 2)),
            )
            timing["jacobi_smooth"] = (
                cuda_ms(lambda: sk.jacobi_smooth(C, invd, b, x, om, shape, 2)),
                cuda_ms(lambda: sk.jacobi_smooth_plain(C, invd, b, x, om,
                                                       shape, 2)),
            )
    for name, (ms, plain_ms) in timing.items():
        phase("kernel_time", kernel=name, shape=[1025, 1025], radius=2,
              ms=ms, plain_ms=plain_ms)
    return worst, timing


N_BG = 1024                      # 1,050,625 background dofs (headline size)
MAX_CG_ITERS = 96                # 2x the reference's 48 iterations at n_bg=1024


def fg_of(n_bg: int) -> int:
    """Foreground divisions: the sqrt(2) fg/bg spacing ratio of the
    reference workloads (bench.py)."""
    return int(n_bg * 1.4142) // 2 * 2


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def build_solver(n_bg: int, device):
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

    t0 = time.perf_counter()
    mesh, M = immersed_square_problem(n_fg=fg_of(n_bg), n_bg=n_bg,
                                      device=device)
    t1 = time.perf_counter()
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=device)
    t2 = time.perf_counter()
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1, n_bg + 1),
                                 device=device)
    t3 = time.perf_counter()
    return mesh, M, prob, solver, {
        "immersed_square_problem": t1 - t0, "PoissonProblem": t2 - t1,
        "BinnedLatticeSolver": t3 - t2}


def phase_small_reference():
    """Small problems against host references: at n_bg=64 (a 3-level
    V-cycle on the kernels) the card's solution has a host-measured f64
    residual below 1e-10; at n_bg=24 the card and host (plain versions)
    solutions agree on supported dofs to 1e-7·max(|u|, 1), the criterion
    of the JAX package's end-to-end test."""
    import torch

    from iifea_tpu_torch.ops import lattice_bin

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    *_, s_gpu, _ = build_solver(64, gpu)
    *_, s_cpu, _ = build_solver(64, cpu)
    u_gpu, info = s_gpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    r = b - lattice_bin.apply_binned(s_cpu.reducers, s_cpu.bind(Kc, Kf),
                                     u_gpu.cpu())
    relres = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    phase("small_reference", n_bg=64, host_rel_residual=relres, **info)
    if not relres < 1e-10:
        fail(f"host-measured residual of the card's solution {relres}")

    *_, s_gpu, _ = build_solver(24, gpu)
    *_, s_cpu, _ = build_solver(24, cpu)
    u_gpu, info_gpu = s_gpu.solve(rtol=1e-10)
    u_cpu, info_cpu = s_cpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    d = s_cpu.probe(s_cpu.bind(Kc, Kf)).diag().abs() > 0
    bound = 1e-7 * max(float(u_cpu.abs().max()), 1.0)
    err = float((u_gpu.cpu() - u_cpu)[d].abs().max())
    phase("small_reference", n_bg=24, max_abs_diff=err, bound=bound,
          gpu=info_gpu, cpu=info_cpu)
    if not err <= bound:
        fail(f"card and host solves differ by {err}")


def on_cuda(solver, u, S32, mg) -> bool:
    tensors = [u, S32.coeffs, mg.coarse_inv, solver.JinvT_b,
               solver.wdetT_b, *mg.inv_diags,
               *(lv.coeffs for lv in mg.levels),
               *(t for t in solver.rhs_tables.values() if t is not None)]
    for red in solver.reducers:
        tensors += [red.val_b, red.kappa, red.perm]
    return all(t.is_cuda for t in tensors)


def profile_solve(solver) -> None:
    """Device busy share and the top kernels of one warm solve, from
    torch.profiler (CUPTI); reports "not measured" if no device time shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = sync_time(lambda: solver.solve(rtol=1e-10))
    # kernel-level events only: op-level events carry the same device time
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in dev)
    if busy_us <= 0:
        phase("profile", device_time="not measured", wall_seconds=wall)
        return
    dev.sort(key=lambda e: -e[1])
    phase("profile", wall_seconds=wall, device_busy_seconds=busy_us / 1e6,
          device_idle_share=1.0 - busy_us / 1e6 / wall,
          kernel_launches=sum(c for *_, c in dev),
          top=[{"name": k[:80], "seconds": t / 1e6, "count": c}
               for k, t, c in dev[:8]])


def phase_main_path():
    """Returns the kernel launch counts of one solve() at n_bg = N_BG."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    mesh, M, prob, solver, setup = build_solver(N_BG, dev)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is enabled for f32 convolutions or matmuls")
    phase("setup", n_bg=N_BG, n_fg=fg_of(N_BG), n_bg_dofs=M.n_bg_dofs,
          n_cells=mesh.n_cells, n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem,
          tables=[list(r.meta) for r in solver.reducers], seconds=setup)

    # the main path, once, through the user entry point; counted
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    (u, info), t_first = sync_time(lambda: solver.solve(rtol=1e-10))
    launches = {"stencil_mv": sk.stencil_mv.launches,
                "jacobi_smooth": sk.jacobi_smooth.launches}
    phase("solve", first_seconds=t_first, launches=launches,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30, **info)
    if not info["rel_residual"] < 1e-10:
        fail(f"relative f64 residual {info['rel_residual']} >= 1e-10")
    if not info["cg_iters"] <= MAX_CG_ITERS:
        fail(f"{info['cg_iters']} CG iterations > {MAX_CG_ITERS}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    if not (u.shape == (M.n_bg_dofs,) and bool(torch.isfinite(u).all())):
        fail("solution is not a finite vector of the background size")

    # per-stage times of a warm solve (PERF.md's phases), synced per stage
    t_cg, t_res = [0.0], [0.0]
    cg0, res0 = solver.cg, solver.residual

    def timed(fn, acc):
        def wrapped(*a):
            out, dt = sync_time(lambda: fn(*a))
            acc[0] += dt
            return out
        return wrapped

    solver.cg, solver.residual = timed(cg0, t_cg), timed(res0, t_res)
    (b64, Kc, Kf), t_asm = sync_time(solver.assemble)
    bound, t_bind = sync_time(lambda: solver.bind(Kc, Kf))
    S32, t_probe = sync_time(lambda: solver.probe(bound))
    mg, t_mg = sync_time(lambda: solver.build_mg(S32))
    (x, relres, iters), t_ref = sync_time(
        lambda: solver.refine(S32, mg, bound, b64, 1e-10))
    solver.cg, solver.residual = cg0, res0
    phase("stages", element_jacobians_rhs=t_asm, bind=t_bind,
          stencil_extraction=t_probe, multigrid_hierarchy=t_mg,
          refine=t_ref, refine_cg=t_cg[0], refine_residual=t_res[0],
          cg_iters=iters, rel_residual=relres, levels=len(mg.levels))
    if not on_cuda(solver, u, S32, mg):
        fail("a solver tensor is not on the card")

    profile_solve(solver)
    totals = []
    for _ in range(3):
        _, dt = sync_time(lambda: solver.solve(rtol=1e-10))
        totals.append(dt)
    norms = prob.error_norms(M.mv(u))
    phase("end_to_end", warm_seconds=totals, best=min(totals),
          error_norms=norms)
    if not all(v == v and 0 < v < 1e-2 for v in norms.values()):
        fail(f"error norms out of range: {norms}")
    return launches


def main() -> None:
    phase_device()
    phase_build()
    worst, timing = phase_kernels()
    phase_small_reference()
    launches = phase_main_path()
    import torch

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": timing[name][0],
         "plain_ms": timing[name][1]}
        for name in ("stencil_mv", "jacobi_smooth")
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
