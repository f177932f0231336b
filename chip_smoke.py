#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (iifea_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py`` (``--phases`` runs
a comma-separated subset, for debugging). Phases, each printed on its own
line; the first failure exits non-zero:

  0. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
     requires torch.cuda.is_available().
  1. build: compiles every iifea_tpu_torch/csrc/*.cu (stencil2d.cu,
     stencil3d.cu) with nvcc (sm_90a), one nvcc per source in parallel.
  2. kernels: stencil_mv, jacobi_smooth, stencil_mv_block (the block
     apply and residual in one launch) and smooth (a level's ν sweeps and
     trailing residual, by each route: one launch per pass, and one
     cooperative launch where the level's tiles are co-resident; where
     they are not, that launch must be refused) against their plain
     PyTorch versions on the card,
     for 1 to 3 fields, r = 1, 2, ν = 1, 2, 3, from x and from zero, with
     and without the residual, at odd shapes and at every level shape; at
     every level shape the V-cycles smooth (scalar 1025² … 65², block
     513² … 17²; r=2) the device time per launch or per smoothing call (a
     CUDA graph of 50 calls, one event pair around its replay), the
     per-call time from an idle card (one event pair around one call: the
     wrapper's host work included) and the bound; the plain versions'
     device times at the main-path shapes.
  3. kernels3: stencil_mv3, jacobi_smooth3 and cheb_step3 against their
     plain versions at small shapes and at 105³; a soak of thousands of
     interleaved radius-2 launches over 105³, 53³, 27³ and 14³ (the 3D
     V-cycle's levels), synchronised and compared; times as in phase 2 at
     105³, 53³ and 27³. Then stencil3d_block (the 3D block apply,
     residual, point-block sweep and sweep from zero, one launch each)
     against its plain versions for 1 to 3 fields, r = 1, 2, at small
     shapes and at every level shape of the 3D block V-cycle (97³ … 13³),
     scalar planes also against stencil_mv3 / jacobi_smooth3, a soak of
     interleaved launches, and times at 3 and 2 fields.
  4. small reference: the card's n_bg=64 2D solution checked with a host
     f64 residual, and the n_bg=24 card and host solutions compared; the
     Chebyshev smoother option inside the n_bg=64 solve.
  5. small reference 3D: the card's n_bg=16 solution checked with a host
     f64 residual; the n_bg=8 card and host solutions' error norms
     compared, and the card's iteration count there (one 9³ level: the
     dense coarse inverse is the whole preconditioner) held to 2x the
     host's 32; the Jacobi smoother option inside the n_bg=16 solve.
  6. main path 2D: BinnedLatticeSolver.solve at n_bg=1024 (1,050,625
     background dofs) once with the kernel launch counters reset (and
     counted per lattice shape), then per-stage times, a profiled warm
     solve (device busy share, top kernels), warm end-to-end times and
     error norms. Then the solver front-end on the same problem (the
     solver freed first): assemble_background_system and
     solve_ksp(pc='mg') with CG and with GMRES, each counted, checked for
     residual, iterations, kernels, device and agreement with the
     BinnedLatticeSolver's solution; then solve_ksp(pc='mg') with BFR
     trimming, whose planes come from the coloured general probe of
     A.mv_multi, with its residual, peak memory and error-norm gates.
  7. main path 3D: the same at n_bg=104 (105³ = 1,157,625 background dofs,
     13,182,000 foreground tetrahedra), with host setup per stage, table
     bytes and peak device memory, the front-end with CG and the trimmed
     general-probe solve; its error norms must be below those of an
     n_bg=52 solve.
  8. demo: ``python3 -m iifea_tpu_torch.demos.poisson --ref 4 --solv gmres
     --pc jacobi`` on the card (the general operator, no stencil kernel),
     held against the same demo on the host.
  9. elasticity (the block path): at n_bg=64 the card's block-MG CG and
     point-block-Jacobi CG against host SuperLU (error norms to 1e-8
     relative); then ``assemble_background_system`` + ``solve_ksp(cg,
     pc='mg', n_fields=2)`` at n_bg=512 (2 × 513² = 526,338 background
     dofs), once counted per lattice shape (every block apply is one
     launch, at most 1,056 stencil launches per solve; no plain stencil
     apply on the card outside the coarsest level's dense inverse), then
     per-stage times, a profiled
     solve and peak memory; its error norms must be below an n_bg=256
     solve's with an L2 rate above 1.5.
  10. demo_elasticity: ``python3 -m iifea_tpu_torch.demos.linear_elasticity
     --mesh-root synthetic --k 1 --ref 3`` on the card (block-MG CG),
     held against the same demo on the host (norms to 1e-8 relative).
  11. elasticity3 (the 3D block path): 3D immersed elasticity at n_bg=8
     and 16 against host SuperLU, then ``solve_ksp(cg, pc='mg',
     n_fields=3)`` at n_bg=96 (3 × 97³ = 2,738,019 background dofs),
     counted per lattice shape (5 stencil3d_block launches per smoothed
     level per V-cycle, one per Krylov matvec), staged, profiled; error
     norms below an n_bg=48 solve's with an L2 rate above 1.5.
  12. newton: ``solve_nonlinear(linear_pc='mg')`` on the nonlinear
     diffusion form at n_bg=1024 (every Newton step assembled and solved
     on the card, stencil launches in every step), held at n_bg=64
     against the host's iteration count and the Jacobi run's iterate; the
     line-search case and ``solve_newtons_linear`` with pinned dofs.
  13. asm: ``solve_ksp(gmres, pc='asm')`` on immersed Poisson n_bg=256
     against pc='jacobi'.

Then ``kernel_shapes``: every timed (kernel, shape) with its launches in the
main-path solves (2D, 3D and elasticity, added) and launches × (device ms
− bound ms) per kernel; a block operator's shape carries its field count
first (2x513x513), and a smoothing call is booked by its form
(``smooth_call@…:pre`` from zero with the residual, ``:post`` from x).
The line before the last is the kernel summary JSON, the last line the
device JSON. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SOURCE2, SOURCE3 = ("iifea_tpu_torch/csrc/stencil2d.cu",
                    "iifea_tpu_torch/csrc/stencil3d.cu")
KERNELS = {   # name: (source, TPU kernel it replaces)
    "stencil_mv": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:127"),
    "jacobi_smooth": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:136"),
    "stencil_mv3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
    "jacobi_smooth3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # the fused Chebyshev step extends jacobi_smooth3 to the 3D V-cycle's
    # smoother: one pass per sweep
    "cheb_step3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # stencil_mv for block operators: all nF output fields in one launch,
    # with the residual epilogue b − A x
    "stencil_mv_block": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:127"),
    # jacobi_smooth for a whole level: ν sweeps and the residual in one
    # launch (a cooperative grid)
    "smooth": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:136"),
    # stencil_mv3 / jacobi_smooth3 for 3D block operators: apply, residual
    # or point-block sweep of all nF fields in one launch
    "stencil3d_block": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
}
TOL = 1e-4          # max|y - y_plain| <= TOL * max|y_plain| (f32 sum order)
GRAPH_LAUNCHES = 50           # captured calls per timed CUDA graph
# the V-cycle's smoothed levels (the coarsest, 33² and 14³, is dense)
LEVELS2 = [(s_, s_) for s_ in (1025, 513, 257, 129, 65)]
# the block V-cycle smooths 513² down to 17² (9² is dense); the shapes it
# adds to LEVELS2 (stencil_mv only: it smooths by point-block Jacobi)
BLOCK_SMOOTHED = [(s_, s_) for s_ in (513, 257, 129, 65, 33, 17)]
BLOCK_EXTRA = [s_ for s_ in BLOCK_SMOOTHED if s_ not in LEVELS2]
N_FIELDS_EL = 2               # fields of the elasticity block operator
# the V-cycle's two smoothing calls per level: (from zero, with residual)
FORMS = {"pre": (True, True), "post": (False, False)}
NU = 2                        # sweeps per smoothing call (nu_pre = nu_post)
MAX_STENCIL_LAUNCHES_EL = 1056   # a quarter of the 4,224 of nF² launches
MAX_LAUNCHES_EL = 8500        # all kernels of the profiled elasticity solve
LEVELS3 = [(s_,) * 3 for s_ in (105, 53, 27)]
N_BG_EL3 = 96                 # 97 → 49 → 25 → 13 smoothed, 3 × 7³ dense
N_FIELDS_EL3 = 3
BLOCK3_SMOOTHED = [(s_,) * 3 for s_ in (97, 49, 25, 13)]
# the 3D block cycle (ω = 1 point-block Jacobi on l1-regularised blocks, as
# the reference's) is not mesh-independent: on the host the port takes 88 /
# 108 / 128 CG iterations at n_bg = 16 / 24 / 32
# (tests/compare_block_mg_iters.py --dim 3); the bound leaves that growth
# room up to n_bg = 96 and catches a cycle that stops contracting
MAX_CG_ITERS_EL3 = 400
MAX_CG_ITERS_EL3_SINGLE = 60     # the reference's bound at one dense level
# stencil3d_block launches per smoothed level per V-cycle: the sweep from
# zero, a sweep, the residual, two post-sweeps (nu_pre = nu_post = NU)
LAUNCHES_PER_LEVEL3 = 2 * NU + 1
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
# f32 vectors each kernel reads or writes once besides its coefficient
# planes: x, y; + invd, b; + d read and written
VECTORS = {"stencil_mv": 2, "jacobi_smooth": 4, "stencil_mv3": 2,
           "jacobi_smooth3": 4, "cheb_step3": 6}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def call_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of one call of fn() from an idle card: one CUDA
    event pair around the call, so the interval holds the wrapper's host
    work before the launch as well as the kernel."""
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


def device_ms(fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device milliseconds per call of fn(): a CUDA graph of ``launches``
    captured calls (cooperative launches are captured like any other), one CUDA event pair around each replay, divided by the count;
    the median of ``reps`` replays. No host time is in the interval.
    Consecutive calls find their operands in the 50 MB L2 where they fit,
    as the V-cycle's repeated sweeps on one level do."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    times.sort()
    return times[len(times) // 2]


def time_kernel(name, shape, fn, plain=None, bound_=None, plain_launches=10,
                **kv) -> dict:
    """One ``kernel_time`` line: device ms, call ms and bound at ``shape``
    (and the plain version's device ms where ``plain`` is given).
    ``bound_`` is (ms, by) where the row is not one launch of ``name``."""
    b_ms, by = bound_ or bound(name, shape)
    row = {"kernel": name, "shape": list(shape), "radius": 2, **kv,
           "device_ms": device_ms(fn), "call_ms": call_ms(fn),
           "bound_ms": b_ms, "bound_by": by}
    if plain is not None:
        row["plain_ms"] = device_ms(plain, launches=plain_launches, reps=3)
    row["share_of_bound"] = b_ms / row["device_ms"]
    phase("kernel_time", **row)
    return row


def _bound_ms(words: float, flops: float, n: int) -> tuple[float, str]:
    """The larger of ``words`` f32 values per point over the memory rate and
    ``flops`` per point over the f32 rate, on n points, in ms."""
    t_bytes = 4.0 * n * words / HBM_BYTES_PER_S
    t_ops = flops * n / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound(name: str, shape, radius: int = 2) -> tuple[float, str]:
    """Least milliseconds the card needs for one call at ``shape``: the
    larger of the compulsory bytes (each coefficient plane and vector read
    or written once) over the memory rate and the f32 multiply-adds over
    the f32 rate. Returns (ms, "bytes" | "operations")."""
    n = 1
    for s_ in shape:
        n *= s_
    taps = (2 * radius + 1) ** len(shape)
    return _bound_ms(taps + VECTORS[name], 2.0 * taps + 4.0, n)


def bound_passes(shape, n_fields: int, passes, radius: int = 2):
    """The bound of a sequence of passes on an nF-field 2D or 3D (by
    ``shape``'s rank) operator, the
    same work whatever launches carry it: per pass every value it needs
    moved once. "apply": nF² plane sets, x read, y written; "residual":
    also b read; "sweep": also the nF² Binv planes; "zero" (the sweep from
    x = 0): Binv and b read, x written, no plane. nF = 1 gives ``bound``'s
    stencil_mv and jacobi_smooth."""
    nF, taps = n_fields, (2 * radius + 1) ** len(shape)
    n = 1
    for s_ in shape:
        n *= s_
    words = {"apply": nF * nF * taps + 2 * nF,
             "residual": nF * nF * taps + 3 * nF,
             "sweep": nF * nF * (taps + 1) + 3 * nF,
             "zero": nF * nF + 2 * nF}
    flops = {"apply": 2.0 * nF * nF * taps,
             "residual": 2.0 * nF * nF * taps + nF,
             "sweep": 2.0 * nF * nF * (taps + 1) + 3.0 * nF,
             "zero": 3.0 * nF * nF}
    return _bound_ms(sum(words[p] for p in passes),
                     sum(flops[p] for p in passes), n)


def bound_call(shape, n_fields: int, sweeps: int, from_zero: bool,
               with_residual: bool, radius: int = 2):
    """The bound of one smoothing call as a function of its operands: every
    input read once (the nF² plane sets, the nF² Binv planes, b, and x
    unless from zero) and every output written once (x_ν, and r with the
    residual), whatever passes carry it; the operations are those of its
    passes, which no fusion saves."""
    nF, taps = n_fields, (2 * radius + 1) ** 2
    words = (nF * nF * (taps + 1) + nF + nF * (not from_zero) + nF
             + nF * with_residual)
    sweep, zero = 2.0 * nF * nF * (taps + 1) + 3.0 * nF, 3.0 * nF * nF
    first = zero if from_zero and sweeps > 0 else 0.0
    flops = (first + sweep * (sweeps - bool(first))
             + (2.0 * nF * nF * taps + nF) * with_residual)
    return _bound_ms(words, flops, shape[0] * shape[1])


def passes_of(sweeps: int, from_zero: bool, with_residual: bool):
    """The passes of one smoothing call."""
    return (["zero"] * (from_zero and sweeps > 0)
            + ["sweep"] * (sweeps - bool(from_zero and sweeps > 0))
            + ["residual"] * with_residual)


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
    phase("build", seconds=dt, library=str(path.relative_to(HERE)),
          sources=[str(p.relative_to(HERE)) for p in sk.SOURCES],
          ptxas=ptxas_report(log.read_text() if log.exists() else ""))


def ptxas_report(log: str) -> list:
    """Per kernel of the compiler's ``-Xptxas -v`` report: registers, shared
    memory, stack and spill bytes. The name is the mangled one cut to the
    kernel and its template arguments."""
    rows, row = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d+((?:pass|level|stencil)\w*?)E?v?P",
                             m.group(1))
            row = {"kernel": name.group(1) if name else m.group(1)}
            rows.append(row)
        elif row is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    row[key] = int(m.group(1))
    return rows


def _check(worst, name, y, y_ref, shape, radius, quiet=False, **kv):
    """Hold y against y_ref at TOL·max|y_ref|; fails above it. ``quiet``
    prints nothing (the caller prints a summary line). Returns the error."""
    import torch

    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    lim = TOL * float(y_ref.abs().max())
    if not quiet:
        phase("kernel_check", kernel=name, shape=list(shape), radius=radius,
              max_abs_err=err, bound=lim, **kv)
    if not err <= lim:
        fail(f"{name} {shape} r={radius} {kv}: {err} > {lim}")
    worst[name] = max(worst.get(name, 0.0), err)
    return err


ROUTES = ("per_pass", "grid")                 # sk.PER_PASS, sk.GRID


def level_operands(rng, shape, radius, n_fields, dev):
    """A diagonally dominant nF-field operator (n_fields = 0: scalar
    planes and the flat 1/diag), its smoother blocks, b and x on the
    card."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock2D

    nF, m2 = max(n_fields, 1), (2 * radius + 1) ** 2
    C = torch.tensor(rng.uniform(-0.1, 0.1, (nF, nF, m2, *shape)),
                     dtype=torch.float32, device=dev)
    for f in range(nF):
        C[f, f, m2 // 2] += 4.0
    n = nF * shape[0] * shape[1]
    b, x = (torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev) for _ in range(2))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m2 // 2]).reshape(-1).contiguous(), b, x
    return C, multigrid._point_binv(StencilOperatorBlock2D(C, shape,
                                                           radius)), b, x


TILE = (8, 32)     # output rows x columns per block of csrc/stencil2d.cu


def fitting_routes(C, binv, b, x, shape, radius, nF):
    """The routes of a smoothing call that take this level: one launch per
    pass always, the fused launch where the library's plan (tile count
    against the co-resident blocks) says the level fits. The plan is held
    to the launch: a level that fits must launch (a fused launch that
    raises there fails the run), one that does not fit must be refused."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    routed = sk._smooth_route(tuple(shape), radius, nF, b.device.index or 0)
    tiles = -(-shape[0] // TILE[0]) * -(-shape[1] // TILE[1])
    try:
        sk._smooth_cuda(sk.GRID, C, binv, b, x, 0.8, 1, shape, radius, nF,
                        True)
        launched = True
    except RuntimeError as e:
        launched, why = False, str(e)
    if launched != (routed == sk.GRID):
        fail(f"smooth at {shape} nF={nF}, {tiles} tiles: the plan says "
             f"{ROUTES[routed]}, the fused launch "
             + ("ran" if launched else f"was refused: {why}"))
    return [sk.PER_PASS] + [sk.GRID] * launched


def check_level_entries(worst, rng, shape, radius, n_fields, dev, sweeps,
                        forms):
    """stencil_mv_block (apply, residual: one launch each) and smooth by
    every route against their plain versions at ``shape``; the fused
    route must be one launch a call. Prints one summary line; returns
    whether every fused result equalled the per-pass launches bitwise."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = level_operands(rng, shape, radius, n_fields, dev)
    nF = max(n_fields, 1)
    y_ref = sk.apply_plain(C, x, shape, radius)
    before = sk.launches()
    y = sk.stencil_mv_block(C, x, shape, radius)
    r = sk.stencil_mv_block(C, x, shape, radius, b=b)
    if sk.launches() != {**before, "stencil_mv_block":
                         before["stencil_mv_block"] + 2}:
        fail(f"block apply and residual at {shape} were not one "
             f"stencil_mv_block launch each: {before} -> {sk.launches()}")
    errs = [_check(worst, "stencil_mv_block", y, y_ref, shape, radius,
                   quiet=True, n_fields=n_fields),
            _check(worst, "stencil_mv_block", r, b - y_ref, shape, radius,
                   quiet=True, n_fields=n_fields, what="residual")]
    bitwise, checks = True, 2
    fits = fitting_routes(C, binv, b, x, shape, radius, nF)
    for nu in sweeps:
        for from_zero, with_residual in forms:
            start = None if from_zero else x
            ref = sk.smooth_plain(C, binv, b, start, 0.8, nu, shape, radius,
                                  with_residual)
            outs, ran = [], []
            for route in fits:
                before = sk.smooth.launches
                outs.append(sk._smooth_cuda(route, C, binv, b, start, 0.8,
                                            nu, shape, radius, nF,
                                            with_residual))
                ran.append(ROUTES[route])
                if sk.smooth.launches - before != (route != sk.PER_PASS):
                    fail(f"smooth {ROUTES[route]} at {shape} made "
                         f"{sk.smooth.launches - before} fused launches")
            outs.append(sk.smooth(C, binv, b, start, 0.8, nu, shape, radius,
                                  with_residual))
            for route, out in zip((*ran, "routed"), outs):
                name = "jacobi_smooth" if route == "per_pass" else "smooth"
                for k, (v, v_ref) in enumerate(
                        zip(*((out, ref) if with_residual
                              else ((out,), (ref,))))):
                    errs.append(_check(
                        worst, name, v, v_ref, shape, radius, quiet=True,
                        n_fields=n_fields, sweeps=nu, from_zero=from_zero,
                        route=route, what="residual" if k else "x"))
                    first = outs[0][k] if with_residual else outs[0]
                    bitwise &= bool(torch.equal(v, first))
                    checks += 1
    phase("kernel_check", kernel="stencil_mv_block, smooth",
          shape=list(shape), radius=radius, n_fields=n_fields,
          sweeps=list(sweeps), forms=[list(f) for f in forms],
          routes=[*(ROUTES[d] for d in fits), "routed"], checks=checks,
          max_abs_err=max(errs), fused_bitwise_equal_per_pass=bitwise,
          routed=ROUTES[sk._smooth_route(tuple(shape), radius, nF,
                                         dev.index or 0)])
    return bitwise


def time_level(rng, shape, n_fields, dev, main_block, main_smooth):
    """``kernel_time`` rows of the block entries at one level shape, r=2:
    stencil_mv_block (apply), and each form of the V-cycle's smoothing call
    (NU sweeps; "pre" from zero with the residual, "post" from x) by every
    route that takes the level, the routed one as kernel "smooth_call".
    ``bound_ms`` is the call's (``bound_call``: operands moved once),
    ``per_pass_bound_ms`` the sum of its passes' bounds, which the rows
    of single launches add up to. ``main_*``: also time the plain version
    (the rows of the kernel summary)."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = level_operands(rng, shape, 2, n_fields, dev)
    nF = max(n_fields, 1)
    key = list(shape) if n_fields == 0 else [nF, *shape]
    rows = [time_kernel(
        "stencil_mv_block", key, partial(sk.stencil_mv_block, C, x, shape, 2),
        partial(sk.apply_plain, C, x, shape, 2) if main_block else None,
        bound_=bound_passes(shape, nF, ["apply"]))]
    routed = sk._smooth_route(tuple(shape), 2, nF, dev.index or 0)
    fits = fitting_routes(C, binv, b, x, shape, 2, nF)
    for form, (from_zero, with_residual) in FORMS.items():
        start = None if from_zero else x
        bnd = bound_call(shape, nF, NU, from_zero, with_residual)
        per_pass = bound_passes(shape, nF, passes_of(NU, from_zero,
                                                     with_residual))[0]
        for route in fits:
            fn = partial(sk._smooth_cuda, route, C, binv, b, start, 0.67,
                         NU, shape, 2, nF, with_residual)
            is_main = main_smooth and route == routed and form == "pre"
            rows.append(time_kernel(
                "smooth_call" if route == routed else "smooth_other_route",
                key, fn,
                partial(sk.smooth_plain, C, binv, b, start, 0.67, NU,
                        shape, 2, with_residual) if is_main else None,
                bound_=bnd, per_pass_bound_ms=per_pass, form=form,
                route=ROUTES[route],
                launches_per_call=(
                    1 if route != sk.PER_PASS
                    else NU - (from_zero and NU >= 2) + with_residual)))
    return rows


def phase_kernels():
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    worst = {}

    def operands(shape, radius):
        m = 2 * radius + 1
        n = shape[0] * shape[1]
        C = torch.tensor(rng.standard_normal((m * m, *shape)),
                         dtype=torch.float32, device=dev)
        x = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        return C, x, n

    for shape in [(17, 17), (33, 129), (40, 200)]:
        for radius in (1, 2):
            C, x, _ = operands(shape, radius)
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, shape, radius),
                   sk.stencil_mv_plain(C, x, shape, radius), shape, radius)
    for shape in [(21, 35), (1025, 1025)]:
        C, x, n = operands(shape, 2)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        invd = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
        if shape == (1025, 1025):
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, shape, 2),
                   sk.stencil_mv_plain(C, x, shape, 2), shape, 2)
        _check(worst, "jacobi_smooth",
               sk.jacobi_smooth(C, invd, b, x, 0.67, shape, 2),
               sk.jacobi_smooth_plain(C, invd, b, x, 0.67, shape, 2), shape,
               2)
    # the block entries: 1 to 3 fields (0: scalar planes), r = 1, 2,
    # ν = 1, 2, 3, from x and from zero, with and without the residual, by
    # every route, at odd shapes; then r = 2, ν = NU in the V-cycle's two
    # forms at every level shape
    bitwise = True
    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    for shape in [(17, 17), (33, 129), (40, 200)]:
        for radius in (1, 2):
            for n_fields in (0, 1, 2, 3):
                bitwise &= check_level_entries(
                    worst, rng, shape, radius, n_fields, dev, (1, 2, 3),
                    all_forms)
    level_sets = ((0, LEVELS2), (N_FIELDS_EL, BLOCK_SMOOTHED),
                  (3, BLOCK_SMOOTHED[1:]))
    for n_fields, shapes in level_sets:
        for shape in shapes:
            bitwise &= check_level_entries(
                worst, rng, shape, 2, n_fields, dev, (NU,),
                list(FORMS.values()))
    phase("kernel_check", kernel="smooth",
          fused_bitwise_equal_per_pass=bitwise)

    rows = []
    for shape in LEVELS2:
        C, x, n = operands(shape, 2)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        invd = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
        main = shape == LEVELS2[0]

        def mv(C=C, x=x, shape=shape, f=sk.stencil_mv):
            return f(C, x, shape, 2)

        def jac(C=C, x=x, b=b, invd=invd, shape=shape, f=sk.jacobi_smooth):
            return f(C, invd, b, x, 0.67, shape, 2)

        rows.append(time_kernel(
            "stencil_mv", shape, mv,
            partial(mv, f=sk.stencil_mv_plain) if main else None))
        rows.append(time_kernel(
            "jacobi_smooth", shape, jac,
            partial(jac, f=sk.jacobi_smooth_plain) if main else None))
        del C, x, b, invd
    for shape in BLOCK_EXTRA:
        C, x, _ = operands(shape, 2)
        rows.append(time_kernel(
            "stencil_mv", shape,
            partial(sk.stencil_mv, C, x, shape, 2)))
    # the largest level whose smoothing call is one launch gives the
    # summary's "smooth" row
    fused = [sh for sh in LEVELS2
             if sk._smooth_route(sh, 2, 1, 0) != sk.PER_PASS]
    if not fused:
        fail("no scalar level's smoothing call is routed to one launch")
    for n_fields, shapes in level_sets[:2]:
        for shape in shapes:
            rows += time_level(
                rng, shape, n_fields, dev,
                main_block=(n_fields, shape) == (N_FIELDS_EL,
                                                 BLOCK_SMOOTHED[0]),
                main_smooth=n_fields == 0 and shape == fused[0])
    return worst, rows


N_BG3 = 104                      # 105³ = 1,157,625 background dofs
SHAPE3 = (N_BG3 + 1,) * 3
SOAK_ROUNDS = 400                # x 4 shapes x 3 kernels = 4,800 launches


def phase_kernels3():
    """The 3D kernels against their plain versions, a soak, and times."""
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    worst = {}

    def operands(shape, radius):
        m = 2 * radius + 1
        n = shape[0] * shape[1] * shape[2]

        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=dev)

        return (t(rng.standard_normal((m ** 3, *shape))),
                t(rng.standard_normal(n)), t(rng.standard_normal(n)),
                t(rng.uniform(0.5, 2.0, n)), t(rng.standard_normal(n)))

    def check_cheb(C, x, b, invd, d, shape, radius, alpha, beta):
        d_in = None if beta == 0 else d.clone()
        y, d_out = sk.cheb_step3(C, invd, b, x, d_in, alpha, beta, shape,
                                 radius)
        y_ref, d_ref = sk.cheb_step3_plain(C, invd, b, x,
                                           None if beta == 0 else d,
                                           alpha, beta, shape, radius)
        _check(worst, "cheb_step3", y, y_ref, shape, radius, beta=beta)
        _check(worst, "cheb_step3", d_out, d_ref, shape, radius, beta=beta,
               what="d")

    for shape in [(9, 9, 9), (13, 10, 17), SHAPE3]:
        for radius in (1, 2):
            C, x, *_ = operands(shape, radius)
            _check(worst, "stencil_mv3", sk.stencil_mv3(C, x, shape, radius),
                   sk.stencil_mv3_plain(C, x, shape, radius), shape, radius)
            del C
    for shape in [(11, 9, 14), SHAPE3]:
        for radius in (1, 2):
            if shape == SHAPE3 and radius == 1:
                continue
            C, x, b, invd, d = operands(shape, radius)
            _check(worst, "jacobi_smooth3",
                   sk.jacobi_smooth3(C, invd, b, x, 0.67, shape, radius),
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape,
                                           radius), shape, radius)
            check_cheb(C, x, b, invd, d, shape, radius, 1.7, 0.0)
            check_cheb(C, x, b, invd, d, shape, radius, 1.3, 0.45)
            del C

    # soak: the V-cycle's level shapes, interleaved, never synchronised
    # until the end; every repeat must reproduce its first result bitwise
    levels = [(s,) * 3 for s in (105, 53, 27, 14)]
    ops = [operands(sh, 2) for sh in levels]
    first = []
    for (C, x, b, invd, d), sh in zip(ops, levels):
        y0 = sk.stencil_mv3(C, x, sh, 2)
        j0 = sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 2)
        c0, _ = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh, 2)
        first.append((y0, j0, c0))
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(SOAK_ROUNDS):
        for (C, x, b, invd, d), sh, (y0, j0, c0) in zip(ops, levels, first):
            mismatches += (sk.stencil_mv3(C, x, sh, 2) != y0).sum()
            mismatches += (sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 2)
                           != j0).sum()
            mismatches += (sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh,
                                         2)[0] != c0).sum()
    torch.cuda.synchronize()
    soak_s = time.perf_counter() - t0
    for (C, x, b, invd, d), sh, (y0, j0, c0) in zip(ops, levels, first):
        _check(worst, "stencil_mv3", y0, sk.stencil_mv3_plain(C, x, sh, 2),
               sh, 2, after="soak")
        _check(worst, "jacobi_smooth3", j0,
               sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, sh, 2), sh, 2,
               after="soak")
    phase("soak", launches=SOAK_ROUNDS * len(levels) * 3,
          shapes=[list(sh) for sh in levels], radius=2, seconds=soak_s,
          mismatches=int(mismatches))
    if int(mismatches) != 0:
        fail(f"soak: {int(mismatches)} values differ between repeats")
    del ops, first

    rows = []
    for sh in LEVELS3:
        C, x, b, invd, d = operands(sh, 2)
        main = sh == LEVELS3[0]

        def mv(C=C, x=x, sh=sh, f=sk.stencil_mv3):
            return f(C, x, sh, 2)

        def jac(C=C, x=x, b=b, invd=invd, sh=sh, f=sk.jacobi_smooth3):
            return f(C, invd, b, x, 0.67, sh, 2)

        def cheb(C=C, x=x, b=b, invd=invd, d=d, sh=sh, f=sk.cheb_step3):
            return f(C, invd, b, x, d, 1.3, 0.45, sh, 2)

        for name, fn, plain in (
                ("stencil_mv3", mv, sk.stencil_mv3_plain),
                ("jacobi_smooth3", jac, sk.jacobi_smooth3_plain),
                ("cheb_step3", cheb, sk.cheb_step3_plain)):
            rows.append(time_kernel(name, sh, fn,
                                    partial(fn, f=plain) if main else None))
        del C, x, b, invd, d
    torch.cuda.empty_cache()
    rows += kernels3_block(worst, dev)
    return worst, rows


BLOCK3_MODES = ("apply", "residual", "sweep", "zero")
BLOCK3_SOAK_ROUNDS = 50          # x 4 shapes x 4 modes = 800 launches


def block3_operands(gen, shape, radius, n_fields, dev):
    """A diagonally dominant nF-field 3D operator made on the card
    (n_fields = 0: scalar planes and the flat 1/diag), its smoother
    blocks, b and x."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D

    nF, m3 = max(n_fields, 1), (2 * radius + 1) ** 3
    C = torch.rand((nF, nF, m3, *shape), generator=gen, device=dev,
                   dtype=torch.float32).sub_(0.5).mul_(0.2)
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    n = nF * shape[0] * shape[1] * shape[2]
    b, x = (torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
            for _ in range(2))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m3 // 2]).reshape(-1).contiguous(), b, x
    return C, multigrid._point_binv(StencilOperatorBlock3D(C, shape,
                                                           radius)), b, x


def block3_calls(C, binv, b, x, shape, radius, omega=0.8, plain=False):
    """The four passes of stencil3d_block (or of its plain versions) as
    functions, keyed by mode."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    a = (shape, radius)
    if plain:
        return {
            "apply": partial(sk.apply3_block_plain, C, x, *a),
            "residual": partial(sk.residual3_block_plain, C, b, x, *a),
            "sweep": partial(sk.sweep3_block_plain, C, binv, b, x, omega, *a),
            "zero": partial(sk.sweep3_block_plain, C, binv, b, None, omega,
                            *a)}
    return {
        "apply": partial(sk.stencil3d_block, C, x, *a),
        "residual": partial(sk.stencil3d_block, C, x, *a, b=b),
        "sweep": partial(sk.stencil3d_block, C, x, *a, b=b, binv=binv,
                         omega=omega),
        "zero": partial(sk.stencil3d_block, C, None, *a, b=b, binv=binv,
                        omega=omega)}


def check_block3(worst, gen, shape, radius, n_fields, dev):
    """stencil3d_block's four passes at ``shape`` against the plain
    versions: one launch each; scalar planes also against stencil_mv3 and
    jacobi_smooth3. Prints one summary line."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = block3_operands(gen, shape, radius, n_fields, dev)
    calls = block3_calls(C, binv, b, x, shape, radius)
    before = sk.launches()
    got = {mode: fn() for mode, fn in calls.items()}
    if sk.launches() != {**before, "stencil3d_block":
                         before["stencil3d_block"] + len(calls)}:
        fail(f"stencil3d_block at {shape} was not one launch a pass: "
             f"{before} -> {sk.launches()}")
    refs = block3_calls(C, binv, b, x, shape, radius, plain=True)
    errs = [_check(worst, "stencil3d_block", got[mode], refs[mode](), shape,
                   radius, quiet=True, n_fields=n_fields, what=mode)
            for mode in calls]
    if n_fields == 0:
        errs.append(_check(worst, "stencil3d_block", got["apply"],
                           sk.stencil_mv3(C, x, shape, radius), shape,
                           radius, quiet=True, what="apply vs stencil_mv3"))
        errs.append(_check(worst, "stencil3d_block", got["sweep"],
                           sk.jacobi_smooth3(C, binv, b, x, 0.8, shape,
                                             radius), shape, radius,
                           quiet=True, what="sweep vs jacobi_smooth3"))
    phase("kernel_check", kernel="stencil3d_block", shape=list(shape),
          radius=radius, n_fields=n_fields, checks=len(errs),
          max_abs_err=max(errs))


def kernels3_block(worst, dev):
    """The 3D block entry: checks, a soak, and ``kernel_time`` rows per
    pass (``form``) at every level shape of the 3D block V-cycle for 3 and
    2 fields."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    for shape in [(9, 9, 9), (13, 10, 17), (11, 9, 14)]:
        for radius in (1, 2):
            for n_fields in (0, 1, 2, 3):
                check_block3(worst, gen, shape, radius, n_fields, dev)
    for shape in BLOCK3_SMOOTHED:
        for n_fields in (0, N_FIELDS_EL3):
            check_block3(worst, gen, shape, 2, n_fields, dev)
        torch.cuda.empty_cache()

    # soak: the block V-cycle's level shapes and the four passes,
    # interleaved, never synchronised until the end; every repeat must
    # reproduce its first result bitwise
    ops = [block3_calls(*block3_operands(gen, sh, 2, N_FIELDS_EL3, dev), sh,
                        2) for sh in BLOCK3_SMOOTHED]
    first = [{mode: fn() for mode, fn in calls.items()} for calls in ops]
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(BLOCK3_SOAK_ROUNDS):
        for calls, ref in zip(ops, first):
            for mode, fn in calls.items():
                mismatches += (fn() != ref[mode]).sum()
    torch.cuda.synchronize()
    phase("soak", kernel="stencil3d_block",
          launches=BLOCK3_SOAK_ROUNDS * len(ops) * len(BLOCK3_MODES),
          shapes=[[N_FIELDS_EL3, *sh] for sh in BLOCK3_SMOOTHED], radius=2,
          seconds=time.perf_counter() - t0, mismatches=int(mismatches))
    if int(mismatches) != 0:
        fail(f"stencil3d_block soak: {int(mismatches)} values differ "
             "between repeats")
    del ops, first
    torch.cuda.empty_cache()

    rows = []
    for n_fields in (N_FIELDS_EL3, 2):
        for sh in BLOCK3_SMOOTHED:
            C, binv, b, x = block3_operands(gen, sh, 2, n_fields, dev)
            calls = block3_calls(C, binv, b, x, sh, 2, omega=1.0)
            plain = block3_calls(C, binv, b, x, sh, 2, omega=1.0, plain=True)
            main = (n_fields, sh) == (N_FIELDS_EL3, BLOCK3_SMOOTHED[0])
            for mode in BLOCK3_MODES:
                rows.append(time_kernel(
                    "stencil3d_block", [n_fields, *sh], calls[mode],
                    plain[mode] if main and mode == "apply" else None,
                    bound_=bound_passes(sh, n_fields, [mode]),
                    plain_launches=2, form=mode))
            del C, binv, b, x, calls, plain
            torch.cuda.empty_cache()
    return rows


N_BG = 1024                      # 1,050,625 background dofs (headline size)
MAX_CG_ITERS = 96                # 2x the reference's 48 iterations at n_bg=1024
MAX_CG_ITERS3 = 80               # 2x the reference's 40 iterations at n_bg=104


def fg_of(n_bg: int, dim: int = 2) -> int:
    """Foreground divisions: the fg/bg spacing ratio of the reference
    workloads (bench.py): sqrt(2) in 2D, 1.26 in 3D."""
    return int(n_bg * (1.4142 if dim == 2 else 1.26)) // 2 * 2


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def build_solver(n_bg: int, device, dim: int = 2):
    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

    gen = (generators.immersed_square_problem if dim == 2
           else generators.immersed_cube_problem)
    t0 = time.perf_counter()
    mesh, M = gen(n_fg=fg_of(n_bg, dim), n_bg=n_bg, device=device)
    t1 = time.perf_counter()
    mesh.facet_data
    t2 = time.perf_counter()
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=device)
    t3 = time.perf_counter()
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1,) * dim, device=device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t4 = time.perf_counter()
    return mesh, M, prob, solver, {
        "problem": t1 - t0, "facet_data": t2 - t1, "PoissonProblem": t3 - t2,
        "BinnedLatticeSolver": t4 - t3}


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
    lim = 1e-7 * max(float(u_cpu.abs().max()), 1.0)
    err = float((u_gpu.cpu() - u_cpu)[d].abs().max())
    phase("small_reference", n_bg=24, max_abs_diff=err, bound=lim,
          gpu=info_gpu, cpu=info_cpu)
    if not err <= lim:
        fail(f"card and host solves differ by {err}")
    *_, s_gpu, _ = build_solver(64, gpu)
    smoother_option(s_gpu, "small_reference", 64, smoother="chebyshev")


def smoother_option(solver, tag, n_bg, **option):
    """The solver's refinement loop to a 1e-8 f64 residual on the card with
    the default multigrid and with ``option`` (the other smoother of the
    lattice's multigrid class): both converge, the option within twice the
    default's iterations."""
    from iifea_tpu_torch.ops import multigrid

    cls = (multigrid.StencilMultigrid if solver.dim == 2
           else multigrid.StencilMultigrid3D)
    b64, Kc, Kf = solver.assemble()
    bound_ = solver.bind(Kc, Kf)
    S32 = solver.probe(bound_)
    out = {}
    for name, kw in (("default", {}), ("option", option)):
        _, relres, iters = solver.refine(S32, cls(S32, **kw), bound_, b64,
                                         1e-8)
        out[name] = {"cg_iters": iters, "rel_residual": relres}
    phase(tag, n_bg=n_bg, smoother_option=option, **out)
    if not all(v["rel_residual"] < 1e-8 for v in out.values()):
        fail(f"{tag}: smoother option {option} did not converge: {out}")
    if not out["option"]["cg_iters"] <= 2 * out["default"]["cg_iters"]:
        fail(f"{tag}: smoother option {option} takes more than twice the "
             f"default's iterations: {out}")


MAX_SINGLE_LEVEL_ITERS = 64      # 2x the host's 32 at 3D n_bg=8 (one level)


def phase_small_reference3():
    """3D small problems against host references: at n_bg=16 (17³ → 9³,
    Chebyshev sweeps on the kernels) the card's solution has a
    host-measured exact f64 residual below 1e-10; at n_bg=8 the card's and
    the host's (plain versions) solutions give the same L2/H10 errors to
    1e-8 relative (the JAX package's 3D end-to-end criterion: sliver-cut
    dofs are numerically undetermined, the foreground field is not)."""
    import torch

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    *_, s_gpu, _ = build_solver(16, gpu, dim=3)
    *_, s_cpu, _ = build_solver(16, cpu, dim=3)
    u_gpu, info = s_gpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    _, _, relres = s_cpu.residual(s_cpu.bind(Kc, Kf), b, u_gpu.cpu())
    phase("small_reference3", n_bg=16, host_rel_residual=relres, **info)
    if not relres < 1e-10:
        fail(f"host-measured residual of the card's 3D solution {relres}")

    _, M_g, p_gpu, s_gpu, _ = build_solver(8, gpu, dim=3)
    _, M_c, p_cpu, s_cpu, _ = build_solver(8, cpu, dim=3)
    u_gpu, info_gpu = s_gpu.solve(rtol=1e-10)
    u_cpu, info_cpu = s_cpu.solve(rtol=1e-10)
    n_gpu = p_gpu.error_norms(M_g.mv(u_gpu))
    n_cpu = p_cpu.error_norms(M_c.mv(u_cpu))
    rel = {k: abs(n_gpu[k] - n_cpu[k]) / abs(n_cpu[k]) for k in ("L2", "H10")}
    phase("small_reference3", n_bg=8, norms_gpu=n_gpu, norms_cpu=n_cpu,
          rel_diff=rel, gpu=info_gpu, cpu=info_cpu)
    if not (info_gpu["rel_residual"] < 1e-10 and max(rel.values()) < 1e-8):
        fail(f"3D card and host solves differ: {rel}, {info_gpu}")
    # one 9³ level: the dense coarse inverse is the whole preconditioner
    if not info_gpu["cg_iters"] <= MAX_SINGLE_LEVEL_ITERS:
        fail(f"3D n_bg=8 on the card: {info_gpu['cg_iters']} CG iterations "
             f"> {MAX_SINGLE_LEVEL_ITERS} (host: {info_cpu['cg_iters']})")
    *_, s_gpu, _ = build_solver(16, gpu, dim=3)
    smoother_option(s_gpu, "small_reference3", 16, smoother="jacobi")


def on_cuda(solver, u, S32, mg) -> bool:
    tensors = [u, S32.coeffs, mg.coarse_inv, *mg.inv_diags,
               *(lv.coeffs for lv in mg.levels), solver.M.idxT,
               solver.M.valT]
    if solver.dim == 2:
        tensors += [solver.JinvT_b, solver.wdetT_b,
                    *(t for t in solver.rhs_tables.values() if t is not None)]
    for red in solver.reducers:
        tensors += [red.val_b, red.kappa, red.perm]
    for dom, _ in solver.prob.form.terms:
        tensors += [dom.eldofsT, dom.h]
    return all(t.is_cuda for t in tensors)


def profile_solve(solve, tag: str):
    """Device busy share and the top kernels of one warm ``solve()``, from
    torch.profiler (CUPTI); reports "not measured" if no device time shows.
    Returns the count of kernel launches (None when not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = sync_time(solve)
    # kernel-level events only: op-level events carry the same device time
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in dev)
    if busy_us <= 0:
        phase(tag, device_time="not measured", wall_seconds=wall)
        return None
    dev.sort(key=lambda e: -e[1])
    phase(tag, wall_seconds=wall, device_busy_seconds=busy_us / 1e6,
          device_idle_share=1.0 - busy_us / 1e6 / wall,
          kernel_launches=sum(c for *_, c in dev),
          top=[{"name": k[:80], "seconds": t / 1e6, "count": c}
               for k, t, c in dev[:10]])
    return sum(c for *_, c in dev)


def stage_times(solver, tag: str):
    """Per-stage times of a warm solve (PERF.md's phases), synced per
    stage, and each stage's peak device memory."""
    import torch

    t_cg, t_res = [0.0], [0.0]
    cg0, res0 = solver.cg, solver.residual
    peak = {}

    def timed(fn, acc):
        def wrapped(*a):
            out, dt = sync_time(lambda: fn(*a))
            acc[0] += dt
            return out
        return wrapped

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        out, dt = sync_time(fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        return out, dt

    solver.cg, solver.residual = timed(cg0, t_cg), timed(res0, t_res)
    try:
        (b64, Kc, Kf), t_asm = stage("assemble", solver.assemble)
        bound_, t_bind = stage("bind", lambda: solver.bind(Kc, Kf))
        S32, t_probe = stage("probe", lambda: solver.probe(bound_))
        mg, t_mg = stage("build_mg", lambda: solver.build_mg(S32))
        (x, relres, iters), t_ref = stage(
            "refine", lambda: solver.refine(S32, mg, bound_, b64, 1e-10))
    finally:
        # drop the instance attributes: a bound method stored on its own
        # instance is a reference cycle that would keep the solver (and
        # its tables) alive after the caller's del
        del solver.cg, solver.residual
    phase(tag, element_jacobians_rhs=t_asm, bind=t_bind,
          stencil_extraction=t_probe, multigrid_hierarchy=t_mg,
          refine=t_ref, refine_cg=t_cg[0], refine_residual=t_res[0],
          cg_iters=iters, rel_residual=relres, peak_gib=peak,
          levels=[list(lv.shape) for lv in mg.levels])
    return S32, mg


@contextlib.contextmanager
def count_by_shape(by_shape: Counter):
    """Count the stencil kernels' launches per lattice shape while the
    block runs. Every launch goes through a
    StencilOperator2D/3D/Block2D/Block3D method (``mv``, ``smooth``, ``jacobi_smooth``, ``cheb_sweep``); each is called through a shim that reads the wrappers'
    own counters before and after the call and books the difference under
    the operator's shape (a block operator's led by its field count). A
    ``smooth`` call is also booked itself, by its form, as
    ``smooth_call@shape:pre`` (from zero, with the residual), ``:post``
    (from x, without) or ``:other``. The 3D block operator's launches are
    booked by pass: ``stencil3d_block@shape:apply`` / ``:zero`` /
    ``:sweep`` / ``:residual``."""
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.ops.stencil import (
        StencilOperator2D,
        StencilOperator3D,
        StencilOperatorBlock2D,
        StencilOperatorBlock3D,
    )

    def block3_passes(name, a, out):
        """stencil3d_block launches of one method call, by pass."""
        if name == "mv":
            return {"apply": 1}
        x, sweeps = a[2], a[4]
        zero = int(x is None and sweeps > 0)
        return {"zero": zero, "sweep": sweeps - zero,
                "residual": int(isinstance(out, tuple))}

    def shim(name, method):
        def counted(self, *a, **kw):
            before = sk.launches()
            out = method(self, *a, **kw)
            shape = "x".join(map(str, (
                *([self.n_fields] if hasattr(self, "n_fields") else []),
                *self.shape)))
            for k, n in sk.launches().items():
                if n == before[k]:
                    continue
                if k != "stencil3d_block":
                    by_shape[f"{k}@{shape}"] += n - before[k]
                    continue
                passes = block3_passes(name, a, out)
                if sum(passes.values()) != n - before[k]:
                    fail(f"{name} at {shape} made {n - before[k]} "
                         f"stencil3d_block launches, not {passes}")
                for form, m in passes.items():
                    by_shape[f"{k}@{shape}:{form}"] += m
            if name == "smooth":
                form = (a[2] is None, isinstance(out, tuple))
                by_shape[f"smooth_call@{shape}:" + next(
                    (k for k, v in FORMS.items() if v == form), "other")] += 1
            return out
        return counted

    saved = [(cls, name, cls.__dict__[name])
             for cls in (StencilOperator2D, StencilOperator3D,
                         StencilOperatorBlock2D, StencilOperatorBlock3D)
             for name in ("mv", "smooth", "jacobi_smooth", "cheb_sweep")
             if name in cls.__dict__]
    for cls, name, method in saved:
        setattr(cls, name, shim(name, method))
    try:
        yield
    finally:
        for cls, name, method in saved:
            setattr(cls, name, method)


def counted_run(fn, names, tag):
    """fn() with every launch counter set to 0 just before and read just
    after; fails unless each kernel in ``names`` launched, and unless the
    per-shape counts add up to the wrappers' own counters. Returns
    (fn's result, seconds, launches by kernel, launches by kernel@shape)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    by_shape = Counter()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    with count_by_shape(by_shape):
        out, seconds = sync_time(fn)
    counts = sk.launches()
    launches = {k: counts[k] for k in names}
    for k, n in counts.items():
        if sum(v for key, v in by_shape.items()
               if key.split("@")[0] == k) != n:
            fail(f"{tag}: per-shape launch counts of {k} do not add up "
                 f"to its counter {n}: {dict(by_shape)}")
    if min(launches.values()) <= 0:
        fail(f"{tag}: a kernel was not launched on the path: {launches}")
    return out, seconds, launches, dict(by_shape)


def drive(solver, names, max_iters: int, tag: str):
    """The main path once through the user entry point, counted."""
    import torch

    (u, info), t_first, launches, by_shape = counted_run(
        lambda: solver.solve(rtol=1e-10), names, tag)
    phase(tag, first_seconds=t_first, launches=launches,
          launches_by_shape=by_shape,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30, **info)
    if not info["rel_residual"] < 1e-10:
        fail(f"{tag}: relative f64 residual {info['rel_residual']} >= 1e-10")
    if not info["cg_iters"] <= max_iters:
        fail(f"{tag}: {info['cg_iters']} CG iterations > {max_iters}")
    if not (u.shape == (solver.M.n_bg_dofs,) and bool(torch.isfinite(u).all())):
        fail(f"{tag}: solution is not a finite vector of the background size")
    return u, launches, by_shape


def front_end(prob, M, u_ref, shape, methods, names, max_iters, tag):
    """The solver front-end on the main path's problem, as a user of the
    library drives it: ``assemble_background_system`` (generic jacfwd
    blocks), then ``solve_ksp(pc='mg')`` once per method, each counted.

    Each solve must reach an f64 relative residual below 1e-10, measured
    here through the general ``BackgroundOperator.mv``, within
    ``max_iters``, with every solver tensor on the card, and agree with the
    BinnedLatticeSolver's solution ``u_ref``:

    * max |x − u_ref| ≤ 1e-6·max|u_ref| over the supported dofs, those
      whose diagonal is at least 1e-3 of the largest. Dofs below that are
      cut to slivers: at a 1e-10 residual their values are not determined
      (at n_bg=1024 they reach 3e7 in u_ref while the solution is O(1)),
      and two Krylov methods legitimately leave different values there;
    * the L2/H10 errors of M x within 1e-6 relative, or within 1e-9 of
      u_exact's norm (ten times the solves' 1e-10 residual: the 2D L2
      error is 4.4e-6, so 1e-6 of it is below what the tolerance fixes).

    The phase line also carries the difference on every dof with a nonzero
    diagonal, per support threshold, and the L2 norm of the foreground
    field difference M(x − u_ref) relative to M u_ref."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import ksp

    device_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                     device=u_ref.device)
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    reducers, t_tab = sync_time(lambda: ksp.lattice_tables(prob.form, M,
                                                           shape))
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    d = A.diag().abs()
    supported = d >= 1e-3 * d.max()
    lim = 1e-6 * float(u_ref[supported].abs().max())
    norms_ref = prob.error_norms(M.mv(u_ref))
    u_ref_l2 = l2_norm(M.mv(u_ref), prob.cell_dom)
    tensors = [b, *A.blocks, M.idxT, M.valT]
    for red in reducers:
        tensors += [red.val_b, red.kappa, red.perm]
    for method in methods:
        (x, info), t_solve, launches, by_shape = counted_run(
            lambda: ksp.solve_ksp(A, b, method=method, pc="mg", rtol=1e-10,
                                  lattice_shape=shape, monitor=False),
            names, f"{tag} {method}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        relres = float(torch.linalg.vector_norm(b - A.mv(x))
                       / torch.linalg.vector_norm(b))
        e = (x - u_ref).abs()
        diff = float(e[supported].max())
        by_support = {f"{t:g}": float(e[d > t * d.max()].max())
                      for t in (0.0, 1e-12, 1e-6, 1e-3, 5e-2)}
        field = l2_norm(M.mv(x - u_ref), prob.cell_dom) / u_ref_l2
        norms = prob.error_norms(M.mv(x))
        gap = {k: abs(norms[k] - norms_ref[k]) for k in ("L2", "H10")}
        phase(tag, method=method, pc="mg", rel_residual=relres,
              iters=info.iters, history=info.history,
              assemble_seconds=t_asm, tables_seconds=t_tab,
              solve_seconds=t_solve, device_gib_before=device_gib,
              setup_peak_gib=setup_peak, peak_gib=peak, launches=launches,
              launches_by_shape=by_shape, max_abs_diff=diff, bound=lim,
              diff_by_support=by_support, max_abs_u_ref=float(
                  u_ref.abs().max()), field_rel_diff=field,
              error_norms=norms, error_norms_binned=norms_ref,
              norms_rel_diff={k: gap[k] / norms_ref[k] for k in gap})
        if not relres < 1e-10:
            fail(f"{tag} {method}: f64 relative residual {relres} >= 1e-10")
        if not info.iters <= max_iters:
            fail(f"{tag} {method}: {info.iters} iterations > {max_iters}")
        if not all(t.is_cuda for t in [x, *tensors]):
            fail(f"{tag} {method}: a solver tensor is not on the card")
        if not diff <= lim:
            fail(f"{tag} {method}: differs from BinnedLatticeSolver by "
                 f"{diff} > {lim} on supported dofs")
        if not all(gap[k] <= 1e-6 * norms_ref[k] + 1e-9 for k in gap):
            fail(f"{tag} {method}: error norms {norms} differ from "
                 f"BinnedLatticeSolver's {norms_ref}")
    general_probe(prob, M, A, b, norms_ref, shape, names, max_iters, tag)


BFR_TOL = 1e-9      # the parity tests' trim: zero and near-zero diagonals


def general_probe(prob, M, A, b, norms_ref, shape, names, max_iters, tag):
    """``solve_ksp(cg, pc='mg', bfr_tol=BFR_TOL)`` on the same system,
    counted: the BFR trim mask turns the binned/window assembly off, so the
    stencil planes come from the coloured general probe of ``A.mv_multi``
    (f64, in column chunks under ``ksp.PROBE_BUDGET_BYTES``) and the same
    kernels run the V-cycle. Gates: the probe ran, the trimmed system's
    f64 relative residual below 1e-10 within ``max_iters``, the solution
    on the card, and the error norms within 1e-6 relative (or 1e-9) of the
    binned solution's (the trimmed dofs carry no physical support)."""
    import torch

    from iifea_tpu_torch.solvers import ksp
    from iifea_tpu_torch.solvers.trim import apply_trim_rhs, trim_mask_from_diag

    mask = trim_mask_from_diag(A.diag(), BFR_TOL)
    At, bt = A.with_trim(mask), apply_trim_rhs(b, mask)
    stages = Counter()
    with timed_calls([(ksp, "_probe_general")], stages):
        (x, info), t_solve, launches, by_shape = counted_run(
            lambda: ksp.solve_ksp(A, b, method="cg", pc="mg", rtol=1e-10,
                                  bfr_tol=BFR_TOL, lattice_shape=shape,
                                  monitor=False),
            names, f"{tag} general probe")
    peak = torch.cuda.max_memory_allocated() / 2**30
    relres = rel_residual(At, bt, x)
    norms = prob.error_norms(M.mv(x))
    gap = {k: abs(norms[k] - norms_ref[k]) for k in ("L2", "H10")}
    phase(f"{tag}_general_probe", bfr_tol=BFR_TOL, trimmed=int(mask.sum()),
          columns=(2 * 2 + 1) ** len(shape),
          chunk=ksp._probe_chunk(A, torch.float64),
          probe_seconds=stages["_probe_general"], solve_seconds=t_solve,
          iters=info.iters, rel_residual=relres, peak_gib=peak,
          launches=launches, launches_by_shape=by_shape, error_norms=norms,
          norms_rel_diff={k: gap[k] / norms_ref[k] for k in gap})
    if not stages["_probe_general"] > 0:
        fail(f"{tag} general probe: the trimmed solve did not probe A")
    if not relres < 1e-10:
        fail(f"{tag} general probe: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= max_iters:
        fail(f"{tag} general probe: {info.iters} iterations > {max_iters}")
    if not x.is_cuda:
        fail(f"{tag} general probe: the solution is not on the card")
    if not all(gap[k] <= 1e-6 * norms_ref[k] + 1e-9 for k in gap):
        fail(f"{tag} general probe: error norms {norms} differ from "
             f"BinnedLatticeSolver's {norms_ref}")


def phase_main_path():
    """Returns the kernel launch counts of one solve() at n_bg = N_BG."""
    import torch

    dev = torch.device("cuda", 0)
    mesh, M, prob, solver, setup = build_solver(N_BG, dev)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is enabled for f32 convolutions or matmuls")
    phase("setup", n_bg=N_BG, n_fg=fg_of(N_BG), n_bg_dofs=M.n_bg_dofs,
          n_cells=mesh.n_cells, n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem,
          tables=[list(r.meta) for r in solver.reducers], seconds=setup)

    names = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    u, launches, by_shape = drive(solver, names, MAX_CG_ITERS, "solve")
    S32, mg = stage_times(solver, "stages")
    if not on_cuda(solver, u, S32, mg):
        fail("a solver tensor is not on the card")

    profile_solve(lambda: solver.solve(rtol=1e-10), "profile")
    totals = []
    for _ in range(3):
        _, dt = sync_time(lambda: solver.solve(rtol=1e-10))
        totals.append(dt)
    norms = prob.error_norms(M.mv(u))
    phase("end_to_end", warm_seconds=totals, best=min(totals),
          error_norms=norms)
    if not all(v == v and 0 < v < 1e-2 for v in norms.values()):
        fail(f"error norms out of range: {norms}")
    del solver, S32, mg
    torch.cuda.empty_cache()
    front_end(prob, M, u, (N_BG + 1,) * 2, ("cg", "gmres"), names,
              MAX_CG_ITERS, "front_end")
    return launches, by_shape


def phase_main_path3():
    """The 3D main path at n_bg = N_BG3; returns its kernel launch
    counts."""
    import torch

    dev = torch.device("cuda", 0)
    mesh, M, prob, solver, setup = build_solver(N_BG3, dev, dim=3)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is enabled for f32 convolutions or matmuls")
    phase("setup3", n_bg=N_BG3, n_fg=fg_of(N_BG3, 3), n_bg_dofs=M.n_bg_dofs,
          n_cells=mesh.n_cells, n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem,
          tables=[list(r.meta) for r in solver.reducers],
          table_bytes=[r.nbytes() for r in solver.reducers],
          device_gib=torch.cuda.memory_allocated() / 2**30, seconds=setup)

    names = ("stencil_mv3", "jacobi_smooth3", "cheb_step3")
    u, launches, by_shape = drive(solver, names, MAX_CG_ITERS3, "solve3")
    S32, mg = stage_times(solver, "stages3")
    if not on_cuda(solver, u, S32, mg):
        fail("a 3D solver tensor is not on the card")
    profile_solve(lambda: solver.solve(rtol=1e-10), "profile3")
    totals = []
    for _ in range(2):
        _, dt = sync_time(lambda: solver.solve(rtol=1e-10))
        totals.append(dt)
    norms = prob.error_norms(M.mv(u))
    del solver, S32, mg
    torch.cuda.empty_cache()
    front_end(prob, M, u, SHAPE3, ("cg",), names, MAX_CG_ITERS3,
              "front_end3")
    del u, prob, M, mesh
    torch.cuda.empty_cache()

    _, M52, p52, s52, _ = build_solver(52, dev, dim=3)
    u52, info52 = s52.solve(rtol=1e-10)
    norms52 = p52.error_norms(M52.mv(u52))
    phase("end_to_end3", warm_seconds=totals, best=min(totals),
          error_norms=norms, error_norms_n_bg52=norms52, n_bg52=info52)
    if not all(v == v and 0 < v < norms52[k] for k, v in norms.items()):
        fail(f"3D error norms {norms} not below n_bg=52's {norms52}")
    return launches, by_shape


def phase_demo():
    """The Poisson demo as a user runs it, on the card (``python3 -m
    iifea_tpu_torch.demos.poisson --ref 4 --solv gmres --pc jacobi``: the
    general gather-bound A.mv and the exact A.diag, no stencil kernel),
    held against the same demo run in this process on the host: the card's
    GMRES must reach the host run's tolerance, and the L2/H10/H1 errors
    agree to 1e-6 relative."""
    import io

    from iifea_tpu_torch.demos import poisson as demo

    argv = ["--ref", "4", "--solv", "gmres", "--pc", "jacobi"]
    wall = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "iifea_tpu_torch.demos.poisson", *argv],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - wall
    if res.returncode != 0:
        fail(f"demo exited {res.returncode}: {res.stderr[-2000:]}")
    out = res.stdout
    conv = re.search(r"Converged in (\d+) iterations\. \(residual norm "
                     r"(\S+)\)", out)
    norms = {}
    for k in ("L2", "H10", "H1"):
        m = re.search(rf"^{k} norm: (\S+)$", out, re.M)
        norms[k] = float(m.group(1)) if m else float("nan")
    with contextlib.redirect_stdout(io.StringIO()):
        host = demo.main(argv + ["--device", "cpu"])
    tol = max(1e-8 * host["info"].history[0], 1e-9)
    rel = {k: abs(norms[k] - host["norms"][k]) / host["norms"][k]
           for k in norms}
    iters, resnorm = ((int(conv.group(1)), float(conv.group(2))) if conv
                      else (None, float("nan")))
    phase("demo", argv=argv, seconds=wall, iters=iters, resnorm=resnorm,
          tol=tol, error_norms=norms, host_iters=host["info"].iters,
          host_error_norms=host["norms"], norms_rel_diff=rel)
    if not resnorm <= tol:
        fail(f"demo: GMRES residual {resnorm} above {tol}")
    if not max(rel.values()) <= 1e-6:
        fail(f"demo: card norms {norms} differ from the host's "
             f"{host['norms']}")


N_BG_EL = 512                    # bench.py --workload elasticity's default
MAX_CG_ITERS_EL = 136            # 2x the reference's 68 iterations at 512


def build_elasticity(n_bg: int, device, dim: int = 2):
    """bench.py's elasticity workload at ``n_bg``: the immersed square with
    n_fg = 2·n_bg and two fields, or (dim = 3) the immersed cube with the 3D
    workloads' fg/bg ratio 1.26 and three fields;
    ImmersedElasticityProblem(k=1, sym=True), assembled by the generic
    front-end at u = 0. Returns (prob, M, A, b, seconds per stage)."""
    import torch

    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    t0 = time.perf_counter()
    if dim == 2:
        mesh, M = generators.immersed_square_problem(
            n_fg=2 * n_bg, n_bg=n_bg, n_fields=2, device=device)
    else:
        mesh, M = generators.immersed_cube_problem(
            n_fg=fg_of(n_bg, 3), n_bg=n_bg, n_fields=3, device=device)
    mesh.facet_data
    t1 = time.perf_counter()
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True, device=device)
    t2 = time.perf_counter()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    return prob, M, A, b, {"problem": t1 - t0, "ImmersedElasticityProblem":
                           t2 - t1, "assemble": t_asm}


def el_solve(A, b, n_bg, dim: int = 2, **kw):
    from iifea_tpu_torch.solvers import ksp

    kw = {"method": "cg", "pc": "mg", "rtol": 1e-10, **kw}
    if kw["pc"] == "mg":
        kw["lattice_shape"] = (n_bg + 1,) * dim
    return ksp.solve_ksp(A, b, n_fields=dim, monitor=False, **kw)


def rel_residual(A, b, x) -> float:
    import torch

    return float(torch.linalg.vector_norm(b - A.mv(x))
                 / torch.linalg.vector_norm(b))


@contextlib.contextmanager
def timed_calls(targets, acc: Counter):
    """Replace each (module, name) by a wrapper that adds its synced
    seconds to acc[name] while the block runs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(fn, name):
        def timed(*a, **kw):
            out, dt = sync_time(lambda: fn(*a, **kw))
            acc[name] += dt
            return out
        return timed

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_on_card(counts: Counter):
    """Count the plain stencil applies (``stencil_mv_plain`` and
    ``stencil_mv3_plain``, through which every plain 2D and 3D apply goes)
    on card tensors while the block runs, split into those inside the
    coarsest block level's dense inverse (set-up: the identity's columns
    through ``mv_ref``, as the reference does) and all others."""
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk

    plains = {"stencil_mv_plain": sk.stencil_mv_plain,
              "stencil_mv3_plain": sk.stencil_mv3_plain}
    dense = multigrid._dense_inverse_block
    where = ["elsewhere"]

    def counting(plain):
        def counted_plain(C, x, *a, **kw):
            if x.is_cuda:
                counts[where[0]] += 1
            return plain(C, x, *a, **kw)
        return counted_plain

    def counted_dense(S):
        where[0] = "dense_inverse"
        try:
            return dense(S)
        finally:
            where[0] = "elsewhere"

    for name, plain in plains.items():
        setattr(sk, name, counting(plain))
    multigrid._dense_inverse_block = counted_dense
    try:
        yield
    finally:
        for name, plain in plains.items():
            setattr(sk, name, plain)
        multigrid._dense_inverse_block = dense


def phase_elasticity():
    """The block path: small references against host SuperLU, then the
    n_bg = N_BG_EL solve counted, staged, profiled, and its error norms
    against an n_bg=256 solve's. Returns its launch counts."""
    import math

    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.solvers import ksp

    dev = torch.device("cuda", 0)

    # -- n_bg=64 against host LU (the JAX spec test_models.py:168-190) ------
    prob, M, A, b, _ = build_elasticity(64, dev)
    u_lu, _ = el_solve(A, b, 64, method="direct")
    n_lu = prob.error_norms(M.mv(u_lu))
    for pc, rtol in (("mg", 1e-11), ("bjacobi", 1e-12)):
        (u, info), dt = sync_time(lambda: el_solve(A, b, 64, pc=pc,
                                                   rtol=rtol))
        norms = prob.error_norms(M.mv(u))
        rel = {k: abs(norms[k] - n_lu[k]) / n_lu[k] for k in n_lu}
        phase("elasticity_small", n_bg=64, pc=pc, rtol=rtol,
              iters=info.iters, rel_residual=rel_residual(A, b, u),
              seconds=dt, error_norms=norms, error_norms_lu=n_lu,
              norms_rel_diff=rel)
        if not (u.is_cuda and max(rel.values()) <= 1e-8):
            fail(f"elasticity n_bg=64 pc={pc}: norms {norms} differ from "
                 f"host LU's {n_lu} by {rel}")
    del prob, M, A, b, u_lu, u

    # -- the main path at n_bg = N_BG_EL --------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, A, b, setup = build_elasticity(N_BG_EL, dev)
    phase("elasticity_setup", n_bg=N_BG_EL, n_fg=2 * N_BG_EL,
          n_bg_dofs=M.n_bg_dofs, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem, seconds=setup,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    names = ("stencil_mv_block", "jacobi_smooth", "smooth")
    plain = Counter()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: el_solve(A, b, N_BG_EL), names, "elasticity")
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    phase("elasticity", first_seconds=t_first, iters=info.iters,
          passes=len(info.history) - 1, history=info.history,
          rel_residual=relres, error_norms=norms, launches=launches,
          launches_by_shape=by_shape, plain_applies_on_card=dict(plain),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not relres < 1e-10:
        fail(f"elasticity: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_CG_ITERS_EL:
        fail(f"elasticity: {info.iters} CG iterations > {MAX_CG_ITERS_EL}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("elasticity: the solution is not a finite card vector of the "
             "background size")
    missing = [s_ for s_ in BLOCK_SMOOTHED if not any(
        by_shape.get(f"{k}@{N_FIELDS_EL}x{s_[0]}x{s_[1]}", 0) > 0
        for k in names)]
    if missing:
        fail(f"elasticity: no stencil launch at the smoothed shapes "
             f"{missing}: {by_shape}")
    if not sum(launches.values()) <= MAX_STENCIL_LAUNCHES_EL:
        fail(f"elasticity: {sum(launches.values())} stencil launches per "
             f"solve > {MAX_STENCIL_LAUNCHES_EL}: {launches}")
    if plain["elsewhere"]:
        fail(f"elasticity: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")

    # stages of a warm solve: probe, hierarchy, deflation, Krylov + refine
    stages = Counter()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls([(ksp, "_probe_block"),
                      (multigrid, "StencilMultigridBlock"),
                      (ksp, "_deflation_space")], stages):
        (u2, info2), t_warm = sync_time(lambda: el_solve(A, b, N_BG_EL))
    peak = torch.cuda.max_memory_allocated() / 2**30
    hier = stages["StencilMultigridBlock"]
    phase("elasticity_stages", assemble=setup["assemble"],
          probe=stages["_probe_block"], hierarchy=hier,
          deflation=stages["_deflation_space"],
          solve=t_warm - sum(stages.values()), solve_ksp=t_warm,
          iters=info2.iters, rel_residual=rel_residual(A, b, u2),
          peak_gib=peak)
    n_all = profile_solve(lambda: el_solve(A, b, N_BG_EL),
                          "elasticity_profile")
    if n_all is not None and not n_all <= MAX_LAUNCHES_EL:
        fail(f"elasticity: {n_all} kernel launches in the profiled solve > "
             f"{MAX_LAUNCHES_EL}")
    del u2
    del A, b
    torch.cuda.empty_cache()

    # -- convergence: below the n_bg=256 solve's errors, L2 rate > 1.5 ------
    p256, M256, A256, b256, _ = build_elasticity(N_BG_EL // 2, dev)
    u256, info256 = el_solve(A256, b256, N_BG_EL // 2)
    n256 = p256.error_norms(M256.mv(u256))
    rate = math.log2(n256["L2"] / norms["L2"])
    phase("elasticity_convergence", error_norms=norms,
          error_norms_n_bg256=n256, l2_rate=rate, iters_n_bg256=info256.iters,
          rel_residual_n_bg256=rel_residual(A256, b256, u256))
    if not all(v == v and 0 < v < n256[k] for k, v in norms.items()):
        fail(f"elasticity: error norms {norms} not below n_bg=256's {n256}")
    if not rate > 1.5:
        fail(f"elasticity: L2 rate {rate} <= 1.5")
    return launches, by_shape


def phase_demo_elasticity():
    """The elasticity demo as a user runs it, on the card (block-MG CG on
    the block stencil kernels), held against the same demo run in this process
    on the host: L2/H10 errors equal to 1e-8 relative."""
    import io

    from iifea_tpu_torch.demos import linear_elasticity as demo

    argv = ["--mesh-root", "synthetic", "--k", "1", "--ref", "3"]
    wall = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "iifea_tpu_torch.demos.linear_elasticity",
         *argv], cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - wall
    if res.returncode != 0:
        fail(f"elasticity demo exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    out = res.stdout
    conv = re.search(r"Converged in (\d+) iterations", out)
    norms = {}
    for k in ("L2", "H10"):
        m = re.search(rf"^relative {k} norm: (\S+)$", out, re.M)
        norms[k] = float(m.group(1)) if m else float("nan")
    with contextlib.redirect_stdout(io.StringIO()):
        host = demo.main(argv + ["--device", "cpu"])
    rel = {k: abs(norms[k] - host["norms"][k]) / host["norms"][k]
           for k in norms}
    phase("demo_elasticity", argv=argv, seconds=wall,
          iters=int(conv.group(1)) if conv else None, error_norms=norms,
          host_iters=host["info"].iters, host_error_norms=host["norms"],
          norms_rel_diff=rel)
    if not (conv and max(rel.values()) <= 1e-8):
        fail(f"elasticity demo: card norms {norms} differ from the host's "
             f"{host['norms']}")


def phase_elasticity3():
    """The 3D block path: small references against host SuperLU, then the
    n_bg = N_BG_EL3 solve counted per lattice shape and pass, staged,
    profiled, and its error norms against an n_bg=48 solve's. Returns its
    launch counts."""
    import math

    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.solvers import ksp

    dev = torch.device("cuda", 0)
    nF = N_FIELDS_EL3

    # -- n_bg = 8 (one dense 9³ level) and 16 against host LU ------------------
    for n_bg in (8, 16):
        prob, M, A, b, _ = build_elasticity(n_bg, dev, dim=3)
        u_lu, _ = el_solve(A, b, n_bg, dim=3, method="direct")
        n_lu = prob.error_norms(M.mv(u_lu))
        (u, info), dt = sync_time(lambda: el_solve(A, b, n_bg, dim=3))
        norms = prob.error_norms(M.mv(u))
        rel = {k: abs(norms[k] - n_lu[k]) / n_lu[k] for k in n_lu}
        phase("elasticity3_small", n_bg=n_bg, iters=info.iters,
              rel_residual=rel_residual(A, b, u), seconds=dt,
              error_norms=norms, error_norms_lu=n_lu, norms_rel_diff=rel)
        most = MAX_CG_ITERS_EL3_SINGLE if n_bg == 8 else MAX_CG_ITERS_EL3
        if not (u.is_cuda and info.iters < most
                and max(rel.values()) <= 1e-8):
            fail(f"3D elasticity n_bg={n_bg}: {info.iters} iterations, norms "
                 f"{norms} differ from host LU's {n_lu} by {rel}")
        del prob, M, A, b, u_lu, u

    # -- the main path at n_bg = N_BG_EL3 --------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, A, b, setup = build_elasticity(N_BG_EL3, dev, dim=3)
    phase("elasticity3_setup", n_bg=N_BG_EL3, n_fg=fg_of(N_BG_EL3, 3),
          n_bg_dofs=M.n_bg_dofs, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem, seconds=setup,
          probe_columns=nF * 125, probe_chunk=ksp._probe_chunk(
              A, torch.float64),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    names = ("stencil3d_block",)
    plain = Counter()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: el_solve(A, b, N_BG_EL3, dim=3), names, "elasticity3")
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    passes = len(info.history) - 1
    phase("elasticity3", first_seconds=t_first, iters=info.iters,
          passes=passes, history=info.history, rel_residual=relres,
          error_norms=norms, launches=launches, launches_by_shape=by_shape,
          plain_applies_on_card=dict(plain),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not relres < 1e-10:
        fail(f"elasticity3: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_CG_ITERS_EL3:
        fail(f"elasticity3: {info.iters} CG iterations > {MAX_CG_ITERS_EL3}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("elasticity3: the solution is not a finite card vector of the "
             "background size")
    # what the V-cycle's structure predicts: one V-cycle per CG iteration
    # and one per pass (the initial z = M r); per V-cycle and smoothed level
    # the sweep from zero, 2·NU − 1 sweeps and one residual; one apply per
    # Krylov matvec (iterations + one initial residual per pass) and one per
    # field in the deflation-space test, at the finest shape only
    cycles = info.iters + passes
    want = {}
    for sh in BLOCK3_SMOOTHED:
        key = "stencil3d_block@" + "x".join(map(str, (nF, *sh)))
        want.update({f"{key}:zero": cycles, f"{key}:residual": cycles,
                     f"{key}:sweep": (2 * NU - 1) * cycles})
    want["stencil3d_block@" + "x".join(map(str, (nF, *BLOCK3_SMOOTHED[0])))
         + ":apply"] = cycles + nF
    got = {k: v for k, v in by_shape.items()
           if k.startswith("stencil3d_block@")}
    if got != want:
        fail(f"elasticity3: stencil3d_block launches {got} are not what "
             f"{cycles} V-cycles predict: {want}")
    if plain["elsewhere"]:
        fail(f"elasticity3: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")

    stages = Counter()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls([(ksp, "_probe_block"),
                      (multigrid, "StencilMultigridBlock3D"),
                      (ksp, "_deflation_space")], stages):
        (u2, info2), t_warm = sync_time(
            lambda: el_solve(A, b, N_BG_EL3, dim=3))
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("elasticity3_stages", assemble=setup["assemble"],
          probe=stages["_probe_block"],
          hierarchy=stages["StencilMultigridBlock3D"],
          deflation=stages["_deflation_space"],
          solve=t_warm - sum(stages.values()), solve_ksp=t_warm,
          iters=info2.iters, rel_residual=rel_residual(A, b, u2),
          peak_gib=peak)
    if not peak < 80 * 1e9 / 2**30:
        fail(f"elasticity3: peak device memory {peak} GiB")
    del u2
    profile_solve(lambda: el_solve(A, b, N_BG_EL3, dim=3),
                  "elasticity3_profile")
    del A, b
    torch.cuda.empty_cache()

    # -- convergence: below the n_bg=48 solve's errors, L2 rate > 1.5 --------
    p48, M48, A48, b48, _ = build_elasticity(N_BG_EL3 // 2, dev, dim=3)
    u48, info48 = el_solve(A48, b48, N_BG_EL3 // 2, dim=3)
    n48 = p48.error_norms(M48.mv(u48))
    rate = math.log2(n48["L2"] / norms["L2"])
    phase("elasticity3_convergence", error_norms=norms,
          error_norms_n_bg48=n48, l2_rate=rate, iters_n_bg48=info48.iters,
          rel_residual_n_bg48=rel_residual(A48, b48, u48))
    if not all(v == v and 0 < v < n48[k] for k, v in norms.items()):
        fail(f"elasticity3: error norms {norms} not below n_bg=48's {n48}")
    if not rate > 1.5:
        fail(f"elasticity3: L2 rate {rate} <= 1.5")
    return launches, by_shape


N_BG_NEWTON = 1024


def scalar_form(mesh, device, kind: str):
    """A nonlinear scalar form on the cut square's block, no boundary term:
    'diffusion' −∇·((1 + u²)∇u) + u = 1, or 'atan' −Δu + atan(u − 2) = 0
    (near-flat far field: full Newton steps overshoot)."""
    import torch

    from iifea_tpu_torch.mesh.core import FunctionSpace
    from iifea_tpu_torch.ops.assembly import Form, Term, build_cell_domain

    V = FunctionSpace(mesh, degree=1, n_fields=1)

    def kern(u_loc, aux_loc, ctx, params):
        uq = torch.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        if kind == "diffusion":
            r = torch.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq ** 2, gu,
                             ctx.gphi)
            react = uq - 1.0
        else:
            r = torch.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
            react = torch.arctan(uq - 2.0)
        return (r + torch.einsum("q,q,qb->b", ctx.w, react, ctx.phi))[:, None]

    cells = (mesh.material == 2).nonzero()[0]
    return Form(V, [Term(build_cell_domain(V, cells, 3, device=device),
                         kern)])


def newton_run(n_bg, device, kind="diffusion", start=0.0, **kw):
    """``solve_nonlinear`` on the cut square at ``n_bg`` on ``device``, with
    every Newton step's assembly and linear-solve seconds, linear
    iterations and stencil launches recorded. Returns a dict; ``error`` is
    the NonlinearSolveError where one was raised."""
    import torch

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import newton

    def timed(fn):
        if device.type == "cuda":
            return sync_time(fn)
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    mesh, M = immersed_square_problem(n_fg=fg_of(n_bg), n_bg=n_bg,
                                      device=device)
    form = scalar_form(mesh, device, kind)
    steps = []
    assemble, solve_ksp = form.jacobian_and_residual, newton.solve_ksp

    def timed_assemble(*a, **k):
        out, dt = timed(lambda: assemble(*a, **k))
        steps.append({"assemble_seconds": dt})
        return out

    def timed_solve(*a, **k):
        before = sum(sk.launches().values())
        (x, info), dt = timed(lambda: solve_ksp(*a, **k))
        steps[-1].update(
            residual_norm=float(torch.linalg.vector_norm(a[1])),
            solve_seconds=dt, launches=sum(sk.launches().values()) - before,
            linear_iters=None if info is None else info.iters)
        return x, info

    form.jacobian_and_residual = timed_assemble
    newton.solve_ksp = timed_solve
    u0 = torch.full((M.n_bg_dofs,), float(start), dtype=torch.float64,
                    device=device)
    out = {"M": M, "form": form, "steps": steps, "error": None}
    try:
        out["u_p"], out["u_f"] = newton.solve_nonlinear(
            form, M.mv(u0), M, u0, monitor_newton=False,
            **{"max_iters": 30, "relative_tolerance": 1e-8, **kw})
    except newton.NonlinearSolveError as e:
        out["error"] = e
    finally:
        newton.solve_ksp = solve_ksp
        del form.jacobian_and_residual
    r0 = M.rmv(assemble(M.mv(u0))[1])
    out["r0"] = float(torch.linalg.vector_norm(r0))
    if out["error"] is None:
        out["r"] = float(torch.linalg.vector_norm(
            M.rmv(form.residual(out["u_f"]))))
    return out


def phase_newton():
    """The Newton solvers on the card. ``solve_nonlinear(linear_method='cg',
    linear_pc='mg')`` on the nonlinear diffusion form at n_bg = N_BG_NEWTON:
    every step re-assembles (jacfwd) and re-solves on the hand kernels;
    gates: converged, the projected residual down to 1e-8 of the first,
    stencil launches in every step whose linear solve iterates. At n_bg=64: the host's Newton
    iteration count, and the ``linear_pc='jacobi'`` run's solution: the
    foreground field over the block in L2 to 1e-5 relative, and the
    iterate to 1e-5·max|u| on dofs with a diagonal of at least a tenth of
    the largest (this form has no boundary term, so background dofs that
    reach the block through the same few foreground nodes are determined
    only in combination, whatever their diagonal); the atan-reaction case (plain Newton
    raises NonlinearSolveError, ``line_search=True`` converges);
    ``solve_newtons_linear`` on Poisson with two supported dofs pinned to
    zero against the direct solve of the trimmed system (its residual, and
    the foreground field's error norms: the system is near-singular, so
    background values are not compared)."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.projection import (
        BackgroundOperator,
        assemble_background_system,
    )
    from iifea_tpu_torch.solvers import ksp, newton, trim

    cpu, dev = torch.device("cpu"), torch.device("cuda", 0)
    mg = dict(linear_method="cg", linear_pc="mg")

    # -- n_bg = 64: the host's iteration count, the Jacobi run's iterate -------
    shape = (65, 65)
    runs = {"card_mg": newton_run(64, dev, lattice_shape=shape, **mg),
            "host_mg": newton_run(64, cpu, lattice_shape=shape, **mg),
            "card_jacobi": newton_run(64, dev, linear_method="cg",
                                      linear_pc="jacobi")}
    if any(r["error"] for r in runs.values()):
        fail(f"newton n_bg=64 did not converge: "
             f"{ {k: str(r['error']) for k, r in runs.items()} }")
    r = runs["card_mg"]
    blocks, _ = r["form"].jacobian_and_residual(r["u_f"])
    d = BackgroundOperator(r["form"], blocks, r["M"]).diag().abs()
    d = d >= 0.1 * d.max()
    u_j = runs["card_jacobi"]["u_p"]
    diff = float((r["u_p"] - u_j)[d].abs().max())
    lim = 1e-5 * max(float(u_j[d].abs().max()), 1.0)
    dom = r["form"].terms[0][0]
    field = (l2_norm(r["u_f"] - runs["card_jacobi"]["u_f"], dom)
             / l2_norm(runs["card_jacobi"]["u_f"], dom))
    phase("newton_small", n_bg=64,
          newton_iters={k: len(v["steps"]) for k, v in runs.items()},
          linear_iters={k: [s_["linear_iters"] for s_ in v["steps"]]
                        for k, v in runs.items()},
          residual={k: v["r"] / v["r0"] for k, v in runs.items()},
          max_abs_diff_mg_jacobi=diff, bound=lim,
          field_rel_diff_mg_jacobi=field)
    if len(r["steps"]) != len(runs["host_mg"]["steps"]):
        fail("newton n_bg=64: the card and the host take different numbers "
             "of Newton iterations")
    if not (r["u_p"].is_cuda and diff <= lim and field <= 1e-5):
        fail(f"newton n_bg=64: the mg and jacobi iterates differ by {diff} "
             f"(field: {field})")

    # -- the line-search case ---------------------------------------------------
    # n_bg = 16 (the reference test's size) with host direct solves: the
    # far-field Jacobian is near-singular (atan' ≈ 1/325, no boundary
    # term), which an f32 MG-CG pass cannot resolve
    plain = newton_run(16, dev, kind="atan", start=20.0, max_iters=3,
                       linear_method="direct")
    ls = newton_run(16, dev, kind="atan", start=20.0, max_iters=20,
                    line_search=True, linear_method="direct")
    phase("newton_line_search", n_bg=16,
          plain_newton="raised" if plain["error"] else "converged",
          plain_residuals=[s_["residual_norm"] for s_ in plain["steps"]],
          line_search_residuals=[s_["residual_norm"] for s_ in ls["steps"]],
          line_search="raised" if ls["error"] else "converged",
          line_search_steps=len(ls["steps"]),
          residual=None if ls["error"] else ls["r"])
    stuck = (plain["steps"][-1]["residual_norm"]
             >= 0.9 * plain["steps"][0]["residual_norm"])
    if not (plain["error"] and stuck and ls["error"] is None
            and ls["r"] < 1e-6):
        fail("newton: the atan case needs plain Newton to make no progress "
             "in 3 steps and the line search to converge")
    del plain, ls, runs, r

    # -- solve_newtons_linear with pinned dofs ---------------------------------
    mesh, M = immersed_square_problem(n_fg=fg_of(64), n_bg=64, device=dev)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=dev)
    u_f0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=dev)
    A, b = assemble_background_system(prob.form, u_f0, M)
    diag = A.diag()
    pin = torch.argsort(diag)[-2:].cpu().numpy()
    warm = torch.ones(M.n_bg_dofs, dtype=torch.float64, device=dev)
    (u, u_f), dt = sync_time(lambda: newton.solve_newtons_linear(
        prob.form, u_f0, M, warm, zero_ids=pin, monitor_newton=False,
        linear_method="cg", linear_pc="jacobi"))
    mask = trim.mask_from_ids(pin, M.n_bg_dofs, device=dev)
    A_t, b_t = A.with_trim(mask), trim.apply_trim_rhs(b, mask)
    u_d, _ = ksp.solve_ksp(A_t, b_t, method="direct")
    relres = rel_residual(A_t, b_t, u)
    norms, norms_d = prob.error_norms(u_f), prob.error_norms(M.mv(u_d))
    rel = {k: abs(norms[k] - norms_d[k]) / norms_d[k] for k in norms}
    phase("newtons_linear", n_bg=64, pinned=pin.tolist(), seconds=dt,
          pinned_values=u[mask].tolist(), rel_residual=relres,
          error_norms=norms, error_norms_direct=norms_d, norms_rel_diff=rel)
    if not (u.is_cuda and bool((u[mask] == 0).all()) and relres < 1e-6
            and max(rel.values()) < 1e-5):
        fail(f"solve_newtons_linear: pinned {u[mask].tolist()}, residual "
             f"{relres}, norms differ from the direct solve's by {rel}")
    del mesh, M, prob, A, b

    # -- the main run at n_bg = N_BG_NEWTON ------------------------------------
    torch.cuda.empty_cache()
    names = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    r, seconds, launches, by_shape = counted_run(
        lambda: newton_run(N_BG_NEWTON, dev,
                           lattice_shape=(N_BG_NEWTON + 1,) * 2, **mg),
        names, "newton")
    if r["error"]:
        fail(f"newton n_bg={N_BG_NEWTON}: {r['error']}")
    phase("newton", n_bg=N_BG_NEWTON, n_bg_dofs=r["M"].n_bg_dofs,
          n_block_cells=r["form"].terms[0][0].n_elem, seconds=seconds,
          newton_iters=len(r["steps"]),
          linear_iters=sum(s_["linear_iters"] for s_ in r["steps"]),
          steps=r["steps"], residual_first=r["r0"], residual_final=r["r"],
          launches=launches, launches_by_shape=by_shape,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not (r["u_p"].is_cuda and bool(torch.isfinite(r["u_p"]).all())):
        fail("newton: the iterate is not a finite card vector")
    if not r["r"] <= 1e-8 * r["r0"]:
        fail(f"newton: projected residual {r['r']} > 1e-8 x {r['r0']}")
    # a converged step's rhs is below the linear solve's atol: no iteration
    iterated = [s_ for s_ in r["steps"] if s_["linear_iters"]]
    if not (iterated and all(s_["launches"] > 0 for s_ in iterated)):
        fail(f"newton: a step's linear solve iterated without a stencil "
             f"launch: {r['steps']}")


N_BG_ASM = 256


def phase_asm():
    """``solve_ksp(gmres, pc='asm')`` on immersed Poisson at n_bg = N_BG_ASM
    (n_fg = 2·n_bg, the fg/bg ratio of the reference's asm test; 66,049
    dofs: the patch setup is host loops over dofs, a demo-size
    preconditioner) against pc='jacobi', both to rtol 1e-12: the residual
    (≤ 1.5e-10), fewer iterations, the same solution to 1e-7·max|u| on
    dofs with a nonzero diagonal (at rtol 1e-10 the two solutions are
    2.3e-7 apart at this size, on well-supported dofs: the system's
    conditioning times the residual)."""
    import torch

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import ksp, precond

    dev = torch.device("cuda", 0)
    mesh, M = immersed_square_problem(n_fg=2 * N_BG_ASM, n_bg=N_BG_ASM,
                                      device=dev)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=dev)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=dev), M)
    made, out = [], {}
    schwarz = precond.AdditiveSchwarz

    def recorded(*a, **kw):
        made.append(sync_time(lambda: schwarz(*a, **kw)))
        return made[-1][0]

    precond.AdditiveSchwarz = recorded
    try:
        for pc in ("asm", "jacobi"):
            (x, info), dt = sync_time(lambda: ksp.solve_ksp(
                A, b, method="gmres", pc=pc, rtol=1e-12, atol=1e-14,
                monitor=False))
            out[pc] = (x, info, dt)
    finally:
        precond.AdditiveSchwarz = schwarz
    x_a, info_a, t_a = out["asm"]
    x_j, info_j, t_j = out["jacobi"]
    relres = rel_residual(A, b, x_a)
    d = A.diag().abs() > 0
    diff = float((x_a - x_j)[d].abs().max())
    lim = 1e-7 * max(float(x_j.abs().max()), 1.0)
    asm, t_setup = made[0]
    phase("asm", n_bg=N_BG_ASM, n_bg_dofs=M.n_bg_dofs,
          patches=asm.n_patches, width=asm.width, setup_seconds=t_setup,
          solve_seconds=t_a - t_setup, iters=info_a.iters,
          rel_residual=relres, jacobi_iters=info_j.iters,
          jacobi_seconds=t_j, max_abs_diff=diff, bound=lim,
          tables_on_card=bool(asm.inv.is_cuda and asm.idx.is_cuda))
    if not (x_a.is_cuda and asm.inv.is_cuda and relres <= 1.5e-10):
        fail(f"asm: residual {relres}, or a tensor off the card")
    if not info_a.iters < info_j.iters:
        fail(f"asm: {info_a.iters} iterations, jacobi {info_j.iters}")
    if not diff <= lim:
        fail(f"asm: differs from the jacobi solution by {diff} > {lim}")


PHASES = ("device", "build", "kernels", "kernels3", "small_reference",
          "small_reference3", "main_path", "main_path3", "demo",
          "elasticity", "demo_elasticity", "elasticity3", "newton", "asm")


def kernel_shapes(timing, by_shape):
    """Each timed (kernel, shape[, form]) with its main-path launches (for
    a ``smooth_call`` row: calls), and per kernel the launches × (device ms
    − bound ms) summed over the shapes. A ``smooth_call`` row books a whole
    smoothing call; where it is routed to one launch per pass, those
    launches also stand under ``jacobi_smooth`` and ``stencil_mv_block``."""
    def key(r):
        form = f":{r['form']}" if "form" in r else ""
        return f"{r['kernel']}@{'x'.join(map(str, r['shape']))}{form}"

    rows, excess = [], Counter()
    for r in timing:
        n = by_shape.get(key(r), 0)
        rows.append({**r, "launches": n})
        excess[r["kernel"]] += n * (r["device_ms"] - r["bound_ms"])
    timed = {key(r) for r in timing}
    phase("kernel_shapes", rows=rows, excess_ms=dict(excess),
          untimed={k: v for k, v in by_shape.items() if k not in timed})
    return rows


def main() -> None:
    args = sys.argv[1:]
    run = set(PHASES)
    if args[:1] == ["--phases"] and len(args) == 2:
        run = set(args[1].split(",")) | {"device", "build"}
    elif args:
        fail(f"usage: chip_smoke.py [--phases {','.join(PHASES)}]")
    t0 = time.perf_counter()
    worst, timing, launches, by_shape = {}, [], Counter(), Counter()
    phase_device()
    phase_build()
    for name, fn in (("kernels", phase_kernels),
                     ("kernels3", phase_kernels3)):
        if name in run:
            w, t = fn()
            worst.update(w)
            timing += t
    if "small_reference" in run:
        phase_small_reference()
    if "small_reference3" in run:
        phase_small_reference3()
    # each main path's counted solve; the 2D and elasticity solves both
    # launch stencil_mv, and Counter.update adds their counts
    for name, fn in (("main_path", phase_main_path),
                     ("main_path3", phase_main_path3),
                     ("demo", phase_demo),
                     ("elasticity", phase_elasticity),
                     ("demo_elasticity", phase_demo_elasticity),
                     ("elasticity3", phase_elasticity3),
                     ("newton", phase_newton),
                     ("asm", phase_asm)):
        if name in run:
            counts = fn()
            if counts is not None:
                launches.update(counts[0])
                by_shape.update(counts[1])
    import torch

    kernel_shapes(timing, by_shape)
    phase("elapsed", seconds=time.perf_counter() - t0)
    if run != set(PHASES):
        fail(f"only phases {sorted(run)} ran: no result")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        # a fused smoothing call is one launch of "smooth"
        timed_as = "smooth_call" if name == "smooth" else name
        t = next(r for r in timing
                 if r["kernel"] == timed_as and "plain_ms" in r)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["device_ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
