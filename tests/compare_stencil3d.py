#!/usr/bin/env python3
"""Profile and time the 3D stencil kernels of ``iifea_tpu_torch`` on a card:
``stencil3d_block`` (the 3D elasticity V-cycle's passes) and the scalar 3D
smoothing kernels (``jacobi_smooth3`` and its Chebyshev step), at the level
shapes their paths launch them at. Card only; imports no JAX.

    # Nsight Compute readings of single launches (needs ncu on PATH or
    # under /usr/local/cuda/bin):
    python3 tests/compare_stencil3d.py --ncu
    # device ms per pass and per smoothing call, for one tree:
    python3 tests/compare_stencil3d.py --time
    # two trees in turns (A, B, B, A), each in its own process:
    python3 tests/compare_stencil3d.py --trees parent_dir,.
    # the change's split, and its routes, swept at one shape:
    python3 tests/compare_stencil3d.py --sweep block3:25
    # ... and at r >= 5 (the runtime-radius kernel):
    python3 tests/compare_stencil3d.py --sweep quartic64:33 block3r5:17
    # a level's smoothing call alone, by each route, device and eager ms,
    # at every 3D path's level shapes (LEVEL_CALLS) or at those given:
    python3 tests/compare_stencil3d.py --calls [quartic64:17 ...]
    # host ms per V-cycle of each 3D path (VCYCLES), planned and with
    # every level on one launch a pass:
    python3 tests/compare_stencil3d.py --vcycles
    # every 3D marching route's output at every split, hashed, on two trees
    # (bitwise equal or not), and on this tree with NaN in the planes' taps
    # outside the lattice (bitwise equal to zeros there or not):
    python3 tests/compare_stencil3d.py --digest-trees parent_dir,.

``--one CASE`` makes exactly one launch of the case (the first stencil
kernel of the process), which is what ``--ncu`` profiles.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# case: (kind, fields or dtype, shape side, radius)
ONE = {
    "block_sweep_97": ("block", 3, 97, 2),
    "block_sweep_13": ("block", 3, 13, 2),
    "cheb_f64_65": ("cheb", "f64", 65, 3),
    "cheb_f64_17": ("cheb", "f64", 17, 3),
}
NCU_METRICS = (
    "dram__throughput.avg.pct_of_peak_sustained_elapsed",
    "lts__t_sector_hit_rate.pct",
    "l1tex__t_sectors_pipe_lsu_mem_global_op_ld.sum",
    "l1tex__t_requests_pipe_lsu_mem_global_op_ld.sum",
    "sm__warps_active.avg.pct_of_peak_sustained_active",
    "gpu__time_duration.sum",
    "launch__registers_per_thread",
    "regex:smsp__average_warps_issue_stalled_.*_per_issue_active\\.ratio",
)
GRAPH_LAUNCHES = 50


def _operands(kind, what, side, radius, seed=0, dtype="f32"):
    """A case's random operands: ``what`` the fields of a block operator
    (in ``dtype``), or the scalar planes' dtype."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (side,) * 3
    n = side ** 3
    m3 = (2 * radius + 1) ** 3
    if kind == "block":
        nF = what
        dt = torch.float64 if dtype == "f64" else torch.float32
        C = torch.rand((nF, nF, m3, *shape), generator=g, device=dev,
                       dtype=dt)
        C = C.sub_(0.5).mul_(0.2)
        for f in range(nF):
            C[f, f, m3 // 2] += 4.0
        binv = torch.rand((nF, nF, n), generator=g, device=dev,
                          dtype=dt).mul_(0.1)
        b, x = (torch.randn(nF * n, generator=g, device=dev, dtype=dt)
                for _ in range(2))
        return C, binv, b, x, shape
    dt = torch.float64 if what == "f64" else torch.float32
    C = torch.randn((m3, *shape), generator=g, device=dev, dtype=dt)
    invd = torch.rand(n, generator=g, device=dev, dtype=dt).mul_(0.01)
    b, x = (torch.randn(n, generator=g, device=dev, dtype=dt)
            for _ in range(2))
    return C, invd, b, x, shape


def one(case: str) -> None:
    """Exactly one launch of ``case`` (no warm-up launch of any stencil
    kernel before it)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    sk.build()
    kind, what, side, r = ONE[case]
    C, binv, b, x, shape = _operands(kind, what, side, r)
    torch.cuda.synchronize()
    if kind == "block":
        y = sk.stencil3d_block(C, x, shape, r, b=b, binv=binv, omega=1.0)
    else:
        y, _ = sk.cheb_step3(C, binv, b, x, x.clone(), 1.3, 0.45, shape, r)
    torch.cuda.synchronize()
    print(json.dumps({"case": case, "sum": float(y.abs().sum())}))


def _ncu() -> str:
    path = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(path):
        raise SystemExit("ncu not found")
    return path


def ncu() -> None:
    """Each ``ONE`` case under Nsight Compute: its first launch whose name
    holds ``stencil3d``, the metrics of ``NCU_METRICS``; one JSON line a
    case."""
    for case in ONE:
        cmd = [_ncu(), "--launch-count", "1", "-k", "regex:stencil3d",
               "--csv", "--metrics", ",".join(NCU_METRICS), sys.executable,
               os.path.abspath(__file__), "--one", case]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        rows = {}
        for line in res.stdout.splitlines():
            cells = [c.strip('"') for c in re.findall(r'"[^"]*"', line)]
            if len(cells) >= 3 and "__" in cells[-3]:
                rows[cells[-3]] = cells[-1]
        out = {"ncu": case, "rc": res.returncode, "metrics": rows}
        if res.returncode != 0 or not rows:
            out["stdout"] = res.stdout[-3000:]
            out["stderr"] = res.stderr[-3000:]
        print(json.dumps(out), flush=True)


def device_ms(fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device ms per call of fn(): a CUDA graph of ``launches`` captured
    calls, one event pair around each replay; the median of ``reps``."""
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
    return sorted(times)[len(times) // 2]


# (label, fields or dtype, sides, radius[, block dtype]): the 3D
# elasticity block V-cycle (97³ … 13³, 3 and 2 fields), the cubic
# three-field f64 r = 4 levels (73³, 37³, 19³ of the wide elasticity's
# hierarchy; 17³ of the cubic elasticity's), the three-field f64 r = 5
# passes at 17³, the 3D biharmonic (65³ … 17³ f64 r = 3, and its
# f32 route), the 3D Poisson cycle (105³ … 27³ f32 r = 2; its f64 route's
# finest level), the cubic and quartic 3D biharmonic's finest levels
# (33³, r = 4; 33³ and 17³, r = 5), f64 and f32
BLOCK = [("block3", 3, (97, 49, 25, 13), 2), ("block2", 2, (97, 49, 25, 13),
                                              2),
         ("block3f64", 3, (25, 13), 2, "f64"),
         ("block3r4", 3, (73, 37, 19, 17), 4, "f64"),
         ("block3r5", 3, (17, 33), 5, "f64")]
SCALAR = [("bh64", "f64", (65, 33, 17), 3), ("bh32", "f32", (65, 33, 17), 3),
          ("poisson", "f32", (105, 53, 27), 2),
          ("poisson64", "f64", (105,), 2), ("cubic64", "f64", (33,), 4),
          ("cubic32", "f32", (33,), 4), ("quartic64", "f64", (33, 17), 5),
          ("quartic32", "f32", (33, 17), 5)]


def _scalar_mg(C, shape, radius):
    """A one-level StencilMultigrid3D on C (its smoothing calls only)."""
    import warnings

    from iifea_tpu_torch.ops.multigrid import StencilMultigrid3D
    from iifea_tpu_torch.ops.stencil import StencilOperator3D

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return StencilMultigrid3D(StencilOperator3D(C, shape, radius),
                                  min_size=10 ** 6, coarse_sweeps=0)


def _calls(label, what, side, r, *dtype):
    """{row name: fn} of one case on this tree's own API."""
    import inspect

    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D

    if label.startswith("block"):
        C, binv, b, x, sh = _operands("block", what, side, r, 0, *dtype)
        S = StencilOperatorBlock3D(C, sh, r)
        return {
            "apply": lambda: sk.stencil3d_block(C, x, sh, r),
            "residual": lambda: sk.stencil3d_block(C, x, sh, r, b=b),
            "sweep": lambda: sk.stencil3d_block(C, x, sh, r, b=b, binv=binv,
                                                omega=1.0),
            "zero": lambda: sk.stencil3d_block(C, None, sh, r, b=b,
                                               binv=binv, omega=1.0),
            "call_pre": lambda: S.smooth(binv, b, None, 1.0, 2, True),
            "call_post": lambda: S.smooth(binv, b, x, 1.0, 2),
        }
    C, invd, b, x, sh = _operands("scalar", what, side, r)
    d = torch.randn_like(x)
    mg = _scalar_mg(C, sh, r)
    S = mg.levels[0]
    if "with_residual" in inspect.signature(mg._smooth).parameters:
        def pre():
            return mg._smooth(0, None, b, 2, x_zero=True, with_residual=True)
    else:
        def pre():
            y = mg._smooth(0, torch.zeros_like(b), b, 2, x_zero=True)
            return y, b - S.mv(y)
    return {
        "mv": lambda: sk.stencil_mv3(C, x, sh, r),
        "jacobi": lambda: sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, r),
        "cheb": lambda: sk.cheb_step3(C, invd, b, x, d, 1.3, 0.45, sh, r),
        "call_pre": pre,
        "call_post": lambda: mg._smooth(0, x, b, 2),
    }


# (label, fields (0: scalar Chebyshev cycle), finest side, radius, dtype):
# the V-cycles of the 3D elasticity, Poisson and biharmonic paths, and of
# the cubic and quartic biharmonic's 33³ nets
VCYCLES = [("elasticity3", 3, 97, 2, "f32"), ("poisson3", 0, 105, 2, "f32"),
           ("biharmonic3", 0, 65, 3, "f64"), ("cubic3", 0, 33, 4, "f64"),
           ("quartic3", 0, 33, 5, "f64"), ("quartic3_f32", 0, 33, 5, "f32")]


def vcycle_ms(label, nf, side, r, what, reps: int = 20,
              rounds: int = 3) -> dict:
    """Host ms per V-cycle (``minv``, eager, synchronised: the host's
    launch work included) on a hierarchy of random planes, by the tree's
    own routing and, where the tree has a level launch, with every level
    on one launch per pass: ``rounds`` pairs in turns (A B, B A, ...), each
    the mean of ``reps`` cycles; the medians, and every pair's ms."""
    import statistics
    import time

    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.ops.stencil import (StencilOperator3D,
                                             StencilOperatorBlock3D)

    if nf:
        C, _, b, _, sh = _operands("block", nf, side, r)
        mg = multigrid.StencilMultigridBlock3D(StencilOperatorBlock3D(C, sh,
                                                                      r))
    else:
        C, _, b, _, sh = _operands("scalar", what, side, r)
        C[(2 * r + 1) ** 3 // 2] += 4.0 * C.abs().sum(dim=0)
        mg = multigrid.StencilMultigrid3D(StencilOperator3D(C, sh, r))

    def timed():
        for _ in range(3):
            mg.minv(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            mg.minv(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    planned = sk._plan3

    def per_pass():
        sk._plan3 = lambda *a: (planned(*a)[0], 0, *planned(*a)[2:])
        try:
            return timed()
        finally:
            sk._plan3 = planned

    runs = {"planned": [], "per_pass_only": []}
    for k in range(rounds):
        order = ("planned", "per_pass_only")[::1 - 2 * (k % 2)]
        for name in order:
            runs[name].append(timed() if name == "planned" else per_pass())
    return {**{k: statistics.median(v) for k, v in runs.items()},
            "runs": runs}


def time_tree(tag: str) -> None:
    """One JSON line per (case, row): device ms on this tree; then host ms
    per V-cycle of each 3D path."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    sk.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for label, what, sides, r, *dtype in BLOCK + SCALAR:
        for side in sides:
            calls = _calls(label, what, side, r, *dtype)
            for row, fn in calls.items():
                print(json.dumps({"tree": tag, "case": label, "side": side,
                                  "row": row, "ms": device_ms(fn),
                                  "card": smi}), flush=True)
            del calls
            torch.cuda.empty_cache()
    for label, nf, side, r, what in VCYCLES:
        for route, ms in vcycle_ms(label, nf, side, r, what).items():
            print(json.dumps({"tree": tag, "case": "vcycle", "side": side,
                              "row": f"{label}:{route}", "ms": ms,
                              "card": smi}), flush=True)
        torch.cuda.empty_cache()


def trees(paths) -> None:
    """time_tree on each tree in turns A, B, B, A (one process each)."""
    order = [paths[0], paths[1], paths[1], paths[0]]
    for path in order:
        env = {**os.environ, "STENCIL3D_TREE": os.path.abspath(path)}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time",
                        "--tag", path], env=env, check=True)


def sweep(target: str) -> None:
    """The change at one shape (``block3:25``, ``bh64:17`` …): a sweep pass
    at each split by the plan's staging and, where the plan stages, by the
    unstaged route, then the V-cycle's two smoothing calls (2 steps from
    zero with the residual; 2 steps from x) by each route that takes the
    level, at the plan's split."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    label, side = target.split(":")
    side = int(side)
    case = next(c for c in BLOCK + SCALAR if c[0] == label)
    kind = "block" if label.startswith("block") else "scalar"
    C, binv, b, x, sh = _operands(kind, case[1], side, case[3], 0,
                                  *case[4:])
    r = case[3]
    nF = case[1] if kind == "block" else 1
    planned = sk._plan3(sh, r, nF, 0, C.dtype == torch.float64)
    print(json.dumps({"sweep": target, "plan": planned}), flush=True)
    stagings = [planned[3]] + [sk.UNSTAGED] * (planned[3] != sk.UNSTAGED)
    for staging in stagings:
        for split in SPLITS:
            if split >= 2 * nF * (2 * r + 1):
                break
            ms = device_ms(lambda: sk._pass3(sk._SWEEP, C, x, b, binv, sh, r,
                                             nF, s0=0.9, split=split,
                                             staging=staging))
            print(json.dumps({"sweep": target, "split": split,
                              "staging": staging, "pass_ms": ms}),
                  flush=True)
    level_calls(target, (C, binv, b, x, sh))


def eager_ms(fn, reps: int = 50) -> float:
    """Host ms per call of fn() made back to back, eagerly, as the V-cycle
    makes it (the host's launch work included), synchronised once at the
    end."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# the 3D paths' level shapes a level's one launch can hold (label:side):
# the 3D elasticity (f32 and its f64 route), the Poisson cycle's smallest,
# the biharmonic's (f64 and f32), the cubic and quartic biharmonic's, the
# cubic three-field elasticity's (17³ and the 73³ path's 19³)
LEVEL_CALLS = ("block3:25", "block3:13", "block2:25", "block2:13",
               "block3f64:25", "block3f64:13", "poisson:27", "bh64:33",
               "bh64:17", "bh32:33", "bh32:17", "cubic64:33", "cubic64:17",
               "cubic32:33", "cubic32:17", "block3r4:19", "block3r4:17",
               "quartic64:33", "quartic64:17", "quartic32:33",
               "quartic32:17", "block3r5:17")


def level_calls(target: str, operands=None) -> None:
    """The V-cycle's two smoothing calls at one shape (2 steps from zero
    with the residual; 2 steps from x) by each route that takes the level,
    at the plan's split: device ms (a CUDA graph) and eager ms per call,
    with the plan's route and the level's coefficient bytes in the
    lattice (what ``level_pays`` holds to the card's L2)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    label, side = target.split(":")
    side = int(side)
    case = next(c for c in BLOCK + SCALAR if c[0] == label)
    kind = "block" if label.startswith("block") else "scalar"
    if operands is None:
        operands = _operands(kind, case[1], side, case[3], 0, *case[4:])
    C, binv, b, x, sh = operands
    r = case[3]
    nF = case[1] if kind == "block" else 1
    planned = sk._plan3(sh, r, nF, 0, C.dtype == torch.float64)
    taps = math.prod(sum(min(i + r, n - 1) - max(i - r, 0) + 1
                         for i in range(n)) for n in sh)
    coef_mb = taps * nF * nF * C.element_size() / 1e6
    steps = [(0.9, 0.0), (1.1, 0.3 if kind == "scalar" else 0.0)]
    cheb = kind == "scalar"
    for form, start, res in (("pre", None, True), ("post", x, False)):
        for route in (sk.PER_PASS, sk.GRID):
            def call():
                return sk._smooth3_cuda(route, C, binv, b, start, steps, sh,
                                        r, nF, res, cheb)
            try:
                ms, host = device_ms(call), eager_ms(call)
            except (RuntimeError, ValueError) as e:   # the launch refused
                ms = host = str(e)
            print(json.dumps({"sweep": target, "form": form,
                              "route": ["per_pass", "grid"][route],
                              "call_ms": ms, "eager_ms": host,
                              "plan": list(planned),
                              "coef_mb": coef_mb}), flush=True)
    del C, binv, b, x, operands
    torch.cuda.empty_cache()


# the splits a marching pass takes (threads per point)
SPLITS = (1, 2, 4, 8, 16)
# the digest cases: radius, fields (0: scalar planes), shapes
DIGEST_SHAPES = ((9, 9, 9), (13, 10, 17), (17, 17, 17))
DIGEST_RADII = (1, 2, 3, 4, 5, 6, 7)


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def digests(tag: str) -> None:
    """One JSON line per (radius, fields, dtype, shape, split): the hash of
    each route's output (every pass by every staging the lattice takes, a
    level's smoothing call in one launch, from zero with the residual and
    from x) on seeded operands, "refused" where the tree refuses it; and
    whether each output with NaN in every tap outside the lattice is
    bitwise the same (``nan_equal``)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    sk.build()
    for r in DIGEST_RADII:
        for nf in (0, 1, 2, 3):
            nF = max(nf, 1)
            for dt in ("f32", "f64"):
                for sh in DIGEST_SHAPES:
                    C, binv, b, x = _operands_shape(nf, sh, r, dt)
                    out = _outside(sh, r, C.device)
                    Cn = C.clone()
                    Cn[..., out] = float("nan")
                    f64 = dt == "f64"
                    plan = sk._plan3(sh, r, nF, 0, f64)
                    stagings = ([sk.ALL_FIELDS] + [sk.PER_FIELD] * (nF > 1)
                                if r <= 4 else [plan[3]]) + [sk.UNSTAGED]
                    d = torch.ones_like(b)
                    for split in SPLITS:
                        row = {"tree": tag, "r": r, "nf": nf, "dtype": dt,
                               "shape": list(sh), "split": split,
                               "out": {}, "nan_equal": True}
                        for st in dict.fromkeys(stagings):
                            for pass_ in ((sk._APPLY, sk._RESIDUAL,
                                           sk._SWEEP, sk._ZERO)
                                          + ((sk._CHEB,) if nf == 0 else ())):
                                key = f"{sk._PASSES[pass_]}/{st}"

                                def run(C_):
                                    return sk._pass3(
                                        pass_, C_,
                                        None if pass_ == sk._ZERO else x, b,
                                        binv, sh, r, nF, omega0=0.8, s0=1.1,
                                        s1=0.3 if pass_ == sk._CHEB else 0.0,
                                        d=d.clone(), split=split, staging=st,
                                        count=False)
                                _record(row, key, run, C, Cn)
                        if r <= 4:
                            for start, name in ((None, "pre"), (x, "post")):
                                def run(C_, start=start):
                                    return torch.cat(_tuple(sk._smooth3_cuda(
                                        sk.GRID, C_, binv, b, start,
                                        [(0.9, 0.0), (1.1, 0.3 * (nf == 0))],
                                        sh, r, nF, start is None, nf == 0,
                                        split=split, staging=sk.ALL_FIELDS)))
                                _record(row, f"level_{name}", run, C, Cn)
                        print(json.dumps(row), flush=True)
                    del C, Cn, binv, b, x, d, out
                    torch.cuda.empty_cache()


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _outside(shape, radius, device):
    """The taps ((2r+1)³, *shape) whose x lies outside the lattice (as
    ``stencil_kernels.outside_taps``, which an earlier tree may lack)."""
    import torch

    m = 2 * radius + 1
    out = torch.zeros((m,) * 3 + tuple(shape), dtype=torch.bool,
                      device=device)
    for a, n in enumerate(shape):
        o = torch.arange(m, device=device)[:, None] - radius
        p = torch.arange(n, device=device)[None, :]
        view = [1] * 6
        view[a], view[3 + a] = m, n
        out |= ((p + o < 0) | (p + o >= n)).reshape(view)
    return out.reshape(m ** 3, *shape)


def _operands_shape(nf, shape, radius, dt):
    """Seeded random operands at any shape: a diagonally dominant nF-field
    operator (nf = 0: scalar planes and a flat diagonal scaling), smoother
    blocks, b and x, in f32 or f64 (``dt``)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    dtype = torch.float64 if dt == "f64" else torch.float32
    nF, n, m3 = max(nf, 1), math.prod(shape), (2 * radius + 1) ** 3
    C = torch.rand((nF, nF, m3, *shape), generator=g, device=dev,
                   dtype=dtype).sub_(0.5).mul_(0.2)
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    binv = torch.rand((nF, nF, n), generator=g, device=dev,
                      dtype=dtype).mul_(0.1)
    b, x = (torch.randn(nF * n, generator=g, device=dev, dtype=dtype)
            for _ in range(2))
    if nf == 0:
        return C[0, 0].contiguous(), binv[0, 0].contiguous(), b, x
    return C, binv, b, x


def _record(row, key, run, C, Cn) -> None:
    """The hash of run(C) under ``key`` ("refused" where the tree refuses
    the launch), and whether run(Cn) equals it bitwise."""
    import torch

    try:
        y = run(C)
    except (RuntimeError, ValueError):
        row["out"][key] = "refused"
        return
    row["out"][key] = _digest(y)
    row["nan_equal"] &= bool(torch.equal(run(Cn), y))


def digest_trees(paths) -> None:
    """``digests`` on each tree (one process each), then one JSON line: the
    outputs both trees give and how many are bitwise equal, those that
    differ, those only the last tree gives, and the rows of each tree
    whose outputs with NaN in the padding taps differ."""
    rows = []
    for path in paths:
        env = {**os.environ, "STENCIL3D_TREE": os.path.abspath(path)}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--digests", "--tag", path], env=env,
                             check=True, capture_output=True, text=True)
        rows.append({(d["r"], d["nf"], d["dtype"], tuple(d["shape"]),
                      d["split"]): d
                     for d in map(json.loads, res.stdout.splitlines())})
    first, last = rows[0], rows[-1]
    same, differ, only = 0, [], 0
    for key, d in last.items():
        for out, h in d["out"].items():
            h0 = first.get(key, {}).get("out", {}).get(out, "refused")
            if h == "refused":
                continue
            if h0 == "refused":
                only += 1
            elif h0 == h:
                same += 1
            else:
                differ.append([*key, out])
    print(json.dumps({
        "digest_trees": paths, "both": same + len(differ),
        "bitwise_equal": same, "differ": differ[:50],
        "n_differ": len(differ), "only_in_last": only,
        "nan_not_equal": {p: [list(k) for k, d in t.items()
                              if not d["nan_equal"]][:20]
                          for p, t in zip(paths, rows)}}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.path.insert(0, os.environ.get("STENCIL3D_TREE", ROOT))
    if args[:1] == ["--one"]:
        one(args[1])
    elif args == ["--ncu"]:
        ncu()
    elif args[:1] == ["--time"]:
        time_tree(args[args.index("--tag") + 1] if "--tag" in args else ".")
    elif args[:1] == ["--trees"]:
        trees(args[1].split(","))
    elif args[:1] == ["--digests"]:
        digests(args[args.index("--tag") + 1] if "--tag" in args else ".")
    elif args[:1] == ["--digest-trees"]:
        digest_trees(args[1].split(","))
    elif args[:1] == ["--sweep"]:
        for target in args[1:]:
            sweep(target)
    elif args == ["--vcycles"]:
        for label, nf, side, r, what in VCYCLES:
            print(json.dumps({"vcycle": label, "side": side, "radius": r,
                              "dtype": what, **vcycle_ms(label, nf, side, r,
                                                         what)}),
                  flush=True)
    elif args[:1] == ["--calls"]:
        for target in args[1:] or LEVEL_CALLS:
            level_calls(target)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    else:
        raise SystemExit(__doc__)
