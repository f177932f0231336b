"""Warm solve seconds of the port's two 2D multigrid main paths on a card,
with the V-cycle's smoothing calls routed as the kernel library plans them
(one cooperative launch per call on the levels whose tiles are co-resident)
and with every call forced to one launch per pass, in turns within one
process (planned, per pass, per pass, planned, ...):

* ``poisson2d``: ``BinnedLatticeSolver.solve(rtol=1e-10)`` at n_bg=1024;
* ``elasticity``: ``solve_ksp(cg, pc='mg', n_fields=2)`` at n_bg=512;
* ``quartic2d``: ``solve_ksp(gmres, pc='mg', stencil_radius=5)`` on the
  biharmonic's 513² quartic net (n_bg = 509, f64).

    python3 tests/compare_smooth_routing.py [--pairs 6] [--problems a,b]

Prints one JSON line per problem: the seconds of every warm solve by
routing, their medians, the stencil launches of one solve by routing, and
then the card's name and power limit. ``--levels`` instead times one
smoothing call of the V-cycle (its two forms: NU sweeps from zero with the
residual, NU from x) at each 2D path's level shapes (``LEVELS``) by each
route that takes the level: device ms (a CUDA graph) and eager ms, as the
V-cycle makes the call. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from iifea_tpu_torch.ops import stencil_kernels as sk  # noqa: E402


@contextlib.contextmanager
def routing(name: str):
    """``planned``: the library's choice; ``per_pass``: every smoothing call
    as one launch per pass."""
    planned = sk._smooth_route
    if name == "per_pass":
        sk._smooth_route = lambda *a: sk.PER_PASS
    try:
        yield
    finally:
        sk._smooth_route = planned


def compare(tag: str, solve, pairs: int) -> None:
    seconds = {"planned": [], "per_pass": []}
    launches = {}
    for name in seconds:
        with routing(name):
            solve()                                   # warm-up
            sk.reset_launches()
            solve()
            launches[name] = {k: v for k, v in sk.launches().items() if v}
    for pair in range(pairs):
        order = ("planned", "per_pass") if pair % 2 == 0 else (
            "per_pass", "planned")
        for name in order:
            with routing(name):
                _, dt = cs.sync_time(solve)
            seconds[name].append(dt)
    print(json.dumps({
        "problem": tag, "seconds": seconds,
        "median": {k: statistics.median(v) for k, v in seconds.items()},
        "stencil_launches": launches}), flush=True)


# (label, fields (0: scalar planes), radius, dtype, sides): the 2D
# V-cycles' smoothed levels a level's one launch can hold: Poisson (f32
# r = 2), elasticity and Navier-Stokes (2 and 3 fields), the biharmonic's
# quadratic, cubic and quartic nets (f64 r = 3, 4, 5)
LEVELS = [("poisson", 0, 2, "f32", (257, 129, 65)),
          ("elasticity", 2, 2, "f32", (257, 129, 65, 33, 17)),
          ("navier_stokes", 3, 2, "f32", (257, 129, 65, 33, 17)),
          ("biharmonic", 0, 3, "f64", (257, 129, 65)),
          ("cubic", 0, 4, "f64", (257, 129, 65)),
          ("quartic", 0, 5, "f64", (257, 129, 65))]


def eager_ms(fn, reps: int = 50) -> float:
    """Host ms per call of fn() made back to back, eagerly, synchronised
    once at the end."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def levels(dev) -> None:
    import numpy as np

    rng = np.random.default_rng(19)
    for label, n_fields, r, dt, sides in LEVELS:
        dtype = torch.float64 if dt == "f64" else torch.float32
        nF = max(n_fields, 1)
        for side in sides:
            shape = (side, side)
            C, binv, b, x = cs.level_operands(rng, shape, r, n_fields, dev,
                                              dtype)
            m = 2 * r + 1
            taps = sum(min(i + r, side - 1) - max(i - r, 0) + 1
                       for i in range(side)) ** 2
            planned = sk._smooth_route(shape, r, nF, 0, dt == "f64")
            for form, (from_zero, with_residual) in cs.FORMS.items():
                start = None if from_zero else x
                for route in (sk.PER_PASS, sk.GRID):
                    def call():
                        return sk._smooth_cuda(route, C, binv, b, start,
                                               0.67, cs.NU, shape, r, nF,
                                               with_residual)
                    try:
                        ms, host = cs.device_ms(call), eager_ms(call)
                    except RuntimeError as e:     # the launch refused
                        ms = host = str(e)
                    print(json.dumps({
                        "level": label, "shape": [nF, side, side],
                        "radius": r, "dtype": dt, "form": form,
                        "route": cs.ROUTES[route], "call_ms": ms,
                        "eager_ms": host, "planned": cs.ROUTES[planned],
                        "coef_mb": taps * nF * nF * C.element_size() / 1e6,
                        "all_taps_mb": m * m * side * side * nF * nF
                        * C.element_size() / 1e6}), flush=True)
            del C, binv, b, x
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--problems", default="poisson2d,elasticity,quartic2d")
    ap.add_argument("--levels", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_smooth_routing.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    problems = [] if args.levels else args.problems.split(",")
    if args.levels:
        levels(dev)
    if "poisson2d" in problems:
        *_, solver, _ = cs.build_solver(cs.N_BG, dev)
        compare("poisson2d", lambda: solver.solve(rtol=1e-10), args.pairs)
        del solver
        torch.cuda.empty_cache()
    if "elasticity" in problems:
        _, _, A, b, _ = cs.build_elasticity(cs.N_BG_EL, dev)
        compare("elasticity", lambda: cs.el_solve(A, b, cs.N_BG_EL),
                args.pairs)
        del A, b
        torch.cuda.empty_cache()
    if "quartic2d" in problems:
        _, _, shape, A, b, _ = cs.build_biharmonic(cs.N_BG_QUARTIC, dev, 4)
        compare("quartic2d", lambda: cs.bh_solve(A, b, shape, radius=5),
                args.pairs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
