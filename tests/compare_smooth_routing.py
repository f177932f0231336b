"""Warm solve seconds of the port's two 2D multigrid main paths on a card,
with the V-cycle's smoothing calls routed as the kernel library plans them
(one cooperative launch per call on the levels whose tiles are co-resident)
and with every call forced to one launch per pass, in turns within one
process (planned, per pass, per pass, planned, ...):

* ``poisson2d``: ``BinnedLatticeSolver.solve(rtol=1e-10)`` at n_bg=1024;
* ``elasticity``: ``solve_ksp(cg, pc='mg', n_fields=2)`` at n_bg=512.

    python3 tests/compare_smooth_routing.py [--pairs 6]

Prints one JSON line per problem: the seconds of every warm solve by
routing, their medians, the stencil launches of one solve by routing, and
then the card's name and power limit. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_smooth_routing.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    *_, solver, _ = cs.build_solver(cs.N_BG, dev)
    compare("poisson2d", lambda: solver.solve(rtol=1e-10), args.pairs)
    del solver
    torch.cuda.empty_cache()
    _, _, A, b, _ = cs.build_elasticity(cs.N_BG_EL, dev)
    compare("elasticity", lambda: cs.el_solve(A, b, cs.N_BG_EL), args.pairs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
