#!/usr/bin/env python3
"""Run-to-run determinism of the Taylor-Green ref-7 cell's first linear
solve on the card (ROADMAP §3 P5).

The cell is ``demos/tg_vortex.py --ref 7 --T 0.008 --pc mg --pin-pressure
True`` (3 × 513² background dofs). The script sets it up once, then
repeats the first Newton iteration of the first time step: the jacfwd
assembly, the projected rhs b = Mᵀ(−R), the block probe of Mᵀ A_f M into
stencil planes and the MG-GMRES solve. Each repeat prints the GMRES
iterations and a digest of every intermediate (element blocks, foreground
residual, b, the planes, the solution), so bitwise equality across repeats
is read off the digests. Before that, the pressure pin is chosen
repeatedly on the same state, and the first solve is run with each pressure
dof whose diagonal ties with the largest. After the repeats, in the same
process, the solve is crossed:
the planes of one repeat with the rhs of another, to tell which input moves
the iteration count. Last, the elasticity n_bg=512 operator is probed
twice and its planes compared.

    python3 tests/compare_determinism.py                  # default mode
    python3 tests/compare_determinism.py --deterministic  # torch's
        # use_deterministic_algorithms(True, warn_only=True)
    python3 tests/compare_determinism.py --both           # each twice, in
        # processes of their own, default first
    python3 tests/compare_determinism.py --probes         # every front-end
        # path's probe (chip_smoke.py's sizes): the fixed-order sums against
        # the earlier index_add_ scatters, in turns

One JSON object per line; needs a card.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

REPEATS = 3
PIN_REPEATS = 5
N_BG_EL = 512
DEVICE = "cuda"


def digest(t) -> str:
    import torch

    if isinstance(t, (list, tuple)):
        h = hashlib.sha1()
        for x in t:
            h.update(digest(x).encode())
        return h.hexdigest()[:12]
    if not isinstance(t, torch.Tensor):
        t = t.coeffs
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def out(**kv):
    print(json.dumps(kv), flush=True)


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def solve_with(A, b, shape, S=None):
    """The demo's linear solve (``solve_nonlinear``'s defaults; mixed, as
    on a card by default); with S,
    the probe returns those planes instead of probing."""
    from iifea_tpu_torch.solvers import ksp

    probe = ksp._probe_block
    if S is not None:
        ksp._probe_block = lambda *a, **k: S
    try:
        return ksp.solve_ksp(A, b, method="gmres", pc="mg", rtol=1e-8,
                             atol=1e-9, lattice_shape=shape, n_fields=3,
                             monitor=False, mixed=True)
    finally:
        ksp._probe_block = probe


def pin_study(prob, M, up_p, up_f, shape, t, mode):
    """The pressure pin (``tg_vortex.pressure_pin``: the pressure dof of
    largest diagonal) chosen PIN_REPEATS times on one state, the pressure
    dofs whose diagonal lies within 1e-12 of that largest, and the first
    solve's GMRES iterations with each of the first three of them pinned."""
    import numpy as np

    import chip_smoke as cs
    from iifea_tpu_torch.demos import tg_vortex
    from iifea_tpu_torch.ops.projection import BackgroundOperator

    pins = [int(tg_vortex.pressure_pin(prob, M, up_f, up_f)[0])
            for _ in range(PIN_REPEATS)]
    blocks0 = prob.form.jacobian_blocks(up_f, {"up_old": up_f}, {"t": 0.0})
    d = BackgroundOperator(prob.form, blocks0, M).diag().cpu().numpy()
    nn = M.n_bg_dofs // 3
    dp = d[2 * nn:]
    tied = (2 * nn + np.flatnonzero(dp >= dp.max() * (1 - 1e-12))).tolist()
    iters = {}
    for dof in tied[:3]:
        A, b, _, _ = cs.tg_first_system(prob, M, up_p, up_f,
                                        np.array([dof]), t)
        iters[dof] = int(solve_with(A, b, shape)[1].iters)
    out(case="taylor_green_ref7_pin", mode=mode, state=digest(up_f),
        pins=pins, tied=tied, gmres_iters_by_pin=iters)


def run(mode: str):
    import torch

    import chip_smoke as cs
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import ksp

    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    if DEVICE == "cuda":
        sk.build()
    prob, M, up_p, up_f, zero_ids, shape, t = cs.tg_cell(DEVICE)
    pin_study(prob, M, up_p, up_f, shape, t, mode)
    reps = []
    for rep in range(REPEATS):
        A, b, blocks, res = cs.tg_first_system(prob, M, up_p, up_f,
                                               zero_ids, t)
        t0 = sync()
        S = ksp._probe_block(A, shape, 3, 2, torch.float32)
        t_probe = sync() - t0
        x, info = solve_with(A, b, shape, S)
        reps.append((A, b, S))
        out(case="taylor_green_ref7", mode=mode, repeat=rep,
            gmres_iters=int(info.iters), converged=bool(info.converged),
            probe_seconds=t_probe, blocks=digest(blocks), residual=digest(res),
            rhs=digest(b), planes=digest(S), solution=digest(x))
    # crossed inputs: which of (planes, rhs) moves the count
    for i, j in ((0, 0), (0, 1), (1, 0)):
        A, b, _ = reps[i]
        _, info = solve_with(A, b, shape, reps[j][2])
        out(case="taylor_green_ref7_crossed", mode=mode, rhs_of=i,
            planes_of=j, gmres_iters=int(info.iters))
    del reps, A, b, S, prob, M

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    mesh, M = immersed_square_problem(n_fg=2 * N_BG_EL, n_bg=N_BG_EL,
                                      n_fields=2, device=DEVICE)
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True, device=DEVICE)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=DEVICE), M)
    rows = []
    for rep in range(2):
        t0 = sync()
        S = ksp._probe_block(A, (N_BG_EL + 1,) * 2, 2, 2, torch.float32)
        rows.append((digest(S), sync() - t0))
    out(case="elasticity_512_probe", mode=mode,
        planes=[r[0] for r in rows], probe_seconds=[r[1] for r in rows],
        bitwise_equal=rows[0][0] == rows[1][0])


def mv_multi_index_add(A, X):
    """``BackgroundOperator.mv_multi`` as it was before the fixed-order sums:
    the element scatter onto foreground dofs and Mᵀ both by ``index_add_``."""
    import torch

    rows, idx, val, _ = A.support()
    k = X.shape[0]
    U = torch.zeros((k, A.form.n_dofs), dtype=X.dtype, device=X.device)
    U[:, rows] = (val[None] * X[:, idx]).sum(dim=1)
    Y = torch.zeros_like(U)
    for (dom, _), K in zip(A.form.terms, A.blocks):
        ye = torch.einsum("abE,kbE->kaE", K, U[:, dom.eldofsT])
        Y.index_add_(1, dom.eldofsT.reshape(-1), ye.reshape(k, -1))
    data = (val[None] * Y[:, rows][:, None, :]).reshape(k, -1)
    out = torch.zeros((k, A.n), dtype=X.dtype, device=X.device)
    out.index_add_(1, idx.reshape(-1), data)
    if A.shift is not None:
        out = out + A.shift[None, :] * X
    if A.trim_mask is not None:
        out = torch.where(A.trim_mask[None, :], X, out)
    return out


def probe_chunk_index_add(A, dtype):
    """The probe's column chunk as it was before (no padded gathers)."""
    import torch

    from iifea_tpu_torch.solvers import ksp

    per_col, n_temps = 0, 4
    for dom, _ in A.form.terms:
        ne, nE = dom.eldofsT.shape
        if ne * nE > per_col:
            per_col, n_temps = ne * nE, ne + 3
    words = max(n_temps * per_col, 2 * A.support()[2].numel())
    item = torch.empty((), dtype=dtype).element_size()
    return max(int(ksp.PROBE_BUDGET_BYTES // (words * item)), 1)


def probe_paths():
    """(name, operator, probe call) of every front-end path with a probe,
    at its chip_smoke.py size; built one at a time."""
    import torch

    import chip_smoke as cs
    from iifea_tpu_torch.solvers import ksp

    prob, M, up_p, up_f, zero_ids, shape, t = cs.tg_cell(DEVICE)
    A = cs.tg_first_system(prob, M, up_p, up_f, zero_ids, t)[0]
    yield "taylor_green_ref7", A, lambda: ksp._probe_block(
        A, shape, 3, 2, torch.float32)
    del prob, M, A
    _, _, A, _, _ = cs.build_elasticity(cs.N_BG_EL, DEVICE)
    yield "elasticity_512", A, lambda: ksp._probe_block(
        A, (cs.N_BG_EL + 1,) * 2, 2, 2, torch.float32)
    del A
    _, _, A, _, _ = cs.build_elasticity(cs.N_BG_EL3, DEVICE, dim=3)
    yield "elasticity3_96", A, lambda: ksp._probe_block(
        A, (cs.N_BG_EL3 + 1,) * 3, 3, 2, torch.float32)
    del A
    _, _, shape2, A, _, _ = cs.build_biharmonic(cs.N_BG_BH, DEVICE)
    yield "biharmonic_511", A, lambda: ksp._probe_general(
        A, shape2, 3, torch.float64)
    del A
    _, _, shape3, A, *_ = cs.build_biharmonic3(cs.N_BG_BH3, DEVICE)
    yield "biharmonic3_63", A, lambda: ksp._probe_general(
        A, shape3, 3, torch.float64)


def probes():
    """Each path's probe by the fixed-order sums ("segment") and by the
    earlier ``index_add_`` form, in turns (segment, index_add, index_add,
    segment), seconds each; the planes' largest difference between the
    two forms relative to their largest entry."""
    import torch

    from iifea_tpu_torch.solvers import ksp

    for name, A, probe in probe_paths():
        def index_add():
            A.mv_multi = lambda X: mv_multi_index_add(A, X)
            chunk, ksp._probe_chunk = ksp._probe_chunk, probe_chunk_index_add
            try:
                return probe()
            finally:
                ksp._probe_chunk = chunk
                del A.mv_multi

        probe()                                       # support, warm-up
        times, planes = {"segment": [], "index_add": []}, {}
        for form in ("segment", "index_add", "index_add", "segment"):
            t0 = sync()
            S = probe() if form == "segment" else index_add()
            times[form].append(sync() - t0)
            planes[form] = S.coeffs.double()
        diff = float((planes["segment"] - planes["index_add"]).abs().max()
                     / planes["index_add"].abs().max())
        out(case="probe_seconds", path=name, segment=times["segment"],
            index_add=times["index_add"], planes_rel_diff=diff)
        del A, probe, S, planes
        torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    if args == ["--both"]:
        rc = 0
        for extra in ([], [], ["--deterministic"], ["--deterministic"]):
            rc |= subprocess.call([sys.executable, os.path.abspath(__file__),
                                   *extra])
        sys.exit(rc)
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_determinism.py needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out(device=smi, torch=torch.__version__)
    if args == ["--probes"]:
        from iifea_tpu_torch.ops import stencil_kernels as sk

        sk.build()
        probes()
    else:
        run("deterministic" if args == ["--deterministic"] else "default")


if __name__ == "__main__":
    main()
