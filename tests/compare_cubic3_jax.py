#!/usr/bin/env python3
"""The 3D cubic biharmonic's multigrid and MG-GMRES in the JAX package and
in the port, on the CPU, from the same problem.

    JAX_PLATFORMS=cpu python3 tests/compare_cubic3_jax.py N_BG MAX_IT [solve]

builds ``immersed_cube_bspline_problem(n_fg=2·N_BG, n_bg=N_BG,
bg_degree=3)`` with ``BiharmonicProblem`` in both packages, probes the
radius-4 planes and builds ``StencilMultigrid3D`` in each, and prints one
JSON line of max-abs relative differences (b, the planes, each Galerkin
coarse level, the dense coarse pseudo-inverse, one V-cycle on b). With
``solve``, each package's ``solve_ksp(gmres, pc='mg', stencil_radius=4,
rtol=1e-10, max_it=MAX_IT)``: iterations, converged, the true relative
residual, seconds and error norms, one line each. N_BG = 6 (a 9³ net, one
dense level) takes about a minute; 14 (17³, two levels) about ten minutes
of set-up before its solves.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from iifea_tpu.mesh.generators import immersed_cube_bspline_problem as jc
    from iifea_tpu.models.biharmonic import BiharmonicProblem as JB
    from iifea_tpu.ops import multigrid as jmg
    from iifea_tpu.ops.projection import BackgroundOperator as JBO
    from iifea_tpu.ops.projection import assemble_background_system as jasm
    from iifea_tpu.solvers import ksp as jksp
    from iifea_tpu_torch.mesh.generators import immersed_cube_bspline_problem
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops import multigrid as tmg
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import ksp as tksp

    n_bg, max_it = int(sys.argv[1]), int(sys.argv[2])
    do_solve = sys.argv[3:4] == ["solve"]
    mj, Mj, shape = jc(n_fg=2 * n_bg, n_bg=n_bg, bg_degree=3)
    pj = JB(mj)
    fj = pj.form
    A, bj = jax.jit(lambda u: jasm(fj, u, Mj))(jnp.zeros(fj.n_dofs))
    Aj = JBO(fj, A.blocks, Mj)
    Sj = jksp._probe_general(Aj, tuple(shape), 4, "float64",
                             jksp._probe_chunk(Aj, np.dtype(np.float64)))
    mgj = jmg.StencilMultigrid3D(Sj)
    zj = jax.jit(mgj.minv)(bj)
    m, M, sh = immersed_cube_bspline_problem(n_fg=2 * n_bg, n_bg=n_bg,
                                             bg_degree=3, device="cpu")
    p = BiharmonicProblem(m, device="cpu")
    At, bt = assemble_background_system(
        p.form, torch.zeros(p.space.n_dofs, dtype=torch.float64), M)
    St = tksp._probe_general(At, tuple(sh), 4, torch.float64)
    mgt = tmg.StencilMultigrid3D(St)
    zt = mgt.minv(bt)
    out = {"n_bg": n_bg, "b": rel(bt, bj), "planes": rel(St.coeffs, Sj.coeffs),
           "levels": [list(lv.shape) for lv in mgt.levels]}
    for i in range(1, len(mgt.levels)):
        out[f"rap{i}"] = rel(mgt.levels[i].coeffs, mgj.levels[i].coeffs)
    if mgj.coarse_inv is not None:
        out["coarse_inv"] = rel(mgt.coarse_inv, mgj.coarse_inv)
    out["minv"] = rel(zt, zj)
    print(json.dumps(out), flush=True)
    if not do_solve:
        return
    kw = dict(method="gmres", pc="mg", rtol=1e-10, lattice_shape=tuple(shape),
              stencil_radius=4, monitor=False, max_it=max_it)
    t = time.time()
    xj, ij = jksp.solve_ksp(Aj, bj, **kw)
    xj.block_until_ready()
    dt = time.time() - t
    rj = float(jnp.linalg.norm(bj - Aj.mv(xj)) / jnp.linalg.norm(bj))
    print(json.dumps({
        "package": "jax", "iters": int(ij.iters),
        "converged": bool(ij.converged), "rel_residual": rj, "seconds": dt,
        "error_norms": {k: float(v)
                        for k, v in pj.error_norms(Mj.mv(xj)).items()}}),
          flush=True)
    t = time.time()
    xt, it = tksp.solve_ksp(At, bt, **kw)
    dt = time.time() - t
    rt = float(torch.linalg.vector_norm(bt - At.mv(xt))
               / torch.linalg.vector_norm(bt))
    print(json.dumps({
        "package": "port", "iters": int(it.iters),
        "converged": bool(it.converged), "rel_residual": rt, "seconds": dt,
        "error_norms": p.error_norms(M.mv(xt)),
        "x_rel_diff_jax": rel(xt, xj)}), flush=True)


if __name__ == "__main__":
    main()
