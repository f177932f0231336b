#!/usr/bin/env python3
"""The quartic 2D biharmonic's MG-GMRES in both packages on the CPU: the
JAX witness of the port's iteration counts at radius 5.

    JAX_PLATFORMS=cpu python3 tests/compare_quartic_jax.py 13 29 61

For each n_bg (a (n_bg + 4)² quartic net, n_fg = 2 n_bg, ``bg_degree=4``,
``BiharmonicProblem`` as ``chip_smoke.py`` builds it) it assembles the
system in both packages, takes the planes of JAX's operator by the
121-colour probe (``test_torch_quartic._probe_planes``: JAX's own
``from_probe_y`` compiles one slice at a time, minutes at 121 colours),
runs JAX's ``_run_stencil_krylov`` on them (its ``solve_ksp(gmres,
pc='mg')`` after the probe, the f64 route a CPU takes) and the port's
``solve_ksp(gmres, pc='mg', stencil_radius=5)``, each to a relative
residual of 1e-10, and prints one JSON line a size: both iteration counts,
true relative residuals, error norms and the planes' difference.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from iifea_tpu.mesh.generators import (  # noqa: E402
    immersed_square_bspline_problem as j_bspline_square,
)
from iifea_tpu.models.biharmonic import (  # noqa: E402
    BiharmonicProblem as JBiharmonic,
)
from iifea_tpu.ops import multigrid as jmg  # noqa: E402
from iifea_tpu.ops.projection import (  # noqa: E402
    BackgroundOperator as JBackgroundOperator,
)
from iifea_tpu.ops.projection import (  # noqa: E402
    assemble_background_system as j_assemble,
)
from iifea_tpu.ops.stencil import StencilOperator2D as JStencil2  # noqa: E402
from iifea_tpu.solvers import ksp as jksp  # noqa: E402
from iifea_tpu_torch.mesh.generators import (  # noqa: E402
    immersed_square_bspline_problem,
)
from iifea_tpu_torch.models.biharmonic import BiharmonicProblem  # noqa: E402
from iifea_tpu_torch.ops.projection import (  # noqa: E402
    assemble_background_system,
)
from iifea_tpu_torch.solvers import ksp as tksp  # noqa: E402
from test_torch_quartic import _probe_planes  # noqa: E402

R = 5
KW = dict(sym=False, beta_value=5.0, alpha_value=5.0, filter_tol=1e-5)


def compare(n_bg: int) -> dict:
    t0 = time.perf_counter()
    mesh_j, M_j, shape = j_bspline_square(n_fg=2 * n_bg, n_bg=n_bg,
                                          bg_degree=4)
    prob_j = JBiharmonic(mesh_j, **KW)
    form_j = prob_j.form
    A, b_j = jax.jit(lambda u: j_assemble(form_j, u, M_j))(
        jnp.zeros(form_j.n_dofs))
    A_j = JBackgroundOperator(form_j, A.blocks, M_j)
    shape = tuple(shape)
    C_j = _probe_planes(A_j, shape)
    S_j = JStencil2(jnp.asarray(C_j), shape, R)
    mg_j = jmg.StencilMultigrid(S_j)
    x_j, info_j = jksp._run_stencil_krylov(
        S_j, mg_j, None, b_j, jnp.zeros_like(b_j), jnp.asarray(1e-10),
        jnp.asarray(0.0), "gmres", 10000, 300)
    res_j = float(jnp.linalg.norm(b_j - A_j.mv(x_j)) / jnp.linalg.norm(b_j))
    t_j = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh, M, _ = immersed_square_bspline_problem(
        n_fg=2 * n_bg, n_bg=n_bg, bg_degree=4, device="cpu")
    prob = BiharmonicProblem(mesh, device="cpu", **KW)
    A_t, b_t = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    S = tksp._probe_general(A_t, shape, R, torch.float64)
    x, info = tksp.solve_ksp(A_t, b_t, method="gmres", pc="mg", rtol=1e-10,
                             atol=0.0, lattice_shape=shape,
                             stencil_radius=R, monitor=False)
    res = float(torch.linalg.vector_norm(b_t - A_t.mv(x))
                / torch.linalg.vector_norm(b_t))
    norms, norms_j = prob.error_norms(M.mv(x)), prob_j.error_norms(
        M_j.mv(x_j))
    return {"n_bg": n_bg, "lattice": list(shape),
            "levels": [list(lv.shape) for lv in mg_j.levels],
            "planes_rel_diff": float(np.abs(S.coeffs.numpy() - C_j).max()
                                     / np.abs(C_j).max()),
            "iters_jax": int(info_j.iters), "iters_port": int(info.iters),
            "rel_residual_jax": res_j, "rel_residual_port": res,
            "L2_rel_jax": float(norms_j["L2_rel"]),
            "L2_rel_port": norms["L2_rel"],
            "seconds_jax": t_j, "seconds_port": time.perf_counter() - t0}


def main() -> None:
    for n_bg in [int(a) for a in sys.argv[1:]] or [13, 29]:
        print(json.dumps(compare(n_bg)), flush=True)


if __name__ == "__main__":
    main()
