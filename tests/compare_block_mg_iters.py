"""Block-MG CG iteration counts of the elasticity workload (``bench.py
--workload elasticity``: the immersed square, n_fg = 2·n_bg, two fields;
with ``--dim 3`` the immersed cube, n_fg = 1.26·n_bg, three fields) at
several n_bg, through ``solve_ksp(method='cg', pc='mg', n_fields=dim,
rtol=1e-10)``:

* ``jax_f64`` / ``jax_mixed``: the JAX package on this host, the whole
  solve in f64, and the f32 MG-CG passes with f64 refinement (the route
  JAX takes on a TPU, here with exact f32 arithmetic);
* ``port_f64`` / ``port_mixed``: the port on the same numpy state (f64 is
  refused on CUDA, so ``port_f64`` runs on the CPU only);
* ``port_mixed_bf16``: the port's mixed route with the V-cycle's
  products in bf16, as a TPU computes f32 convolutions and matrix products
  at XLA's default precision (one bf16 pass, f32 accumulation) where the
  JAX package passes no ``precision``: the restriction and Galerkin RAP
  convolutions, the point-block smoother's contraction and the coarse
  pseudo-inverse's apply (JAX's ``_pinv`` itself asks for HIGHEST); 2D
  only.

    python3 tests/compare_block_mg_iters.py --n-bg 32,64,128
    python3 tests/compare_block_mg_iters.py --dim 3 --n-bg 8,16
    python3 tests/compare_block_mg_iters.py --n-bg 256,512 --device cuda \\
        --no-jax

Prints one JSON line per n_bg. Imports JAX only without ``--no-jax``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from iifea_tpu_torch.ops import multigrid as mg  # noqa: E402


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and back: an operand of one bf16 MXU pass."""
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


class _Bf16Block(mg.StencilMultigridBlock):
    """StencilMultigridBlock with the smoother's contraction and the coarse
    apply on bf16-rounded operands (the convolutions: ``_bf16_products``)."""

    def _smooth(self, lvl, x, b, sweeps, with_residual=False):
        S = self.levels[lvl]
        Binv = _bf16(self.binvs[lvl])
        if x is None:
            x = torch.zeros_like(b)
        for _ in range(sweeps):
            r = _bf16((b - S.mv(x)).reshape(1, S.n_fields, -1))
            x = x + self.omega * (Binv * r).sum(dim=1).reshape(-1)
        return (x, b - S.mv(x)) if with_residual else x

    def _vcycle(self, lvl, b):
        if lvl == len(self.levels) - 1 and self.coarse_inv is not None:
            return _bf16(self.coarse_inv) @ _bf16(b)
        return super()._vcycle(lvl, b)


@contextlib.contextmanager
def _bf16_products():
    conv2d, block = F.conv2d, mg.StencilMultigridBlock

    def conv2d_bf16(x, w, *a, **kw):
        return conv2d(_bf16(x), _bf16(w), *a, **kw)

    F.conv2d, mg.StencilMultigridBlock = conv2d_bf16, _Bf16Block
    try:
        yield
    finally:
        F.conv2d, mg.StencilMultigridBlock = conv2d, block


def _sizes(n_bg, dim):
    """(generator name, n_fg) of the workload."""
    if dim == 2:
        return "immersed_square_problem", 2 * n_bg
    return "immersed_cube_problem", int(n_bg * 1.26) // 2 * 2


def _port_system(n_bg, device, state=None, dim=2):
    from iifea_tpu_torch.convert import from_numpy_state
    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    if state is None:
        gen, n_fg = _sizes(n_bg, dim)
        mesh, M = getattr(generators, gen)(n_fg=n_fg, n_bg=n_bg,
                                           n_fields=dim, device=device)
    else:
        st = from_numpy_state(**state, device=device)
        mesh, M = st.mesh, st.M
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True, device=device)
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    A, b = assemble_background_system(prob.form, u0, M)
    return A, b


def _jax_system(n_bg, dim=2):
    import jax
    import jax.numpy as jnp

    from iifea_tpu.mesh import generators
    from iifea_tpu.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu.ops.projection import (
        BackgroundOperator,
        assemble_background_system,
    )

    gen, n_fg = _sizes(n_bg, dim)
    mesh, M = getattr(generators, gen)(n_fg=n_fg, n_bg=n_bg, n_fields=dim)
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True)
    A, b = jax.jit(lambda u: assemble_background_system(prob.form, u, M))(
        jnp.zeros(prob.form.n_dofs))
    state = dict(coords=mesh.coords, cells=mesh.cells,
                 material=mesh.material, idx=M.idx_np, val=M.val_np,
                 n_bg_dofs=M.n_bg_dofs)
    return BackgroundOperator(prob.form, A.blocks, M), b, state


def _run(solve, A, b, kw, mixed):
    t = time.perf_counter()
    _, info = solve(A, b, monitor=False, mixed=mixed, **kw)
    return {"iters": int(info.iters), "converged": bool(info.converged),
            "seconds": time.perf_counter() - t}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-bg", default="32,64,128")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args(argv)
    if not args.no_jax:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    mg.full_f32()
    for n_bg in (int(s) for s in args.n_bg.split(",")):
        dim = args.dim
        kw = dict(method="cg", pc="mg", rtol=1e-10, n_fields=dim,
                  lattice_shape=(n_bg + 1,) * dim)
        row = {"n_bg": n_bg, "dim": dim,
               "n_bg_dofs": dim * (n_bg + 1) ** dim, "device": args.device}
        state = None
        if not args.no_jax:
            A_j, b_j, state = _jax_system(n_bg, dim)
            row["jax_f64"] = _run(j_solve_ksp, A_j, b_j, kw, False)
            row["jax_mixed"] = _run(j_solve_ksp, A_j, b_j, kw, True)
            del A_j, b_j
        A, b = _port_system(n_bg, args.device, state, dim)
        if args.device == "cpu":
            row["port_f64"] = _run(solve_ksp, A, b, kw, False)
        row["port_mixed"] = _run(solve_ksp, A, b, kw, True)
        if dim == 2:
            with _bf16_products():
                row["port_mixed_bf16"] = _run(solve_ksp, A, b, kw, True)
        print(json.dumps(row), flush=True)
        del A, b
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
