"""Row-block sharded geometric multigrid V-cycles (port of
``iifea_tpu/parallel/multigrid.py``), and the sharded MG-PCG refinement
of ``bench.py --devices N`` (``refine_sharded``).

Built from a single-device hierarchy (``StencilMultigrid``,
``StencilMultigrid3D``, ``StencilMultigridBlock``) with no re-probing and
no numerical change:

* levels with at least ``min_shard_rows`` rows (default max(4·ranks, 16),
  as in the JAX package) are row-block sharded, except a coarsest level
  inverted densely. Their row blocks are *nested*: balanced on the
  coarsest sharded level, and each finer level's boundary twice the
  coarser's, so restriction and prolongation need a one-row halo (the JAX
  package pads each level's rows separately and lets GSPMD move what the
  transfers need). Each smoothing pass is a halo exchange and one launch
  of the existing per-pass kernel on the extended slab (2D: the
  ``jacobi_smooth`` sweep, the ``stencil_mv_block`` residual; 3D:
  ``jacobi_smooth3`` or ``cheb_step3``, the ``residual3`` pass; the
  first step from zero reads no neighbour). A fused one-launch smoothing
  call cannot exchange halos between its passes, so it runs on the
  replicated levels only;
* the coarser levels are replicated: at the first of them the residual
  is gathered whole (one all-gather), and from there down the
  single-device cycle runs as it is, fused calls and the dense coarse
  inverse included; its correction is prolonged whole and each rank keeps
  its rows.

The sharded 2D Chebyshev smoother is the port's single-device one (the
interval [λ/4, λ] from each level's λmax), not the JAX package's sharded
cycle, which takes the 3D l1 interval for any hierarchy (ROADMAP §3 R1).
"""
from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from iifea_tpu_torch.ops import multigrid as mgm
from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.parallel.sharding import (
    DeviceMesh,
    even_bounds,
    nested_bounds,
)
from iifea_tpu_torch.parallel.stencil import RowBlock, ShardedStencil2D
from iifea_tpu_torch.solvers import krylov


def _restrict_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Full weighting of a row block x (nF, 2m+1, *rest) whose first and
    last rows are the neighbours' (or the lattice's zero halo): the
    single-device restriction with the row axis unpadded, (nF, m, ...)."""
    if dim == 2:
        k = torch.as_tensor(mgm._KERNEL / 4.0, dtype=x.dtype, device=x.device)
        y = F.conv2d(x.reshape(-1, 1, *x.shape[-2:]), k[None, None],
                     stride=2, padding=(0, 1))
    else:
        k = torch.as_tensor(mgm._KERNEL3 / 8.0, dtype=x.dtype,
                            device=x.device)
        y = F.conv3d(x.reshape(-1, 1, *x.shape[-3:]), k[None, None],
                     stride=2, padding=(0, 1, 1))
    return y.reshape(x.shape[0], *y.shape[-dim:])


def _prolong_rows(xc: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """Interpolation of a coarse row block xc (nF, m+1, *rest) that ends
    with the next rank's first row: the single-device interleaves (rows,
    then each further axis) kept to the fine block's ``rows``."""
    y = mgm._interleave(xc, -dim)[:, :rows]
    for axis in range(1 - dim, 0):
        y = mgm._interleave(y, axis)
    return y


def _on_device(mg, device, first: int):
    """A shallow copy of the hierarchy whose levels from ``first`` down
    (and their smoother planes, the coarse inverse) live on ``device``;
    the finer ones are dropped (the sharded cycle holds its own slabs)."""
    out = copy.copy(mg)
    out.levels = [None] * first + [
        type(S)(S.coeffs.to(device), S.shape, S.radius)
        for S in mg.levels[first:]]
    for name in ("inv_diags", "binvs"):
        if hasattr(mg, name):
            setattr(out, name, [None] * first + [
                t.to(device) for t in getattr(mg, name)[first:]])
    if mg.coarse_inv is not None:
        out.coarse_inv = mg.coarse_inv.to(device)
    return out


class _SlabLevel:
    """One sharded level on this rank: its row block, the extended slab
    of the operator (zero coefficients in the halo rows) and of its
    smoother diagonal or blocks."""

    def __init__(self, S, diag, bounds, mesh, n_fields):
        r = S.radius
        self.radius = r
        self.block = RowBlock(S.shape, n_fields, bounds, mesh, r)
        axis = 3 if n_fields > 1 else 1
        C = self.block.extend_planes(S.coeffs, axis, r)
        self.S = type(S)(C, self.block.ext_shape(r), r)
        if n_fields > 1:                    # nodal blocks (nF, nF, nn)
            planes = diag.reshape(n_fields, n_fields, *S.shape)
            self.diag = self.block.extend_planes(planes, 2, r).reshape(
                n_fields, n_fields, -1)
        else:
            self.diag = self.block.pad(self.block.take(diag), r)

    def ext(self, x):
        return self.block.extend(x, self.radius)

    def pad(self, x):
        return self.block.pad(x, self.radius)

    def inner(self, y):
        return self.block.interior(y, self.radius)


class _ShardedMGBase:
    """The V-cycle shared by the three classes."""

    dim: int

    def __init__(self, mg, mesh: DeviceMesh,
                 min_shard_rows: int | None = None):
        self.mg = mg
        self.mesh = mesh
        self.nu_pre, self.nu_post = mg.nu_pre, mg.nu_post
        self.omega = mg.omega
        self.coarse_sweeps = mg.coarse_sweeps
        if min_shard_rows is None:
            # each rank should own a few rows; below that the halo (2r
            # rows per exchange) rivals the local work
            min_shard_rows = max(4 * mesh.size, 16)
        levels = mg.levels
        self.n_fields = getattr(levels[0], "n_fields", 1)
        self.shapes = [tuple(S.shape) for S in levels]
        last = len(levels) - 1
        n = 0
        while (n <= last and self.shapes[n][0] >= min_shard_rows
               and not (n == last and mg.coarse_inv is not None)):
            n += 1
        self.n_sharded = n
        rows = [s[0] for s in self.shapes[:n]]
        self.bounds = nested_bounds(rows, mesh.size) if n else []
        self.bounds0 = (self.bounds[0] if n
                        else even_bounds(self.shapes[0][0], mesh.size))
        diags = getattr(mg, "binvs", None) or mg.inv_diags
        self.slabs = [_SlabLevel(levels[l], diags[l], self.bounds[l], mesh,
                                 self.n_fields) for l in range(n)]
        self.block0 = (self.slabs[0].block if n else
                       RowBlock(self.shapes[0], self.n_fields, self.bounds0,
                                mesh, 0))
        dev = levels[0].coeffs.device
        self.rep = (mg if n > last or dev == mesh.device
                    else _on_device(mg, mesh.device, n))

    # -- the transfers ----------------------------------------------------------

    def _restrict_slab(self, lvl: int, r):
        """This rank's coarse rows of the restricted residual (the next
        level is sharded): one one-row halo exchange."""
        fine = self.slabs[lvl].block
        m = self.slabs[lvl + 1].block.rows
        ext = self.mesh.halo(fine.planes(r), 1)[:, :2 * m + 1]
        return _restrict_rows(ext, self.dim).reshape(-1)

    def _prolong_slab(self, lvl: int, xc):
        """This rank's fine rows of the prolonged correction (the coarse
        level is sharded): one one-row halo exchange."""
        coarse = self.slabs[lvl + 1].block
        ext = self.mesh.halo(coarse.planes(xc), 1)[:, 1:]
        rows = self.slabs[lvl].block.rows
        return _prolong_rows(ext, rows, self.dim).reshape(-1)

    def _restrict_full(self, r):
        """The single-device restriction of a whole level's (nF, *shape)
        planes."""
        return (mgm._restrict(r) if self.dim == 2
                else mgm._restrict3(r)).reshape(-1)

    def _prolong_full(self, xc):
        return (mgm._prolong(xc) if self.dim == 2
                else mgm._prolong3(xc)).reshape(-1)

    # -- the cycle -----------------------------------------------------------

    def _coarse(self, lvl: int, b):
        """The replicated cycle from level ``lvl`` (the single-device code)
        on a whole level's right-hand side."""
        return self.rep._vcycle(lvl, b)

    def _vcycle(self, lvl: int, b):
        """The V-cycle on a sharded level's row block."""
        last = len(self.shapes) - 1
        if lvl == last:                     # a sharded coarsest level
            return self._smooth(lvl, None, b, self.coarse_sweeps)
        x, r = self._smooth(lvl, None, b, self.nu_pre, with_residual=True)
        nF = self.n_fields
        if lvl + 1 < self.n_sharded:
            xc = self._vcycle(lvl + 1, self._restrict_slab(lvl, r))
            x = x + self._prolong_slab(lvl, xc)
        else:
            block = self.slabs[lvl].block
            r_full = block.gather(r).reshape(nF, *self.shapes[lvl])
            xc = self._coarse(lvl + 1, self._restrict_full(r_full))
            xf = self._prolong_full(xc.reshape(nF, *self.shapes[lvl + 1]))
            x = x + block.take(xf)
        return self._smooth(lvl, x, b, self.nu_post)

    # -- public interfaces ---------------------------------------------------------

    def minv_local(self, r: torch.Tensor) -> torch.Tensor:
        """The V-cycle on this rank's rows of the finest level (the
        preconditioner of the sharded CG; the JAX package's
        ``minv_padded``). Rows are split by ``bounds0``."""
        if self.n_sharded:
            return self._vcycle(0, r)
        return self.block0.take(self._coarse(0, self.block0.gather(r)))

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        """Flat-vector interface (matches the single-device ``minv``):
        shard, cycle, gather."""
        return self.block0.gather(self.minv_local(self.block0.take(r)))


class ShardedMultigrid2D(_ShardedMGBase):
    """Sharded V-cycle over a StencilMultigrid (2D) hierarchy: weighted
    Jacobi, or the port's Chebyshev smoother."""

    dim = 2

    def __init__(self, mg, mesh: DeviceMesh,
                 min_shard_rows: int | None = None):
        self.smoother = getattr(mg, "smoother", "jacobi")
        if self.smoother not in ("jacobi", "chebyshev"):
            raise NotImplementedError(
                f"sharded V-cycle: unsupported smoother {self.smoother!r}")
        super().__init__(mg, mesh, min_shard_rows)

    def _residual(self, sl: _SlabLevel, b_ext, x):
        """b − A x on the row block: one halo exchange, one residual launch
        (a zero-sweep smoothing call: ``stencil_mv_block`` on a card)."""
        return sl.inner(sl.S.smooth(sl.diag, b_ext, sl.ext(x), self.omega, 0,
                                    with_residual=True)[1])

    def _smooth(self, lvl: int, x, b, sweeps: int,
                with_residual: bool = False):
        """``sweeps`` sweeps on a sharded level from x (None: from zero),
        one launch each on the extended slab after a halo exchange (the
        sweep from zero needs none); with ``with_residual`` also
        b − A x_ν."""
        sl = self.slabs[lvl]
        b_ext = sl.pad(b)
        if self.smoother == "chebyshev":
            x = self._smooth_cheb(lvl, sl, torch.zeros_like(b) if x is None
                                  else x, b_ext, sweeps)
        else:
            for _ in range(sweeps):
                x_ext = None if x is None else sl.ext(x)
                x = sl.inner(sl.S.smooth(sl.diag, b_ext, x_ext, self.omega,
                                         1))
            if x is None:
                x = torch.zeros_like(b)
        if with_residual:
            return x, self._residual(sl, b_ext, x)
        return x

    def _smooth_cheb(self, lvl, sl, x, b_ext, sweeps):
        """``StencilMultigrid._smooth_cheb`` on the row block."""
        if sweeps <= 0:
            return x
        invd = sl.inner(sl.diag)
        hi = 1.05 * self.mg.lmaxs[lvl]
        lo = hi / 4.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = invd * self._residual(sl, b_ext, x) / theta
        x = x + d
        for _ in range(sweeps - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = invd * self._residual(sl, b_ext, x)
            d = rho_new * (2.0 * r / delta + rho * d)
            x = x + d
            rho = rho_new
        return x


class ShardedMultigridBlock2D(ShardedMultigrid2D):
    """Sharded V-cycle over a StencilMultigridBlock hierarchy (vector
    fields): one halo exchange carries every field's rows; ω-weighted
    point-block Jacobi sweeps on the (nF, nF) nodal blocks, one
    ``jacobi_smooth`` launch each, ``stencil_mv_block`` residuals."""


class ShardedMultigrid3D(_ShardedMGBase):
    """Sharded V-cycle over a StencilMultigrid3D hierarchy (x-slab
    blocks): Chebyshev on the l1-Jacobi scaling (``cheb_step3`` a step),
    or weighted l1-Jacobi (``jacobi_smooth3``); ``residual3`` residuals."""

    dim = 3

    def __init__(self, mg, mesh: DeviceMesh,
                 min_shard_rows: int | None = None):
        self.smoother = mg.smoother
        super().__init__(mg, mesh, min_shard_rows)

    def _step(self, sl: _SlabLevel, b_ext, x, d, s0, s1):
        """One smoothing step on the row block from x (halo exchange, one
        launch); returns (x', d') (d' None for sweeps)."""
        S = sl.S
        x_ext = sl.ext(x)
        if self.smoother == "jacobi":
            return sl.inner(S.jacobi_smooth(sl.diag, b_ext, x_ext, s0)), None
        step = sk.cheb_step3 if S._kernels() else sk.cheb_step3_plain
        x_ext, d_ext = step(S.coeffs, sl.diag, b_ext, x_ext,
                            None if d is None else sl.pad(d), s0, s1,
                            S.shape, S.radius)
        return sl.inner(x_ext), sl.inner(d_ext)

    def _smooth(self, lvl: int, x, b, sweeps: int,
                with_residual: bool = False):
        """``StencilMultigrid3D._smooth`` on a sharded level: the steps of
        ``mg._steps`` one launch each (the first from zero is the sweep
        ω·invd·b, which reads no neighbour), then b − A x_ν where asked."""
        sl = self.slabs[lvl]
        b_ext = sl.pad(b)
        cheb = self.smoother == "chebyshev"
        steps = self.mg._steps(sweeps)
        d = None
        if x is None:
            if steps:
                x = sl.inner(sl.S.smooth(sl.diag, b_ext, None, steps[:1],
                                         cheb=cheb))
                d, steps = (x if cheb else None), steps[1:]
            else:
                x = torch.zeros_like(b)
        for s0, s1 in steps:
            x, d = self._step(sl, b_ext, x, d, s0, s1)
        if with_residual:
            return x, sl.inner(sl.S.smooth(sl.diag, b_ext, sl.ext(x), [],
                                           with_residual=True)[1])
        return x


def refine_sharded(mesh: DeviceMesh, solver, S32, mg, bound, b64,
                   rtol: float):
    """``bench.py --devices N``'s solve (``run_sharded``) on this rank:
    the 2D solver's f64 refinement (``BinnedLatticeSolver.refine``) with
    its f32 MG-PCG row-block sharded end to end: the fine apply on the
    extended slab, the sharded V-cycle, every dot and norm summed over
    the ranks (``krylov.cg``'s ``dot`` hook). The f64 residual is measured
    whole on every rank, as in the JAX package. Returns refine's (x64,
    relres, CG iterations)."""
    smg = ShardedMultigrid2D(mg, mesh)
    Ssh = ShardedStencil2D(S32, mesh, bounds=smg.bounds0)

    def cg_fn(_S32, _mg, r32, rtol_pass):
        dx, info = krylov.cg(Ssh.mv2, Ssh.shard_vec(r32),
                             minv=smg.minv_local, rtol=rtol_pass,
                             atol=1e-30, max_it=500, check_every=4,
                             dot=mesh.dot)
        return Ssh.unshard_vec(dx).to(r32.device), info

    return solver.refine(S32, mg, bound, b64, rtol, cg_fn=cg_fn)
