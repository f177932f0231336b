"""Geometric multigrid on 2D and 3D stencil operators and on 2D and 3D
block (multi-field) stencil operators (port of ``StencilMultigrid``,
``StencilMultigrid3D``, ``StencilMultigridBlock`` and
``StencilMultigridBlock3D`` in ``iifea_tpu/ops/multigrid.py``).

* transfers: full weighting with stride 2 (``F.conv2d``/``F.conv3d``) and
  bi/trilinear interpolation by interleaving, P = 2^dim Rᵀ, so the V-cycle
  is symmetric;
* coarse operators: the Galerkin product R A P computed directly as ONE
  strided convolution over the coefficient planes ((2r+1)^dim input and
  output channels, 3^dim window);
* smoothing, 2D: weighted Jacobi with fixed sweep counts (a linear,
  symmetric preconditioner, valid inside CG); block: ω = 1 point-block
  Jacobi on the l1-regularised nodal (nF×nF) blocks. Both through the
  ``smooth`` kernel entry (3D: ``smooth3``): per level, the pre-smoothing
  from zero and the residual handed to the coarser level are one call, the
  post-smoothing one call, each one launch on the small lattices and one
  launch per pass on the large ones. 3D scalar: Chebyshev on the l1-Jacobi
  scaling over the fixed interval [1.05/α, 1.05], through the same
  ``smooth3`` calls (the steps' coefficients fixed per hierarchy). The
  other smoother of each
  scalar class is an option: ``StencilMultigrid(smoother='chebyshev')``
  (interval from a power-iteration λmax per level) and
  ``StencilMultigrid3D(smoother='jacobi', omega=…)``;
* coarsest level: a dense Newton–Schulz pseudo-inverse, iterated in f64
  and cast to the operator's dtype (a warning when it is too large to
  form, since Jacobi sweeps leave the V-cycle weak on low frequencies).

Float32 convolutions and matrix products must run in full f32: TF32 keeps
about three digits, which would perturb the coarse operators at ~1e-3.
``full_f32()`` turns TF32 off; ``BinnedLatticeSolver`` and ``solve_ksp``
call it, and callers using this module directly on a GPU must too.

Zero rows (background dofs without foreground support) get unit diagonal
guards; their components stay zero through the cycle.
"""
from __future__ import annotations

import itertools
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from iifea_tpu_torch.ops import stencil_kernels as sk
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
    StencilOperatorBlock3D,
)

_KERNEL = np.array(
    [[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]
)
_W1 = np.array([0.5, 1.0, 0.5])
_KERNEL3 = _W1[:, None, None] * _W1[None, :, None] * _W1[None, None, :]
DENSE_CAP = 4096    # largest 2D coarsest level inverted densely
DENSE_CAP3 = 8192   # largest 3D coarsest level inverted densely
DENSE_CAP_BLOCK = 8192   # largest block coarsest level (dofs, all fields)


def full_f32() -> None:
    """Run f32 convolutions (restriction, Galerkin RAP) and matrix products
    (coarse pseudo-inverse) in full f32, not TF32 (cuDNN's default for
    convolutions): its ~3 digits would perturb the coarse operators at
    ~1e-3 and drift the CG iteration count. Process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _warn_weak_coarse(shape, possible: bool) -> None:
    """Warn when the hierarchy bottoms out too large for a dense coarsest
    level: the coarsening halves a side s only while (s − 1) is even, so a
    side that is not 2^k·m + 1 with a small odd m stops early, and sweeps
    on a large coarsest level leave the V-cycle weak on low frequencies."""
    if not possible:
        warnings.warn(
            f"multigrid: the coarsest level {tuple(shape)} exceeds the "
            "dense-inverse cap; the V-cycle will be weak on low frequencies. "
            "Choose the lattice so every side coarsens to O(10): side = "
            "2^k·m + 1 with a small odd m.", stacklevel=3)


def _restrict(x2: torch.Tensor) -> torch.Tensor:
    """Full weighting: y[i,j] = (1/4) Σ k[a,b] x[2i+a-1, 2j+b-1]; x2 may
    carry leading batch dims (..., nx, ny)."""
    k = torch.as_tensor(_KERNEL / 4.0, dtype=x2.dtype, device=x2.device)
    y = F.conv2d(x2.reshape(-1, 1, *x2.shape[-2:]), k[None, None], stride=2,
                 padding=1)
    return y.reshape(*x2.shape[:-2], *y.shape[-2:])


def _interleave(a: torch.Tensor, dim: int) -> torch.Tensor:
    """(.., m, ..) -> (.., 2m-1, ..): values interleaved with midpoints."""
    a = a.movedim(dim, 0)
    m = a.shape[0]
    mid = 0.5 * (a[:-1] + a[1:])
    body = torch.stack([a[:-1], mid], dim=1).reshape(2 * (m - 1),
                                                     *a.shape[1:])
    return torch.cat([body, a[-1:]], dim=0).movedim(0, dim)


def _prolong(xc2: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation (P = 4 Rᵀ): separable interleave, rows then
    columns; xc2 may carry leading batch dims (..., nx, ny)."""
    return _interleave(_interleave(xc2, -2), -1)


def _restrict3(x3: torch.Tensor) -> torch.Tensor:
    """3D full weighting: trilinear kernel / 8, stride 2; x3 may carry
    leading batch dims (..., nx, ny, nz)."""
    k = torch.as_tensor(_KERNEL3 / 8.0, dtype=x3.dtype, device=x3.device)
    y = F.conv3d(x3.reshape(-1, 1, *x3.shape[-3:]), k[None, None], stride=2,
                 padding=1)
    return y.reshape(*x3.shape[:-3], *y.shape[-3:])


def _prolong3(xc3: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation (P = 8 Rᵀ): separable interleave per axis;
    xc3 may carry leading batch dims (..., nx, ny, nz)."""
    return _interleave(_interleave(_interleave(xc3, -3), -2), -1)


# -- direct Galerkin composition ------------------------------------------------
#
# For stencil A (y[p] = Σ_d C[d,p] x[p+d]), full weighting R (weights
# w[u]/4 on u ∈ {-1,0,1}²) and P = 4 Rᵀ, with f = 2I+u and g = f+d,
#
#   (R A P)[I, I+T] = (1/4) Σ_{u,d} w[u] w[u+d-2T] C[d, 2I+u]
#
# where v = u+d-2T must lie in {-1,0,1}². For fixed (T, d) the sum over u is
# a 3x3 kernel applied to plane C[d] at stride 2: the whole RAP is one
# strided convolution from the (2r+1)² fine planes to the (2r+1)² coarse
# planes.


def _rap_k1(radius: int) -> np.ndarray:
    """Per-dimension factor k1[t+r, d+r, u+1] = w[u] · w[u+d-2t]."""
    r = radius
    m = 2 * r + 1
    k1 = np.zeros((m, m, 3))
    for t in range(-r, r + 1):
        for dk in range(-r, r + 1):
            for u in (-1, 0, 1):
                v = u + dk - 2 * t
                if -1 <= v <= 1:
                    k1[t + r, dk + r, u + 1] = _W1[u + 1] * _W1[v + 1]
    return k1


def _rap_kernel2(radius: int) -> np.ndarray:
    """(m², m², 3, 3) (out, in, kh, kw) conv kernel of the 2D direct RAP."""
    k1 = _rap_k1(radius)
    m = 2 * radius + 1
    K = 0.25 * np.einsum("adu,bev->abdeuv", k1, k1)
    return np.ascontiguousarray(K.reshape(m * m, m * m, 3, 3))


def _rap_kernel3(radius: int) -> np.ndarray:
    """(m³, m³, 3, 3, 3) (out, in, kd, kh, kw) conv kernel of the 3D direct
    RAP."""
    k1 = _rap_k1(radius)
    m = 2 * radius + 1
    K = 0.125 * np.einsum("adu,bev,cfw->abcdefuvw", k1, k1, k1)
    return np.ascontiguousarray(K.reshape(m ** 3, m ** 3, 3, 3, 3))


def _masked_coeffs2(fine: StencilOperator2D) -> torch.Tensor:
    """Coefficients with off-grid taps zeroed: the zero-padded apply never
    reads them, but the direct RAP does."""
    r = fine.radius
    dev = fine.device

    def axis(n):
        i = torch.arange(n, device=dev)
        return [(i + o >= 0) & (i + o < n) for o in range(-r, r + 1)]

    mx, my = axis(fine.shape[0]), axis(fine.shape[1])
    m = 2 * r + 1
    mask = torch.stack([
        mx[a][:, None] & my[b][None, :] for a in range(m) for b in range(m)
    ]).to(fine.dtype)
    return fine.coeffs * mask


def _coarsen(fine: StencilOperator2D) -> StencilOperator2D:
    """Direct Galerkin coarse operator: one strided conv over the planes."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    K = torch.as_tensor(_rap_kernel2(fine.radius), dtype=fine.dtype,
                        device=fine.device)
    y = F.conv2d(_masked_coeffs2(fine)[None], K, stride=2, padding=1)
    return StencilOperator2D(y[0], cshape, fine.radius)


def _tap_mask3(fine) -> torch.Tensor:
    """(m³, *shape) mask of the in-grid taps of a 3D (scalar or block)
    operator; separable."""
    r = fine.radius
    dev = fine.device

    def axis(n):
        i = torch.arange(n, device=dev)
        return [(i + o >= 0) & (i + o < n) for o in range(-r, r + 1)]

    mx, my, mz = (axis(s) for s in fine.shape)
    m = 2 * r + 1
    return torch.stack([
        mx[a][:, None, None] & my[b][None, :, None] & mz[c][None, None, :]
        for a in range(m) for b in range(m) for c in range(m)
    ]).to(fine.dtype)


def _masked_coeffs3(fine) -> torch.Tensor:
    """3D counterpart of ``_masked_coeffs2``, for a scalar or a block
    operator (the mask broadcasts over the nF² blocks)."""
    return fine.coeffs * _tap_mask3(fine)


def _coarsen3(fine: StencilOperator3D) -> StencilOperator3D:
    """3D direct Galerkin coarse operator: one strided conv3d over the
    coefficient planes ((2r+1)³ channels in and out, 3³ window, stride 2).
    The JAX package's in-channel chunking (a 16 GB TPU workaround) is not
    needed on an 80 GB card."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    K = torch.as_tensor(_rap_kernel3(fine.radius), dtype=fine.dtype,
                        device=fine.device)
    y = F.conv3d(_masked_coeffs3(fine)[None], K, stride=2, padding=1)
    return StencilOperator3D(y[0], cshape, fine.radius)


def _invd3_l1(S: StencilOperator3D) -> torch.Tensor:
    """1 / ℓ1 row sums, the l1-Jacobi smoother diagonal (unit guard on zero
    rows). For SPD A, λ(D_l1⁻¹A) ∈ [0, 1], so the smoother is stable on
    sliver-cut stencils where plain weighted Jacobi diverges. Row i's
    entries are exactly coeffs[:, i]."""
    d = S.coeffs.abs().sum(dim=0).reshape(-1)
    return 1.0 / torch.where(d > 0, d, torch.ones_like(d))


def _dense(S) -> torch.Tensor:
    """A stencil operator (scalar or block, 2D or 3D) as a dense matrix,
    read off its planes: row (f1, p), column (f2, p + o) holds the plane of
    tap o, fields (f1, f2), at p, for p + o on the lattice. That is what S
    applied to the unit vectors gives (``S.mv_ref(I).T``: one product by 1
    among exact zeros), without the n applies."""
    C = S.coeffs
    if C.dim() == len(S.shape) + 1:                     # scalar planes
        C = C[None, None]
    nF, nn, r = C.shape[0], math.prod(S.shape), S.radius
    node = torch.arange(nn, device=S.device).reshape(S.shape)
    A = torch.zeros((nF * nn, nF * nn), dtype=S.dtype, device=S.device)
    taps = itertools.product(range(-r, r + 1), repeat=len(S.shape))
    for t, off in enumerate(taps):
        at = tuple(slice(max(0, -o), s - max(0, o))
                   for o, s in zip(off, S.shape))
        to = tuple(slice(max(0, o), s - max(0, -o))
                   for o, s in zip(off, S.shape))
        p, q = node[at].reshape(-1), node[to].reshape(-1)
        for f1 in range(nF):
            for f2 in range(nF):
                A[f1 * nn + p, f2 * nn + q] = C[f1, f2, t][at].reshape(-1)
    return A


def _dense_inverse3(S: StencilOperator3D) -> torch.Tensor:
    """Soft-truncated pseudo-inverse of the coarsest 3D operator; see
    ``_dense_inverse``."""
    A = _dense(S)
    d = torch.diagonal(A)
    A = A + torch.diag((d.abs() == 0).to(A.dtype))
    return _pinv(A)


def _invd(S: StencilOperator2D) -> torch.Tensor:
    """Flat 1/diag with a unit guard on zero rows."""
    d = S.diag()
    return 1.0 / torch.where(d.abs() > 0, d, torch.ones_like(d))


def _dense_inverse(S: StencilOperator2D) -> torch.Tensor:
    """Soft-truncated pseudo-inverse of the coarsest operator.

    Galerkin coarse operators of the singular projected system can carry
    null directions that are not axis-aligned, so a plain inverse would be
    NaN there. Zero rows get unit diagonals first."""
    A = _dense(S)
    d = torch.diagonal(A)
    A = A + torch.diag((d.abs() == 0).to(A.dtype))
    return _pinv(A)


# Newton–Schulz steps by the operator's dtype: k steps resolve singular values
# σ ≳ 2^(−k/2)·σmax and leave smaller ones soft. 50 (the reference's count)
# for f64; 44 for f32, which puts the transition at ~2^−22·σmax, four times
# the f32 rounding of σmax: what an f32 operator carries below it is noise.
PINV_STEPS = {torch.float64: 50, torch.float32: 44}


def _pinv(A: torch.Tensor, iters: int | None = None,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Pseudo-inverse by Newton–Schulz iteration X ← X(2I − AX) from
    X₀ = Aᵀ/(‖A‖₁‖A‖∞): singular modes σ ≳ 2^{-iters/2}·σmax converge to
    1/σ, null modes never amplify past ~1/σmax (soft truncation).
    ``iters`` defaults to ``PINV_STEPS`` of A's dtype.

    Iterated in ``dtype`` (f64) whatever A's dtype and cast back, so a card
    and the host form the same inverse. Why both: a cut lattice's coarse
    operator can carry a near-null pair (3D n_bg=8: σ = 3e-10 against
    σmax = 2.2). 50 steps leave it half inverted (max|X| ~1e5 where the
    resolved modes need 477), in f32 arithmetic differently on every device
    (‖X₃₂ − X₆₄‖ = 4–6·‖X₆₄‖), and on a single-level hierarchy, where this
    inverse is the whole preconditioner, the f32 CG then runs its
    chunked-check iterations on amplified rounding noise: 32 iterations on
    one host, ~900 on a card (``tests/compare_coarse_pinv.py``).

    A row and column that couple to nothing but their own diagonal (a
    lattice node outside the cut domain: 1,236 of the 2,187 coarse dofs of
    3D elasticity at n_bg=8) stay decoupled under the iteration, so they
    iterate as scalars and only the coupled block as a matrix: the same
    steps from the same X₀, without the products' exact zeros."""
    out_dtype = A.dtype
    if iters is None:
        iters = PINV_STEPS[out_dtype]
    A = A.to(dtype)
    n1 = A.abs().sum(dim=0).max()
    ninf = A.abs().sum(dim=1).max()
    scale = 1.0 / (n1 * ninf)
    d = torch.diagonal(A)
    off = A.abs() - torch.diag(d.abs())
    lone = (off.sum(dim=0) == 0) & (off.sum(dim=1) == 0)
    keep = torch.nonzero(~lone).flatten()
    Ak = A[keep][:, keep]
    I2 = 2.0 * torch.eye(len(keep), dtype=A.dtype, device=A.device)
    Xk = scale * Ak.T
    dl = d[lone]
    xl = scale * dl
    for _ in range(iters):
        Xk = Xk @ (I2 - Ak @ Xk)
        xl = xl * (2.0 - dl * xl)
    X = torch.diag(torch.zeros_like(d).masked_scatter(lone, xl))
    X[keep[:, None], keep[None, :]] = Xk
    return X.to(out_dtype)


def _residual2(S: StencilOperator2D, b, x):
    """b − A x on scalar 2D planes: one launch of the block kernel's
    residual pass on a card (f32 or f64) and its plain version for f32 on
    the CPU, the plain version otherwise."""
    if S.device.type == "cuda" or S.dtype == torch.float32:
        return sk.stencil_mv_block(S.coeffs, x, S.shape, S.radius, b=b)
    return sk.residual_plain(S.coeffs, b, x, S.shape, S.radius)


def _lmax_jacobi(S: StencilOperator2D, invd: torch.Tensor,
                 iters: int = 14) -> float:
    """Spectral radius estimate of the Jacobi-preconditioned operator D⁻¹A
    by power iteration from a deterministic start; feeds the Chebyshev
    smoother's interval (the 1.05 safety factor at the use site absorbs an
    underestimate)."""
    x = 1.0 + 0.3 * torch.cos(torch.arange(S.n, dtype=S.dtype,
                                           device=S.device))
    for _ in range(iters):
        y = invd * S.mv(x)
        x = y / torch.linalg.vector_norm(y)
    return float(torch.linalg.vector_norm(invd * S.mv(x)))


class StencilMultigrid:
    """Symmetric V-cycle preconditioner for a StencilOperator2D.

    Coarsens while every side s has (s - 1) even and s > ``min_size``; the
    coarsest level is inverted densely when it has ≤ DENSE_CAP nodes, else
    smoothed ``coarse_sweeps`` times. ``smoother``: 'jacobi' (ω-weighted,
    the default) or 'chebyshev' (on D⁻¹A over [λ/4, λ], λ = 1.05·λmax from
    ``_lmax_jacobi`` per level; one residual launch and elementwise
    updates per step).
    """

    def __init__(self, S: StencilOperator2D, nu_pre: int = 2,
                 nu_post: int = 2, omega: float = 0.67,
                 coarse_sweeps: int = 60, min_size: int = 33,
                 smoother: str = "jacobi"):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', "
                             f"got {smoother!r}")
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.smoother = smoother
        shapes = [tuple(S.shape)]
        while all((s - 1) % 2 == 0 and s > min_size for s in shapes[-1]):
            shapes.append(tuple((s - 1) // 2 + 1 for s in shapes[-1]))
        self.levels = [S]
        for _ in shapes[1:]:
            self.levels.append(_coarsen(self.levels[-1]))
        self.inv_diags = [_invd(lv) for lv in self.levels]
        self.lmaxs = ([_lmax_jacobi(lv, d)
                       for lv, d in zip(self.levels, self.inv_diags)]
                      if smoother == "chebyshev" else None)
        dense_ok = self.levels[-1].n <= DENSE_CAP
        _warn_weak_coarse(shapes[-1], dense_ok)
        self.coarse_inv = _dense_inverse(self.levels[-1]) if dense_ok else None

    def _smooth(self, lvl: int, x, b, sweeps: int,
                with_residual: bool = False):
        """``sweeps`` sweeps on level ``lvl`` from x (None: from zero) in
        one smoothing call; with ``with_residual`` also b − A x_ν."""
        if self.smoother == "chebyshev":
            x = self._smooth_cheb(lvl, torch.zeros_like(b) if x is None
                                  else x, b, sweeps)
            if with_residual:
                return x, _residual2(self.levels[lvl], b, x)
            return x
        return self.levels[lvl].smooth(self.inv_diags[lvl], b, x, self.omega,
                                       sweeps, with_residual)

    def _smooth_cheb(self, lvl: int, x, b, sweeps: int):
        """``sweeps`` Chebyshev steps on the Jacobi-preconditioned operator
        over [λ/4, λ], λ = 1.05·λmax: fixed coefficients, so a linear,
        D-symmetric smoother, valid inside CG."""
        if sweeps <= 0:
            return x
        S = self.levels[lvl]
        invd = self.inv_diags[lvl]
        hi = 1.05 * self.lmaxs[lvl]
        lo = hi / 4.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = invd * _residual2(S, b, x) / theta
        x = x + d
        for _ in range(sweeps - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = invd * _residual2(S, b, x)
            d = rho_new * (2.0 * r / delta + rho * d)
            x = x + d
            rho = rho_new
        return x

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return self.coarse_inv @ b
            return self._smooth(lvl, None, b, self.coarse_sweeps)
        x, r = self._smooth(lvl, None, b, self.nu_pre, with_residual=True)
        rc = _restrict(r.reshape(S.shape)).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        x = x + _prolong(xc.reshape(self.levels[lvl + 1].shape)).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)


def chebyshev_steps(sweeps: int, cheb_alpha: float, hi: float = 1.05):
    """The (s0, s1) of ``sweeps`` Chebyshev steps on [hi/α, hi]: (1/θ, 0),
    then (2ρ'/δ, ρ'ρ) with ρ' = 1/(2σ − ρ), σ = θ/δ, ρ₀ = 1/σ. From x = 0
    the first step is the weighted-Jacobi sweep with ω = 1/θ and the
    direction d its result."""
    lo = hi / cheb_alpha
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = [(1.0 / theta, 0.0)] if sweeps > 0 else []
    for _ in range(sweeps - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((2.0 * rho_new / delta, rho_new * rho))
        rho = rho_new
    return steps


class StencilMultigrid3D:
    """Symmetric V-cycle preconditioner for a StencilOperator3D.

    Coarsens while every side s has (s - 1) even and s > ``min_size``
    (105 → 53 → 27 → 14 at n_bg=104); the coarsest level is inverted
    densely when it has ≤ DENSE_CAP3 nodes, else smoothed
    ``coarse_sweeps`` times. Smoothing (``smoother='chebyshev'``, the
    default) is Chebyshev on the l1-Jacobi scaled operator over the fixed
    interval [CHEB_HI/``cheb_alpha``, CHEB_HI]: the l1 scaling bounds the
    spectrum by 1, so no eigenvalue estimate is needed and the smoother
    stays stable on sliver-cut stencils, where plain weighted Jacobi
    diverges. ``smoother='jacobi'`` runs ``omega``-weighted l1-Jacobi
    sweeps instead. Either way a level's pre-smoothing with its residual,
    and its post-smoothing, are one ``smooth3`` call each.
    """

    CHEB_HI = 1.05

    def __init__(self, S: StencilOperator3D, nu_pre: int = 2,
                 nu_post: int = 2, omega: float = 1.0,
                 coarse_sweeps: int = 60, min_size: int = 9,
                 smoother: str = "chebyshev", cheb_alpha: float = 8.0):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', "
                             f"got {smoother!r}")
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.smoother = smoother
        self.cheb_alpha = cheb_alpha
        self.levels = [S]
        while all((s - 1) % 2 == 0 and s > min_size
                  for s in self.levels[-1].shape):
            self.levels.append(_coarsen3(self.levels[-1]))
        self.inv_diags = [_invd3_l1(lv) for lv in self.levels]
        dense_ok = self.levels[-1].n <= DENSE_CAP3
        _warn_weak_coarse(self.levels[-1].shape, dense_ok)
        self.coarse_inv = (_dense_inverse3(self.levels[-1]) if dense_ok
                           else None)

    def _steps(self, sweeps: int):
        """The (s0, s1) of ``sweeps`` smoothing steps: ω for the Jacobi
        sweeps, else ``chebyshev_steps``."""
        if self.smoother == "jacobi":
            return [(self.omega, 0.0)] * sweeps
        return chebyshev_steps(sweeps, self.cheb_alpha, self.CHEB_HI)

    def _smooth(self, lvl: int, x, b, sweeps: int, x_zero: bool = False,
                with_residual: bool = False):
        """``sweeps`` smoothing steps on level ``lvl`` (Chebyshev, or
        ω-weighted l1-Jacobi sweeps) from x, or from zero when ``x_zero``
        (the pre-smoother's start; x is then not read), in one smoothing
        call; with ``with_residual`` also b − A x_ν."""
        if sweeps <= 0 and not with_residual:
            return torch.zeros_like(b) if x_zero else x
        return self.levels[lvl].smooth(
            self.inv_diags[lvl], b, None if x_zero else x,
            self._steps(sweeps), with_residual,
            cheb=self.smoother == "chebyshev")

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return self.coarse_inv @ b
            return self._smooth(lvl, None, b, self.coarse_sweeps,
                                x_zero=True)
        x, r = self._smooth(lvl, None, b, self.nu_pre, x_zero=True,
                            with_residual=True)
        rc = _restrict3(r.reshape(S.shape)).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        x = x + _prolong3(xc.reshape(self.levels[lvl + 1].shape)).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)


# -- block (multi-field) hierarchy ----------------------------------------------


def _coarsen_block(fine: StencilOperatorBlock2D) -> StencilOperatorBlock2D:
    """Direct block Galerkin coarse operator: the per-field transfers act
    alike on every (f1, f2) block, so the scalar RAP conv (``_coarsen``)
    runs once over the nF² blocks as a batch."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields
    m2 = (2 * fine.radius + 1) ** 2
    K = torch.as_tensor(_rap_kernel2(fine.radius), dtype=fine.dtype,
                        device=fine.device)
    C = _masked_coeffs2(fine).reshape(nF * nF, m2, *fine.shape)
    y = F.conv2d(C, K, stride=2, padding=1)
    return StencilOperatorBlock2D(y.reshape(nF, nF, m2, *cshape), cshape,
                                  fine.radius)


def _adjugate_inv(Bn: torch.Tensor):
    """Closed-form (cofactor) inverses of (n, k, k) blocks, k ≤ 3. Returns
    (inverse, determinant); a zero determinant gives non-finite entries."""
    k = Bn.shape[-1]
    if k == 1:
        det = Bn[:, 0, 0]
        return (1.0 / det)[:, None, None], det
    if k == 2:
        a, b = Bn[:, 0, 0], Bn[:, 0, 1]
        c, d = Bn[:, 1, 0], Bn[:, 1, 1]
        det = a * d - b * c
        adj = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return adj / det[:, None, None], det
    if k == 3:
        B = Bn
        c00 = B[:, 1, 1] * B[:, 2, 2] - B[:, 1, 2] * B[:, 2, 1]
        c01 = B[:, 1, 2] * B[:, 2, 0] - B[:, 1, 0] * B[:, 2, 2]
        c02 = B[:, 1, 0] * B[:, 2, 1] - B[:, 1, 1] * B[:, 2, 0]
        c10 = B[:, 0, 2] * B[:, 2, 1] - B[:, 0, 1] * B[:, 2, 2]
        c11 = B[:, 0, 0] * B[:, 2, 2] - B[:, 0, 2] * B[:, 2, 0]
        c12 = B[:, 0, 1] * B[:, 2, 0] - B[:, 0, 0] * B[:, 2, 1]
        c20 = B[:, 0, 1] * B[:, 1, 2] - B[:, 0, 2] * B[:, 1, 1]
        c21 = B[:, 0, 2] * B[:, 1, 0] - B[:, 0, 0] * B[:, 1, 2]
        c22 = B[:, 0, 0] * B[:, 1, 1] - B[:, 0, 1] * B[:, 1, 0]
        det = B[:, 0, 0] * c00 + B[:, 0, 1] * c01 + B[:, 0, 2] * c02
        adj = torch.stack([torch.stack([c00, c10, c20], -1),
                           torch.stack([c01, c11, c21], -1),
                           torch.stack([c02, c12, c22], -1)], -2)
        return adj / det[:, None, None], det
    raise NotImplementedError(f"closed-form inverse for k <= 3, got {k}")


def _point_binv(S: StencilOperatorBlock2D) -> torch.Tensor:
    """(nF, nF, nn) inverses of the l1-regularised nodal blocks
    B_i + diag(Σ |off-block row entries|), the block analog of the l1-Jacobi
    diagonal (λ(D⁻¹A) ≤ 1 for SPD A, so ω = 1 sweeps contract); identity on
    singular blocks (unsupported nodes)."""
    B = S.point_block_diag()                                  # (nF, nF, nn)
    nF, nn = B.shape[0], B.shape[-1]
    l1_off = (S.coeffs.abs().sum(dim=(1, 2)).reshape(nF, nn)
              - B.abs().sum(dim=1))
    eye = torch.eye(nF, dtype=B.dtype, device=B.device)
    inv, det = _adjugate_inv((B + eye[:, :, None] * l1_off[:, None, :])
                             .permute(2, 0, 1))
    ok = (det.abs() > 1e-30)[:, None, None]
    return torch.where(ok, inv, eye[None]).permute(1, 2, 0).contiguous()


def _dense_inverse_block(S: StencilOperatorBlock2D) -> torch.Tensor:
    """Soft-truncated pseudo-inverse of the coarsest block operator; see
    ``_dense_inverse``."""
    A = _dense(S)
    d = torch.diagonal(A)
    A = A + torch.diag((d.abs() == 0).to(A.dtype))
    return _pinv(A)


def _coarsen_block3(fine: StencilOperatorBlock3D) -> StencilOperatorBlock3D:
    """Direct 3D block Galerkin coarse operator: the scalar RAP conv
    (``_coarsen3``) over the nF² coefficient blocks, one block a call (a
    block of 125 planes of 97³ is 0.46 GB; masking and convolving all nine
    at once would hold another copy of the whole operator)."""
    cshape = tuple((s - 1) // 2 + 1 for s in fine.shape)
    nF = fine.n_fields
    K = torch.as_tensor(_rap_kernel3(fine.radius), dtype=fine.dtype,
                        device=fine.device)
    mask = _tap_mask3(fine)
    y = torch.empty((nF, nF, K.shape[0], *cshape), dtype=fine.dtype,
                    device=fine.device)
    for f1 in range(nF):
        for f2 in range(nF):
            y[f1, f2] = F.conv3d((fine.coeffs[f1, f2] * mask)[None], K,
                                 stride=2, padding=1)[0]
    return StencilOperatorBlock3D(y, cshape, fine.radius)


class StencilMultigridBlock:
    """Symmetric V-cycle preconditioner for a StencilOperatorBlock2D:
    per-field full-weighting/bilinear transfers, the batched direct RAP,
    ω-weighted point-block Jacobi on the l1-regularised nodal blocks, and a
    dense pseudo-inverse on the coarsest level when it has ≤
    DENSE_CAP_BLOCK dofs (else ``coarse_sweeps`` sweeps). Coarsens while
    every side s has (s − 1) even and s > ``min_size``
    (513 → 257 → … → 17 → 9 at n_bg=512)."""

    _coarsen = staticmethod(_coarsen_block)
    _restrict = staticmethod(_restrict)
    _prolong = staticmethod(_prolong)

    def __init__(self, S: StencilOperatorBlock2D, nu_pre: int = 2,
                 nu_post: int = 2, omega: float = 1.0,
                 coarse_sweeps: int = 60, min_size: int = 9):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.levels = [S]
        while all((s - 1) % 2 == 0 and s > min_size
                  for s in self.levels[-1].shape):
            self.levels.append(self._coarsen(self.levels[-1]))
        self.binvs = [_point_binv(lv) for lv in self.levels]
        dense_ok = self.levels[-1].n <= DENSE_CAP_BLOCK
        _warn_weak_coarse(self.levels[-1].shape, dense_ok)
        self.coarse_inv = (_dense_inverse_block(self.levels[-1]) if dense_ok
                           else None)

    def _smooth(self, lvl: int, x, b, sweeps: int,
                with_residual: bool = False):
        """``sweeps`` point-block sweeps on level ``lvl`` from x (None: from
        zero) in one smoothing call; with ``with_residual`` also
        b − A x_ν."""
        return self.levels[lvl].smooth(self.binvs[lvl], b, x, self.omega,
                                       sweeps, with_residual)

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        nF = S.n_fields
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return self.coarse_inv @ b
            return self._smooth(lvl, None, b, self.coarse_sweeps)
        x, r = self._smooth(lvl, None, b, self.nu_pre, with_residual=True)
        r = r.reshape(nF, *S.shape)
        xc = self._vcycle(lvl + 1, self._restrict(r).reshape(-1))
        xc = xc.reshape(nF, *self.levels[lvl + 1].shape)
        x = x + self._prolong(xc).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)


class StencilMultigridBlock3D(StencilMultigridBlock):
    """``StencilMultigridBlock`` for a StencilOperatorBlock3D: the same
    cycle (ν = 2 + 2, ω = 1 point-block Jacobi on the l1-regularised nodal
    blocks, dense pseudo-inverse for ≤ DENSE_CAP_BLOCK dofs) with
    per-field trilinear transfers and the 3D direct RAP
    (97 → 49 → 25 → 13 → 7 at n_bg=96, the 3 × 7³ level dense). On a card
    a smoothing call is one ``smooth3`` launch on the small levels and one
    ``stencil3d_block`` launch a pass on the large ones."""

    _coarsen = staticmethod(_coarsen_block3)
    _restrict = staticmethod(_restrict3)
    _prolong = staticmethod(_prolong3)
