"""Geometric multigrid on 2D stencil operators (port of the 2D Jacobi part
of ``iifea_tpu/ops/multigrid.py``).

* transfers: 3x3 full weighting with stride 2 (``F.conv2d``) and bilinear
  interpolation by interleaving, P = 4 Rᵀ, so the V-cycle is symmetric;
* coarse operators: the Galerkin product R A P computed directly as ONE
  strided convolution over the coefficient planes ((2r+1)² input and output
  channels, 3x3 window);
* smoothing: weighted Jacobi with fixed sweep counts (a linear, symmetric
  preconditioner, valid inside CG) on the fused ``jacobi_smooth`` kernel;
  the V-cycle residual uses the ``stencil_mv`` kernel;
* coarsest level: a dense Newton–Schulz pseudo-inverse.

Float32 convolutions and matrix products must run in full f32: TF32 keeps
about three digits, which would perturb the coarse operators at ~1e-3.
``BinnedLatticeSolver`` turns TF32 off; callers using this module directly
on a GPU must do the same.

Zero rows (background dofs without foreground support) get unit diagonal
guards; their components stay zero through the cycle.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from iifea_tpu_torch.ops.stencil import StencilOperator2D

_KERNEL = np.array(
    [[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]
)
_W1 = np.array([0.5, 1.0, 0.5])
DENSE_CAP = 4096    # largest coarsest level inverted densely


def _restrict(x2: torch.Tensor) -> torch.Tensor:
    """Full weighting: y[i,j] = (1/4) Σ k[a,b] x[2i+a-1, 2j+b-1]."""
    k = torch.as_tensor(_KERNEL / 4.0, dtype=x2.dtype, device=x2.device)
    return F.conv2d(x2[None, None], k[None, None], stride=2, padding=1)[0, 0]


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
    columns."""
    return _interleave(_interleave(xc2, 0), 1)


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


def _invd(S: StencilOperator2D) -> torch.Tensor:
    """Flat 1/diag with a unit guard on zero rows."""
    d = S.diag()
    return 1.0 / torch.where(d.abs() > 0, d, torch.ones_like(d))


def _dense_inverse(S: StencilOperator2D) -> torch.Tensor:
    """Soft-truncated pseudo-inverse of the coarsest operator.

    Galerkin coarse operators of the singular projected system can carry
    null directions that are not axis-aligned, so a plain inverse would be
    NaN there. Zero rows get unit diagonals first."""
    A = S.mv_ref(torch.eye(S.n, dtype=S.dtype, device=S.device)).T
    d = torch.diagonal(A)
    A = A + torch.diag((d.abs() == 0).to(A.dtype))
    return _pinv(A)


def _pinv(A: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Pseudo-inverse by Newton–Schulz iteration X ← X(2I − AX) from
    X₀ = Aᵀ/(‖A‖₁‖A‖∞): singular modes σ ≳ 2^{-iters/2}·σmax converge to
    1/σ, null modes never amplify past ~1/σmax (soft truncation)."""
    n1 = A.abs().sum(dim=0).max()
    ninf = A.abs().sum(dim=1).max()
    I2 = 2.0 * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    X = (1.0 / (n1 * ninf)) * A.T
    for _ in range(iters):
        X = X @ (I2 - A @ X)
    return X


class StencilMultigrid:
    """Symmetric V-cycle preconditioner for a StencilOperator2D.

    Coarsens while every side s has (s - 1) even and s > ``min_size``; the
    coarsest level is inverted densely when it has ≤ DENSE_CAP nodes, else
    smoothed ``coarse_sweeps`` times.
    """

    def __init__(self, S: StencilOperator2D, nu_pre: int = 2,
                 nu_post: int = 2, omega: float = 0.67,
                 coarse_sweeps: int = 60, min_size: int = 33):
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        shapes = [tuple(S.shape)]
        while all((s - 1) % 2 == 0 and s > min_size for s in shapes[-1]):
            shapes.append(tuple((s - 1) // 2 + 1 for s in shapes[-1]))
        self.levels = [S]
        for _ in shapes[1:]:
            self.levels.append(_coarsen(self.levels[-1]))
        self.inv_diags = [_invd(lv) for lv in self.levels]
        last = shapes[-1]
        self.coarse_inv = (
            _dense_inverse(self.levels[-1])
            if last[0] * last[1] <= DENSE_CAP else None
        )

    def _smooth(self, lvl: int, x, b, sweeps: int):
        S = self.levels[lvl]
        invd = self.inv_diags[lvl]
        for _ in range(sweeps):
            x = S.jacobi_smooth(invd, b, x, self.omega)
        return x

    def _vcycle(self, lvl: int, b):
        S = self.levels[lvl]
        if lvl == len(self.levels) - 1:
            if self.coarse_inv is not None:
                return self.coarse_inv @ b
            return self._smooth(lvl, torch.zeros_like(b), b,
                                self.coarse_sweeps)
        x = self._smooth(lvl, torch.zeros_like(b), b, self.nu_pre)
        r = b - S.mv(x)
        rc = _restrict(r.reshape(S.shape)).reshape(-1)
        xc = self._vcycle(lvl + 1, rc)
        x = x + _prolong(xc.reshape(self.levels[lvl + 1].shape)).reshape(-1)
        return self._smooth(lvl, x, b, self.nu_post)

    def minv(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)
