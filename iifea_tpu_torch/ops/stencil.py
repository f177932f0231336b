"""Stencil-form background operators (port of ``iifea_tpu/ops/stencil.py``).

On a lattice background the projected operator A_b = Mᵀ A_f M couples each
node only to nodes within a (2r+1)^dim offset window, so in 2D

    y[i,j] = Σ_{|oi|,|oj| <= r}  C[k][i,j] * x[i+oi, j+oj],
    k = (oi+r)·m + (oj+r),  m = 2r+1,

with node id = i·ny1 + j (``mesh.generators.rectangle_mesh``'s layout), and
in 3D k = ((oi+r)·m + (oj+r))·m + (ok+r) with node id (i·ny1 + j)·nz1 + k
(``box_mesh``'s layout). The coefficient planes are stored as logical
``(m^dim, *shape)`` contiguous tensors; the TPU tile padding of the
reference has no counterpart here.

f32 applies and sweeps go through the hand-written kernels of
``ops/stencil_kernels.py``; other dtypes (the f64 checks) use the plain
shifted-slice form ``mv_ref``.
"""
from __future__ import annotations

import torch

from iifea_tpu_torch.ops import stencil_kernels as sk


class StencilOperator2D:
    """A_b in variable-coefficient stencil form on an (nx1, ny1) lattice."""

    def __init__(self, coeffs: torch.Tensor, shape: tuple[int, int],
                 radius: int):
        self.shape = tuple(int(s) for s in shape)
        self.radius = int(radius)
        m = 2 * self.radius + 1
        if tuple(coeffs.shape) != (m * m, *self.shape):
            raise ValueError(
                f"coefficients {tuple(coeffs.shape)} do not match "
                f"{(m * m, *self.shape)}"
            )
        self.coeffs = coeffs.contiguous()
        self.n = self.shape[0] * self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, dtype: torch.dtype) -> "StencilOperator2D":
        return StencilOperator2D(self.coeffs.to(dtype), self.shape,
                                 self.radius)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A_b x: the stencil_mv kernel for f32, ``mv_ref`` otherwise."""
        if self.coeffs.dtype == torch.float32:
            return sk.stencil_mv(self.coeffs, x, self.shape, self.radius)
        return self.mv_ref(x)

    def mv_ref(self, x: torch.Tensor) -> torch.Tensor:
        """Plain shifted-slice apply; x may be batched (..., n)."""
        return sk.stencil_mv_plain(self.coeffs, x, self.shape, self.radius)

    def jacobi_smooth(self, invd: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor, omega: float) -> torch.Tensor:
        """One weighted-Jacobi sweep x + ω·invd·(b − A x); fused kernel for
        f32. ``invd`` and ``b`` are flat (n,) vectors."""
        if self.coeffs.dtype == torch.float32:
            return sk.jacobi_smooth(self.coeffs, invd, b, x, omega,
                                    self.shape, self.radius)
        return sk.jacobi_smooth_plain(self.coeffs, invd, b, x, omega,
                                      self.shape, self.radius)

    def diag(self) -> torch.Tensor:
        m = 2 * self.radius + 1
        return self.coeffs[self.radius * m + self.radius].reshape(-1)


class StencilOperator3D:
    """A_b in variable-coefficient stencil form on an (nx1, ny1, nz1)
    lattice."""

    def __init__(self, coeffs: torch.Tensor, shape, radius: int):
        self.shape = tuple(int(s) for s in shape)
        self.radius = int(radius)
        m = 2 * self.radius + 1
        if tuple(coeffs.shape) != (m ** 3, *self.shape):
            raise ValueError(
                f"coefficients {tuple(coeffs.shape)} do not match "
                f"{(m ** 3, *self.shape)}"
            )
        self.coeffs = coeffs.contiguous()
        self.n = self.shape[0] * self.shape[1] * self.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, dtype: torch.dtype) -> "StencilOperator3D":
        return StencilOperator3D(self.coeffs.to(dtype), self.shape,
                                 self.radius)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A_b x: the stencil_mv3 kernel for f32, ``mv_ref`` otherwise."""
        if self.coeffs.dtype == torch.float32:
            return sk.stencil_mv3(self.coeffs, x, self.shape, self.radius)
        return self.mv_ref(x)

    def mv_ref(self, x: torch.Tensor) -> torch.Tensor:
        """Plain shifted-slice apply; x may be batched (..., n)."""
        return sk.stencil_mv3_plain(self.coeffs, x, self.shape, self.radius)

    def jacobi_smooth(self, invd: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor, omega: float) -> torch.Tensor:
        """One weighted-Jacobi sweep x + ω·invd·(b − A x); fused kernel for
        f32."""
        if self.coeffs.dtype == torch.float32:
            return sk.jacobi_smooth3(self.coeffs, invd, b, x, omega,
                                     self.shape, self.radius)
        return sk.jacobi_smooth3_plain(self.coeffs, invd, b, x, omega,
                                       self.shape, self.radius)

    def cheb_sweep(self, invd: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor, d: torch.Tensor | None, alpha: float,
                   beta: float):
        """One Chebyshev step r = invd·(b − A x), d' = α·r + β·d,
        x' = x + d' (d None on the first step); fused kernel for f32.
        Returns (x', d')."""
        if self.coeffs.dtype == torch.float32:
            return sk.cheb_step3(self.coeffs, invd, b, x, d, alpha, beta,
                                 self.shape, self.radius)
        return sk.cheb_step3_plain(self.coeffs, invd, b, x, d, alpha, beta,
                                   self.shape, self.radius)

    def diag(self) -> torch.Tensor:
        r = self.radius
        m = 2 * r + 1
        return self.coeffs[(r * m + r) * m + r].reshape(-1)
