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
``ops/stencil_kernels.py`` (a block apply is one launch, a level's
smoothing call one launch on the small 2D lattices, a 3D block sweep one
launch); other dtypes (the f64
checks) use the plain shifted-slice form ``mv_ref``.

``probe_multi`` extracts the planes from any operator given only its
stacked application (k, n) -> (k, n), by coloured probing: the (2r+1)^dim
indicator combs of the lattice phases (i mod m, j mod m[, k mod m]) go
through one stacked application; same-colour points have disjoint stencil
neighbourhoods, so coefficient k at node q is the response of the colour
of q + offset_k at q. The block operators probe nF·m^dim colours (field ×
phase), generated and applied chunk by chunk. A probe point outside the lattice has no in-grid point of its
colour within the radius, so off-grid taps come out exactly 0.
"""
from __future__ import annotations

import itertools

import torch

from iifea_tpu_torch.ops import stencil_kernels as sk


def chunked_mv_multi(matvec_multi, X: torch.Tensor,
                     chunk: int | None = None) -> torch.Tensor:
    """matvec_multi over the rows of X (k, n) in chunks of ``chunk`` rows,
    which bounds the general apply's (k, dofs per element, elements)
    temporaries."""
    k = X.shape[0]
    if chunk is None or chunk >= k:
        return matvec_multi(X)
    chunk = max(int(chunk), 1)
    return torch.cat([matvec_multi(X[s:s + chunk])
                      for s in range(0, k, chunk)])


def _combs(shape, radius, dtype, device) -> torch.Tensor:
    """(m^dim, n) indicator combs, colour c = Σ phase_d·m^(dim−1−d)."""
    m = 2 * radius + 1
    axes = torch.meshgrid(*(torch.arange(s, device=device) for s in shape),
                          indexing="ij")
    color = torch.zeros(shape, dtype=torch.int64, device=device)
    for a in axes:
        color = color * m + a % m
    return (color.reshape(1, -1) == torch.arange(
        m ** len(shape), device=device)[:, None]).to(dtype)


def _probe_index(shape, radius: int, device) -> torch.Tensor:
    """(m^dim, *shape) colour of q + o for every offset o and node q, the
    gather index of ``_distribute_probe``."""
    m = 2 * radius + 1
    dim = len(shape)
    axes = torch.meshgrid(*(torch.arange(s, device=device)
                            for s in shape), indexing="ij")
    idx = []
    for o in itertools.product(range(-radius, radius + 1), repeat=dim):
        c = torch.zeros(shape, dtype=torch.int64, device=device)
        for a, oa in zip(axes, o):
            c = c * m + (a + oa) % m
        idx.append(c)
    return torch.stack(idx)


def _distribute_probe(Y: torch.Tensor, shape, radius: int,
                      idx: torch.Tensor | None = None) -> torch.Tensor:
    """Probe responses Y (m^dim, n), colours ordered as ``_combs``, into
    coefficient planes (m^dim, *shape): plane k (offset o) at node q is
    Y[colour(q + o), q], one gather along the colour axis (``idx``: the
    cached ``_probe_index``)."""
    if idx is None:
        idx = _probe_index(shape, radius, Y.device)
    m = 2 * radius + 1
    return torch.gather(Y.reshape(m ** len(shape), *shape), 0, idx)


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

    def smooth(self, invd: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor | None, omega: float, sweeps: int,
               with_residual: bool = False):
        """``sweeps`` weighted-Jacobi sweeps x ← x + ω·invd·(b − A x) from x
        (None: from zero), and with ``with_residual`` also b − A x_ν
        (returns the pair): the ``smooth`` kernel entry for f32, one launch
        per call on the small lattices. ``invd`` and ``b`` are flat (n,)
        vectors."""
        fn = (sk.smooth if self.coeffs.dtype == torch.float32
              else sk.smooth_plain)
        return fn(self.coeffs, invd, b, x, omega, sweeps, self.shape,
                  self.radius, with_residual)

    def diag(self) -> torch.Tensor:
        m = 2 * self.radius + 1
        return self.coeffs[self.radius * m + self.radius].reshape(-1)

    @staticmethod
    def probe_multi(matvec_multi, shape, radius: int = 2,
                    dtype=torch.float32, chunk: int | None = None,
                    device="cuda") -> "StencilOperator2D":
        """The (2r+1)² planes of the operator behind ``matvec_multi`` by
        one stacked (m², n) probe (in chunks of ``chunk`` rows). The combs
        are built in ``dtype``; the planes are cast to it, whatever dtype
        the operator computes in."""
        X = _combs(shape, radius, dtype, device)
        Y = chunked_mv_multi(matvec_multi, X, chunk).to(dtype)
        return StencilOperator2D.from_probe_y(Y, shape, radius, dtype)

    @staticmethod
    def from_probe_y(Y: torch.Tensor, shape, radius: int = 2,
                     dtype=torch.float32) -> "StencilOperator2D":
        """Probe responses Y (m², n), colour c = (i mod m)·m + (j mod m),
        into a stencil operator."""
        return StencilOperator2D(_distribute_probe(Y.to(dtype), shape,
                                                   radius), shape, radius)

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        """Largest relative error of ``mv`` against ``matvec`` on random
        vectors."""
        return _verify(self, matvec, seed, n_checks)


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

    @staticmethod
    def probe_multi(matvec_multi, shape, radius: int = 2,
                    dtype=torch.float32, chunk: int | None = None,
                    device="cuda") -> "StencilOperator3D":
        """The (2r+1)³ planes by one stacked (m³, n) probe; see
        ``StencilOperator2D.probe_multi``."""
        X = _combs(shape, radius, dtype, device)
        Y = chunked_mv_multi(matvec_multi, X, chunk).to(dtype)
        return StencilOperator3D(_distribute_probe(Y, shape, radius), shape,
                                 radius)

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        """Largest relative error of ``mv`` against ``matvec`` on random
        vectors."""
        return _verify(self, matvec, seed, n_checks)


class _StencilOperatorBlock:
    """What the 2D and 3D block (multi-field) stencil operators share:
    background dofs are field-blocked (node + field·nn), so a vector
    reshapes to (nF, *shape) planes and

        y[f1] = Σ_f2 Σ_|o|≤r C[f1, f2, k(o)] ⊙ shift_o(x[f2]),

    coefficients (nF, nF, (2r+1)^dim, *shape). Subclasses set ``dim`` and
    the kernel calls ``mv`` and ``smooth``."""

    dim: int

    def __init__(self, coeffs: torch.Tensor, shape, radius: int):
        self.shape = tuple(int(s) for s in shape)
        self.radius = int(radius)
        if len(self.shape) != self.dim:
            raise ValueError(f"a {self.dim}D block operator got the lattice "
                             f"{self.shape}")
        mK = (2 * self.radius + 1) ** self.dim
        nF = coeffs.shape[0]
        if tuple(coeffs.shape) != (nF, nF, mK, *self.shape):
            raise ValueError(
                f"block coefficients {tuple(coeffs.shape)} do not match "
                f"{(nF, nF, mK, *self.shape)}"
            )
        self.coeffs = coeffs.contiguous()
        self.n_fields = nF
        self.nn = 1
        for s in self.shape:
            self.nn *= s
        self.n = nF * self.nn

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def to(self, dtype: torch.dtype):
        return type(self)(self.coeffs.to(dtype), self.shape, self.radius)

    @classmethod
    def probe_multi(cls, matvec_multi, shape, n_fields: int, radius: int = 2,
                    dtype=torch.float32, chunk: int | None = None,
                    device="cuda"):
        """All nF² blocks by one stacked (nF·m^dim, nF·nn) probe: colour
        f2·m^dim + c is comb c on field f2; the response on field f1 holds
        C[f1, f2]. The probe columns are made and applied ``chunk`` at a
        time (the 3 × 97³ lattice has 375 columns of 2.7 M values), so
        only the responses and the planes are ever held whole."""
        nF = n_fields
        shape = tuple(int(s) for s in shape)
        combs = _combs(shape, radius, dtype, device)           # (mK, nn)
        mK, nn = combs.shape
        k = nF * mK
        chunk = k if chunk is None else min(max(int(chunk), 1), k)
        Y = torch.empty((k, nF * nn), dtype=dtype, device=device)
        for s in range(0, k, chunk):
            cols = torch.arange(s, min(s + chunk, k), device=device)
            X = torch.zeros((len(cols), nF, nn), dtype=dtype, device=device)
            X[torch.arange(len(cols), device=device), cols // mK] = \
                combs[cols % mK]
            Y[s:s + chunk] = matvec_multi(X.reshape(len(cols), nF * nn))
            del X
        Y = Y.reshape(nF, mK, nF, nn)                  # [f2, c, f1, q]
        idx = _probe_index(shape, radius, device)
        C = torch.empty((nF, nF, mK, *shape), dtype=dtype, device=device)
        for f1 in range(nF):
            for f2 in range(nF):
                C[f1, f2] = _distribute_probe(Y[f2, :, f1], shape, radius,
                                              idx)
        return cls(C, shape, radius)

    def _center(self) -> int:
        return ((2 * self.radius + 1) ** self.dim) // 2

    def diag(self) -> torch.Tensor:
        k0 = self._center()
        return torch.stack([self.coeffs[f, f, k0]
                            for f in range(self.n_fields)]).reshape(-1)

    def point_block_diag(self) -> torch.Tensor:
        """(nF, nF, nn) nodal blocks (point-block Jacobi)."""
        return self.coeffs[:, :, self._center()].reshape(
            self.n_fields, self.n_fields, self.nn)

    def verify(self, matvec, seed: int = 0, n_checks: int = 2) -> float:
        """Largest relative error of ``mv`` against ``matvec`` on random
        vectors."""
        return _verify(self, matvec, seed, n_checks)


class StencilOperatorBlock2D(_StencilOperatorBlock):
    """Block (multi-field) stencil operator on an (nx1, ny1) lattice, for
    vector problems; coefficients (nF, nF, (2r+1)², nx1, ny1). On a card an
    apply is one launch of the block kernel
    (``stencil_kernels.stencil_mv_block``), which stages the x tiles of all
    fields once."""

    dim = 2

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: on a card one launch of the stencil_mv_block kernel (a
        non-f32 operator raises, the kernels are f32 only), on the CPU the
        plain ``mv_ref``."""
        if self.device.type == "cuda":
            return sk.stencil_mv_block(self.coeffs, x, self.shape,
                                       self.radius)
        return self.mv_ref(x)

    def smooth(self, binv: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor | None, omega: float, sweeps: int,
               with_residual: bool = False):
        """``sweeps`` point-block Jacobi sweeps x ← x + ω·Binv·(b − A x)
        from x (None: from zero) on the (nF, nF, nn) nodal blocks ``binv``,
        and with ``with_residual`` also b − A x_ν (returns the pair): on a
        card the ``smooth`` kernel entry, on the CPU its plain version."""
        fn = sk.smooth if self.device.type == "cuda" else sk.smooth_plain
        return fn(self.coeffs, binv, b, x, omega, sweeps, self.shape,
                  self.radius, with_residual)

    def mv_ref(self, x: torch.Tensor) -> torch.Tensor:
        """Plain shifted-slice apply; x may be batched (..., n)."""
        return sk.stencil_mv_block_plain(self.coeffs, x, self.shape,
                                         self.radius)


class StencilOperatorBlock3D(_StencilOperatorBlock):
    """Block (multi-field) stencil operator on an (nx1, ny1, nz1) lattice,
    for 3D vector problems; coefficients (nF, nF, (2r+1)³, nx1, ny1, nz1).
    On a card every apply, residual and point-block sweep is one launch of
    the ``stencil3d_block`` kernel (a non-f32 operator raises there); on the
    CPU the plain versions."""

    dim = 3

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: one stencil3d_block launch on a card, ``mv_ref`` on the
        CPU."""
        if self.device.type == "cuda":
            return sk.stencil3d_block(self.coeffs, x, self.shape,
                                      self.radius)
        return self.mv_ref(x)

    def smooth(self, binv: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor | None, omega: float, sweeps: int,
               with_residual: bool = False):
        """``sweeps`` point-block Jacobi sweeps x ← x + ω·Binv·(b − A x)
        from x (None: from zero; the first sweep is then ω·Binv·b) and with
        ``with_residual`` also b − A x_ν (returns the pair): one
        stencil3d_block launch per sweep and one for the residual on a card,
        the plain versions on the CPU."""
        args = (self.shape, self.radius)
        if self.device.type == "cuda":
            def sweep(x):
                return sk.stencil3d_block(self.coeffs, x, *args, b=b,
                                          binv=binv, omega=omega)

            def residual(x):
                return sk.stencil3d_block(self.coeffs, x, *args, b=b)
        else:
            def sweep(x):
                return sk.sweep3_block_plain(self.coeffs, binv, b, x, omega,
                                             *args)

            def residual(x):
                return sk.residual3_block_plain(self.coeffs, b, x, *args)

        if sweeps < 0:
            raise ValueError(f"sweeps must be >= 0, got {sweeps}")
        if x is None and sweeps == 0:
            x = torch.zeros_like(b)
        for _ in range(sweeps):
            x = sweep(x)
        return (x, residual(x)) if with_residual else x

    def mv_ref(self, x: torch.Tensor) -> torch.Tensor:
        """Plain shifted-slice apply; x may be batched (..., n)."""
        return sk.apply3_block_plain(self.coeffs, x, self.shape, self.radius)


def _verify(S, matvec, seed: int, n_checks: int) -> float:
    g = torch.Generator().manual_seed(seed)
    worst = 0.0
    for _ in range(n_checks):
        x = torch.randn(S.n, generator=g, dtype=torch.float64).to(
            dtype=S.dtype, device=S.device)
        y_ref = matvec(x)
        num = float(torch.linalg.vector_norm(S.mv(x) - y_ref))
        den = float(torch.linalg.vector_norm(y_ref)) or 1.0
        worst = max(worst, num / den)
    return worst
