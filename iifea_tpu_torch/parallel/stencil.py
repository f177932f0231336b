"""Row-block sharded stencil operators (port of
``iifea_tpu/parallel/stencil.py``).

The lattice is split into contiguous row blocks (2D rows, 3D x-slabs)
over the ranks of a ``DeviceMesh``. Each rank keeps an *extended slab* of
the coefficient planes: its rows plus r halo rows on each side, whose
coefficients are zero. One application is a halo exchange of r rows with
each neighbour (zeros beyond the ends: the single-device zero halo) and
then the single-device operator's own apply on the extended slab, of
which the interior rows are kept. On a card that apply is the hand
kernel (``stencil_mv``, ``stencil_mv3``, ``stencil_mv_block``), on the
CPU its plain version, by the same rule as the single-device operators.
An interior row reads the same taps and x values as in the single-device
apply, so the two agree to the last bit wherever the kernel sums in a
fixed order per point.

Vectors on a rank are flat tensors of its rows (field-blocked for block
operators, as the single-device vectors are); ``shard_vec`` takes a
rank's rows of a global vector, ``unshard_vec`` gathers them back.
"""
from __future__ import annotations

import torch

from iifea_tpu_torch.parallel.sharding import DeviceMesh, even_bounds


class RowBlock:
    """This rank's rows [start, stop) of an (nF, nx, *rest) lattice
    vector, rows split by ``bounds`` (rank k: [bounds[k], bounds[k+1])),
    and the halo-extended forms of its row block."""

    def __init__(self, shape, n_fields: int, bounds, mesh: DeviceMesh,
                 width: int):
        self.shape = tuple(int(s) for s in shape)
        self.n_fields = int(n_fields)
        self.bounds = [int(b) for b in bounds]
        self.mesh = mesh
        if (len(self.bounds) != mesh.size + 1 or self.bounds[0] != 0
                or self.bounds[-1] != self.shape[0]):
            raise ValueError(f"row bounds {self.bounds} do not split "
                             f"{self.shape[0]} rows over {mesh.size} ranks")
        counts = [b - a for a, b in zip(self.bounds[:-1], self.bounds[1:])]
        if min(counts) < width:
            raise ValueError(
                f"row blocks {counts} over {mesh.size} ranks: each needs at "
                f"least {width} rows (the halo a neighbour asks of it)")
        self.start = self.bounds[mesh.rank]
        self.stop = self.bounds[mesh.rank + 1]
        self.rows = self.stop - self.start

    def planes(self, x: torch.Tensor, rows: int | None = None):
        """A flat row-block vector as (nF, rows, *rest)."""
        return x.reshape(self.n_fields, self.rows if rows is None else rows,
                         *self.shape[1:])

    def ext_shape(self, width: int) -> tuple:
        return (self.rows + 2 * width, *self.shape[1:])

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global flat vector, on the mesh's
        device."""
        x = x.reshape(self.n_fields, *self.shape)[:, self.start:self.stop]
        return x.to(self.mesh.device).reshape(-1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global flat vector from every rank's rows."""
        return self.mesh.gather_rows(self.planes(x), self.bounds).reshape(-1)

    def extend(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x with ``width`` neighbour rows on each side (halo exchange)."""
        return self.mesh.halo(self.planes(x), width).reshape(-1)

    def pad(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x with ``width`` zero rows on each side (no exchange)."""
        p = self.planes(x)
        z = p.new_zeros((p.shape[0], width, *p.shape[2:]))
        return torch.cat([z, p, z], dim=1).reshape(-1)

    def interior(self, y: torch.Tensor, width: int) -> torch.Tensor:
        """The rank's own rows of an extended vector."""
        p = self.planes(y, self.rows + 2 * width)
        return p[:, width:width + self.rows].reshape(-1)

    def extend_planes(self, C: torch.Tensor, axis: int,
                      width: int) -> torch.Tensor:
        """Per-point planes C (rows on ``axis``) cut to this rank's rows
        with ``width`` zero rows on each side, on the mesh's device."""
        shape = list(C.shape)
        shape[axis] = self.rows + 2 * width
        out = torch.zeros(shape, dtype=C.dtype, device=self.mesh.device)
        out.narrow(axis, width, self.rows).copy_(
            C.narrow(axis, self.start, self.rows))
        return out


class _ShardedStencil:
    """Row-block sharded stencil operator: extended slab, halo exchange,
    the single-device apply (see the module docstring)."""

    def __init__(self, S, mesh: DeviceMesh, bounds=None):
        self.mesh = mesh
        self.shape = tuple(S.shape)
        self.radius = S.radius
        self.n = S.n
        self.n_fields = getattr(S, "n_fields", 1)
        self.block = RowBlock(self.shape, self.n_fields,
                              bounds or even_bounds(self.shape[0], mesh.size),
                              mesh, self.radius)
        # rows are axis 1 of scalar planes (m^dim, nx, ...) and axis 3 of
        # block coefficients (nF, nF, m^dim, nx, ...)
        axis = 3 if S.coeffs.dim() == len(self.shape) + 3 else 1
        C = self.block.extend_planes(S.coeffs, axis, self.radius)
        self.local = type(S)(C, self.block.ext_shape(self.radius),
                             self.radius)

    def shard_vec(self, x: torch.Tensor) -> torch.Tensor:
        """Global flat vector → this rank's rows (flat)."""
        return self.block.take(x)

    def unshard_vec(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows → the global flat vector (all ranks)."""
        return self.block.gather(x)

    def mv_local(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on this rank's rows: one halo exchange and one apply of
        the extended slab."""
        r = self.radius
        return self.block.interior(
            self.local.mv(self.block.extend(x, r)), r)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """Flat-vector interface: shard, apply, gather."""
        return self.unshard_vec(self.mv_local(self.shard_vec(x)))

    def diag_local(self) -> torch.Tensor:
        """The operator's diagonal on this rank's rows."""
        return self.block.interior(self.local.diag(), self.radius)


class ShardedStencil2D(_ShardedStencil):
    """Row-block sharded StencilOperator2D: ``mv2`` applies on this rank's
    rows (``stencil_mv`` on the extended slab)."""

    mv2 = _ShardedStencil.mv_local
    diag2 = _ShardedStencil.diag_local


class ShardedStencil3D(_ShardedStencil):
    """x-slab sharded StencilOperator3D: ``mv3`` applies on this rank's
    slabs (``stencil_mv3`` on the extended slab)."""

    mv3 = _ShardedStencil.mv_local


class ShardedStencilBlock2D(_ShardedStencil):
    """Row-block sharded StencilOperatorBlock2D: one halo exchange carries
    every field's rows, then one ``stencil_mv_block`` launch on the
    extended slab (``mvb``)."""

    mvb = _ShardedStencil.mv_local
