"""Scatter-adds in a fixed order.

``index_add_`` on CUDA accumulates with atomics in no fixed order, so an f64
sum onto a repeated index differs in its last bits from run to run; fed
through a Newton state into a mixed-precision Krylov solve, such bits moved
the Taylor-Green cell's first GMRES count between 200 and 408 in runs of
one tree (PERF.md §5, P5). A ``SegmentSum`` sorts the entries by target
once, then applies the sum as a gather of each target's entries, padded
with a zero to the largest count, and a fixed-width sum along the padding
axis: the same order on every run, and no atomics.
"""
from __future__ import annotations

import torch


class SegmentSum:
    """y[..., j] = Σ data[..., p] over the entries p with idx[p] = j.

    ``idx`` (any shape) is flattened; entries where ``keep`` is False are
    left out (an ELL's padding, whose weight is zero). Within a target the
    entries add in ascending position order."""

    def __init__(self, idx: torch.Tensor, n_out: int,
                 keep: torch.Tensor | None = None):
        idx = idx.reshape(-1)
        dev = idx.device
        self.n_in, self.n_out = idx.numel(), int(n_out)
        pos = torch.arange(self.n_in, device=dev)
        if keep is not None:
            pos = pos[keep.reshape(-1)]
        target = idx[pos]
        order = torch.argsort(target, stable=True)
        pos, target = pos[order], target[order]
        self.rows, counts = torch.unique_consecutive(target,
                                                     return_counts=True)
        seg = torch.repeat_interleave(
            torch.arange(len(self.rows), device=dev), counts)
        rank = (torch.arange(len(pos), device=dev)
                - (torch.cumsum(counts, 0) - counts)[seg])
        width = int(counts.max()) if len(counts) else 0
        # (width, targets) entry positions; n_in points at the appended zero
        self.pos = torch.full((width, len(self.rows)), self.n_in,
                              dtype=torch.int64, device=dev)
        self.pos[rank, seg] = pos

    def __call__(self, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., n_in) -> (..., n_out); added into ``out`` when given."""
        lead = data.shape[:-1]
        padded = torch.cat([data, data.new_zeros(*lead, 1)], dim=-1)
        s = padded[..., self.pos].sum(dim=-2)
        if out is None:
            out = data.new_zeros(*lead, self.n_out)
        out[..., self.rows] += s
        return out

