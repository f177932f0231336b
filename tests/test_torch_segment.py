"""The port's fixed-order scatter-add (ops/segment.py), which replaces
``index_add_`` in the extraction's transpose, the element scatters and the
probe: the same sums as a sequential scatter on repeated, masked and
stacked inputs."""
import numpy as np
import torch

from iifea_tpu_torch.ops.segment import SegmentSum


def _reference(data, idx, n_out, keep=None):
    out = np.zeros(data.shape[:-1] + (n_out,))
    sel = np.ones(idx.size, bool) if keep is None else keep.reshape(-1)
    for p in np.flatnonzero(sel):
        out[..., idx.reshape(-1)[p]] += data[..., p]
    return out


def test_torch_segment_sum_matches_scatter():
    rng = np.random.default_rng(0)
    idx = rng.integers(3, 40, size=(6, 50))          # targets 0-2 unused
    data = rng.standard_normal((4, idx.size))
    keep = rng.random(idx.shape) > 0.3
    S = SegmentSum(torch.from_numpy(idx), 45, torch.from_numpy(keep))
    y = S(torch.from_numpy(data))
    assert y.shape == (4, 45) and not y[:, :3].any() and not y[:, 40:].any()
    np.testing.assert_allclose(y.numpy(), _reference(data, idx, 45, keep),
                               rtol=1e-13, atol=1e-13)
    one = SegmentSum(torch.from_numpy(idx), 45)(torch.from_numpy(data[0]))
    np.testing.assert_allclose(one.numpy(), _reference(data[0], idx, 45),
                               rtol=1e-13, atol=1e-13)


def test_torch_segment_sum_adds_into_out_and_repeats_bitwise():
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, 10, size=300))
    data = torch.from_numpy(rng.standard_normal(300))
    S = SegmentSum(idx, 10)
    base = torch.arange(10, dtype=torch.float64)
    y = S(data, out=base.clone())
    assert torch.allclose(y - base, S(data), rtol=1e-14, atol=1e-14)
    assert torch.equal(S(data), SegmentSum(idx, 10)(data))
    assert S.pos.shape[0] == int(torch.bincount(idx).max())
