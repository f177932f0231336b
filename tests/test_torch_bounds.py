"""The bound ``chip_smoke.py`` holds every kernel's time to counts only the
taps a point needs: those whose x lies in the lattice. Their count
(``lattice_taps``) times nF² is the nonzeros of the planes' CSR form
(``planes_csr``, the operator cuSPARSE runs as the kernels' library
yardstick), and their complement is ``stencil_kernels.outside_taps``.
On the CPU, in a few seconds; imports nothing of JAX."""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from iifea_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

# odd shapes, with axes shorter than the radius (summed exactly) and
# longer (n(2r+1) - r(r+1))
SHAPES = {2: [(13, 5), (3, 17)], 3: [(5, 7, 3), (9, 4, 11)]}


def _planes(shape, radius, n_fields, seed):
    rng = np.random.default_rng(seed)
    m = (2 * radius + 1) ** len(shape)
    lead = (n_fields, n_fields) if n_fields > 1 else ()
    return torch.from_numpy(rng.standard_normal((*lead, m, *shape)))


@pytest.mark.parametrize("n_fields", [1, 2, 3])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("dim", [2, 3])
def test_torch_bound_taps_are_the_csr_nonzeros(dim, radius, n_fields):
    """nF² · lattice_taps · n equals the nonzeros planes_csr keeps (every
    coefficient of a tap in the lattice), the taps outside_taps does not
    mark, and the apply bound's bytes are those nonzeros and the two
    vectors, at r = 1-6, 1-3 fields, 2D and 3D."""
    for shape in SHAPES[dim]:
        n = math.prod(shape)
        taps = cs.lattice_taps(shape, radius)
        C = _planes(shape, radius, n_fields, 10 * radius + n_fields)
        nnz = cs.planes_csr(C, shape, radius).values().numel()
        assert round(n_fields ** 2 * taps * n) == nnz
        assert int((~sk.outside_taps(shape, radius)).sum()) == round(taps * n)
        ms, by = cs.bound_passes(shape, n_fields, ["apply"], radius, True)
        words = nnz + 2 * n_fields * n
        assert by == "bytes"
        assert ms == pytest.approx(8.0 * words / cs.HBM_BYTES_PER_S * 1e3,
                                   rel=1e-12)


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_torch_bound_taps_per_axis(radius):
    """Per axis of n > r points the taps in the lattice are n(2r+1) −
    r(r+1); at n <= r every point reaches every other, n²; the lattice's
    are the product of its axes'."""
    m = 2 * radius + 1
    for n in range(1, 40):
        want = n * m - radius * (radius + 1) if n > radius else n * n
        assert cs.lattice_taps((n,), radius) * n == pytest.approx(want,
                                                               rel=1e-14)
    shape = (17, 33, 65)
    per_axis = [(s_ * m - radius * (radius + 1)) / s_ for s_ in shape]
    assert cs.lattice_taps(shape, radius) == pytest.approx(
        math.prod(per_axis), rel=1e-14)


def test_torch_bound_counts_fewer_taps_than_the_stencil():
    """At 3 × 17³ the apply bound counts 0.657 (r = 4) and 0.592 (r = 5)
    of the (2r+1)³ taps a point's stencil holds, the in-lattice shares
    (1 − r(r+1)/(17(2r+1)))³; the vectors keep their words."""
    for radius, share in ((3, 0.727), (4, 0.657), (5, 0.592)):
        m3 = (2 * radius + 1) ** 3
        taps = cs.lattice_taps((17, 17, 17), radius)
        assert taps / m3 == pytest.approx(share, abs=5e-4)
        ms, _ = cs.bound_passes((17, 17, 17), 3, ["apply"], radius, True)
        assert ms == pytest.approx(
            8.0 * 17 ** 3 * (9 * taps + 6) / cs.HBM_BYTES_PER_S * 1e3)
