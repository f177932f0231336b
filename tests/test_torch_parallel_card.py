"""The sharded port (iifea_tpu_torch/parallel/) on a card: two gloo ranks
on one card (halos staged through pinned host buffers) apply the 2D
immersed operator and its V-cycle on the hand kernels, against the
single-device apply and cycle on the same card; and the nccl backend
refuses more ranks than cards. Every case skips without a CUDA device.

The file imports nothing of JAX, so it also runs on a machine that has a
card and no JAX, without the package's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_parallel_card.py -q
"""
import pytest
import torch

import torch_parallel_ranks as ranks
from iifea_tpu_torch.mesh.generators import immersed_square_problem
from iifea_tpu_torch.models.poisson import PoissonProblem
from iifea_tpu_torch.parallel import sharding
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_torch_sharded_apply_and_vcycle_on_card():
    """Each rank launches stencil_mv for its row block's apply and the
    per-pass kernels for its sharded levels; the apply equals the single
    device's bitwise, the cycle to f32 rounding (3e-6·max|z|)."""
    dev = _card()
    n_bg = 128
    mesh, M = immersed_square_problem(n_fg=180, n_bg=n_bg, device=dev)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=dev)
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1,) * 2, device=dev)
    S32 = solver.probe(solver.bind(*solver.assemble()[1:]))
    mg = solver.build_mg(S32)
    out = sharding.launch(ranks.card_checks, 2, "gloo", args=(S32, mg),
                          device=dev, timeout=300)
    for r in out:
        assert r["route"] == "gloo, staged through pinned host buffers"
        assert r["apply_launches"] == 1
        assert all(r["launches"].get(k, 0) > 0 for k in
                   ("stencil_mv", "jacobi_smooth", "stencil_mv_block"))
        assert torch.equal(r["y"], r["y_ref"])
        scale = float(r["z_ref"].abs().max())
        assert float((r["z"] - r["z_ref"]).abs().max()) <= 3e-6 * scale


@pytest.mark.gpu
def test_torch_nccl_refuses_more_ranks_than_cards():
    dev = _card()
    with pytest.raises(ValueError, match="one rank on each card"):
        sharding.launch(ranks.fail_on_rank_one,
                        torch.cuda.device_count() + 1, "nccl", device=dev)
