"""The port's background-unfitted Poisson demo vs the JAX package's demo
(demos/background_unfitted/poisson_unfitted.py, run in process) and its
recorded error norms (studies/unfitted.jsonl).

Tolerances: the projected system A_b, b_b 1e-12 relative to its largest
entry (the same f64 arithmetic in another order), the error norms 1e-8
relative (both factor the same system with SuperLU)."""
import json
import os
import runpy
import sys

import numpy as np
import pytest

from iifea_tpu_torch.demos.background_unfitted import poisson_unfitted as demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jsonl_row(n):
    with open(os.path.join(ROOT, "studies", "unfitted.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return next(r for r in rows
                if r["demo"] == "poisson_unfitted" and r["n"] == n)


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX demo's globals after a run at --n 16."""
    argv = sys.argv
    sys.argv = ["poisson_unfitted.py", "--n", "16"]
    try:
        return runpy.run_path(os.path.join(
            ROOT, "demos", "background_unfitted", "poisson_unfitted.py"))
    finally:
        sys.argv = argv


def test_torch_poisson_unfitted_demo_norms(jax_demo):
    """--n 16 on the host: the JSONL row's L2 and H1, and the JAX demo's."""
    out = demo.main(["--n", "16", "--device", "cpu"])
    row = _jsonl_row(16)
    assert out["Nel"] == 16 and out["u_f"].device.type == "cpu"
    for key, jkey in (("L2", "norm_L2"), ("H1", "norm_H1")):
        assert abs(out[key] - row[key]) <= 1e-8 * row[key]
        assert abs(out[key] - jax_demo[jkey]) <= 1e-8 * jax_demo[jkey]


def test_torch_poisson_unfitted_system(jax_demo):
    """assemble_background_system's A_b and b_b against the JAX demo's."""
    from iifea_tpu_torch.ops.projection import assemble_background_system
    import torch

    args = demo.parse_args(["--n", "16"])
    form, M, *_ = demo.problem(args, torch.device("cpu"))
    A, b = assemble_background_system(
        form, torch.zeros(form.n_dofs, dtype=torch.float64), M)
    A_j, b_j = jax_demo["dR_b"], np.asarray(jax_demo["R_b"])
    Ad, Ad_j = A.to_scipy().toarray(), A_j.to_scipy().toarray()
    assert Ad.shape == Ad_j.shape == (289, 289)
    assert np.abs(Ad - Ad_j).max() <= 1e-12 * np.abs(Ad_j).max()
    assert np.abs(b.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()
