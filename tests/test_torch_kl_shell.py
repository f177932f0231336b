"""The port's Kirchhoff-Love shell (models/kl_shell.py) and its two
background-unfitted demos vs the JAX package, from identical numpy state
(the specs are iifea_tpu/models/kl_shell.py and
demos/background_unfitted/{pinned,cut}_shell_unfitted.py).

Two configurations at the demos' geometry with n = 8 (their --ref 0), one
per demo, which between them take every option value: (A) the flat diamond
with a fixed areal load, pinned on the immersed boundary with the facet
scale and no J_vol; (B) the bent tab with the follower pressure at t = 0.5,
pinned on the edges x = ±1 with the h_min scale and J_vol, J_surf.

Tolerances: element blocks and residual 1e-11 relative to each term's
largest entry (the same f64 arithmetic in another order), point
evaluation 1e-12, the demos' Newton iterations equal and their tracked
displacement 1e-8 relative (both factor the same system with SuperLU)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iifea_tpu.mesh.bspline import BSplineSpace2D as JBSpline
from iifea_tpu.mesh.core import Mesh as JMesh
from iifea_tpu.mesh.generators import rectangle_mesh as j_rectangle
from iifea_tpu.models.kl_shell import KLShellProblem as JKLShell
from iifea_tpu.solvers import newton as jnewton
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos.background_unfitted import (
    cut_shell_unfitted as cut_demo,
    pinned_shell_unfitted as pinned_demo,
)
from iifea_tpu_torch.models.kl_shell import KLShellProblem

N = 8          # the demos' n at --ref 0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_material(kind, cent):
    """The JAX demos' block markers, as written there."""
    if kind == "pinned":
        half = 1.0 / math.sqrt(2.0)
        inside = ((np.abs(cent[:, 0]) + np.abs(cent[:, 1]))
                  <= half * math.sqrt(2.0))
        return np.where(inside, 2, 1).astype(np.int32)
    x, y = cent[:, 0], cent[:, 1]
    r2 = x**2 + y**2
    mat = np.ones_like(x, dtype=np.int32)
    cut = (r2 < 0.25) | ((y < 0) & (np.abs(x) < 0.2) & (r2 >= 0.25))
    keep = (r2 < 0.0625) | ((r2 >= 0.0625) & (r2 < 0.25) & (y > 0)
                            & (np.abs(x) < 0.1))
    mat[cut] = 0
    mat[cut & keep] = 1
    return np.where(mat > 0, 2, 1).astype(np.int32)


SURFACES = {   # (JAX, port)
    "pinned": (lambda xi: jnp.array([xi[0], xi[1], 0.0]),
               pinned_demo.flat_surface),
    "cut": (lambda xi: jnp.array([xi[0], xi[1], 0.5 * (1.0 - xi[0] ** 2)]),
            cut_demo.bent_tab_surface),
}
PROBLEMS = {"pinned": pinned_demo.PROBLEM, "cut": cut_demo.PROBLEM}
PARAMS = {"pinned": None, "cut": 0.5}


class ShellPair:
    """One demo's problem and B-spline extraction in both packages."""

    def __init__(self, kind, **overrides):
        m = j_rectangle((-1.0, -1.0), (1.0, 1.0), N, N)
        material = _jax_material(kind, m.cell_coords.mean(1))
        self.mesh_j = JMesh(m.coords, m.cells, material)
        self.mesh = from_numpy_state(coords=m.coords, cells=m.cells,
                                     material=material, device="cpu").mesh
        kw = {**PROBLEMS[kind], **overrides}
        surf_j, surf = SURFACES[kind]
        self.prob_j = JKLShell(self.mesh_j, surf_j, **kw)
        self.prob = KLShellProblem(self.mesh, surf, device="cpu", **kw)
        spline = JBSpline(2, (max(N // 2, 4),) * 2, (-1.0, -1.0), (1.0, 1.0))
        self.M_j = spline.transfer_matrix(
            np.asarray(self.prob_j.space.node_coords), n_fields=3)
        t = PARAMS[kind]
        self.params = None if t is None else {"t": t}
        self.params_j = None if t is None else {"t": jnp.asarray(t)}


@pytest.fixture(scope="module")
def shells():
    return {kind: ShellPair(kind) for kind in ("pinned", "cut")}


def test_torch_kl_shell_demo_meshes():
    """The port demos' meshes are the JAX demos' (coordinates, cells and
    block markers)."""
    for kind, build in (("pinned", pinned_demo.diamond_mesh),
                        ("cut", cut_demo.tab_mesh)):
        m = j_rectangle((-1.0, -1.0), (1.0, 1.0), 16, 16)
        mt = build(16)
        assert np.array_equal(mt.coords, m.coords)
        assert np.array_equal(mt.cells, m.cells)
        assert np.array_equal(mt.material,
                              _jax_material(kind, m.cell_coords.mean(1)))


@pytest.mark.parametrize("kind", ["pinned", "cut"])
def test_torch_kl_shell_element_parity(shells, kind):
    """Every term's element blocks (cell energy Hessian and pin penalty)
    and the assembled residual at a seeded random displacement."""
    s = shells[kind]
    assert s.prob.hmin == s.prob_j.hmin
    assert [d.n_elem for d, _ in s.prob.form.terms] == [
        d.n_elem for d, _ in s.prob_j.form.terms] and len(s.prob.form.terms) == 2
    u = np.random.default_rng(7).standard_normal(s.prob.space.n_dofs) * 1e-2
    blocks, res = s.prob.form.jacobian_and_residual(torch.from_numpy(u),
                                                    None, s.params)
    blocks_j, res_j = jax.jit(s.prob_j.form.jacobian_and_residual)(
        jnp.asarray(u), None, s.params_j)
    for K, K_j in zip(blocks, blocks_j):
        assert K.shape == K_j.shape
        assert _rel(K.numpy(), K_j) < 1e-11
    assert _rel(res.numpy(), res_j) < 1e-11
    pts = [[0.0, 0.0], [0.0, -0.25]]
    assert _rel(s.prob.evaluate(torch.from_numpy(u), pts),
                s.prob_j.evaluate(jnp.asarray(u), pts)) < 1e-12


def test_torch_kl_shell_energy_hessian_symmetry():
    """Without the follower load the cell Jacobian is the Hessian of an
    energy: symmetric blocks (the bent tab, J_vol on)."""
    m = cut_demo.tab_mesh(N)
    prob = KLShellProblem(m, cut_demo.bent_tab_surface, device="cpu",
                          **{**cut_demo.PROBLEM, "pressure": 0.0})
    u = np.random.default_rng(3).standard_normal(prob.space.n_dofs) * 1e-2
    K = prob.form.jacobian_blocks(torch.from_numpy(u), None, {"t": 1.0})[0]
    asym = (K - K.transpose(0, 1)).abs().max()
    assert float(asym) <= 1e-8 * float(K.abs().max())


def _jax_steps(s, monkeypatch, n_steps, newton_kw):
    """The JAX demo's Newton loop in process on the pair's problem: per
    load step the Newton iterations (linear solves), and the final u_f."""
    calls = []
    solve = jnewton.solve_ksp

    def counted(*a, **k):
        calls[-1] += 1
        return solve(*a, **k)

    monkeypatch.setattr(jnewton, "solve_ksp", counted)
    u_p = jnp.zeros(s.M_j.n_bg_dofs)
    u_f = jnp.zeros(s.prob_j.space.n_dofs)
    delta = 1.0 / n_steps
    for i in range(n_steps):
        calls.append(0)
        params = None if s.params is None else {"t": jnp.asarray(i * delta)}
        u_p, u_f = jnewton.solve_nonlinear(s.prob_j.form, u_f, s.M_j, u_p,
                                           params=params, **newton_kw)
    monkeypatch.undo()
    return calls, u_f


def test_torch_pinned_shell_demo(shells, monkeypatch):
    """The port demo at --ref 0 on the host against the JAX demo's solve
    in process: equal Newton iterations, the centre displacement to 1e-8
    (and its in-plane components zero)."""
    out = pinned_demo.main(["--ref", "0", "--device", "cpu"])
    s = shells["pinned"]
    calls, u_f = _jax_steps(s, monkeypatch, 1, pinned_demo.NEWTON)
    disp_j = s.prob_j.evaluate(u_f, [[0.0, 0.0]])[0]
    assert out["newton_iters"] == calls[0] >= 2
    assert abs(out["disp"][2] - disp_j[2]) <= 1e-8 * abs(disp_j[2])
    assert max(abs(out["disp"][0]), abs(out["disp"][1])) < 1e-10
    assert out["u_f"].device.type == "cpu"


def test_torch_cut_shell_demo(shells, monkeypatch):
    """The port demo at --ref 0 --steps 3 against the JAX demo's load steps
    in process: equal Newton iterations per step, the tip to 1e-8."""
    out = cut_demo.main(["--ref", "0", "--steps", "3", "--device", "cpu"])
    s = shells["cut"]
    calls, u_f = _jax_steps(s, monkeypatch, 3, cut_demo.NEWTON)
    tip_j = s.prob_j.evaluate(u_f, [[0.0, -0.25]])[0]
    assert out["newton_iters"] == calls
    assert _rel(out["tip"], tip_j) <= 1e-8
    rec = out["record"][-1][0]
    assert {"assembly", "solve", "to_scipy", "direct_solve"} <= set(rec)
