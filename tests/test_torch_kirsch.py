"""The port's Kirsch plate (models/elasticity.py: classify_elasticity_facets,
kirsch_exact, sigma_of, ElasticityProblem with its traction and Nitsche
terms and stress_error_norm) and the file branch of
demos/linear_elasticity.py vs the JAX package on the same generated mesh files
(tests/torch_mesh_fixtures.py; the specs are
iifea_tpu/models/elasticity.py:36-236 and demos/linear_elasticity.py).

Tolerances: facet classes exact; the exact fields 1e-14 relative to their
largest entry (the same closed form in another library); the projected
system Mᵀ A_f M and its right-hand side 1e-12 relative (the same f64
arithmetic in another order); the stress error norm after the direct
solve 1e-10 relative (both factor the same matrix with SuperLU), through
the demo 1e-8 with equal GMRES iterations."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iifea_tpu.mesh.core import Mesh as JMesh
from iifea_tpu.mesh.io import read_mesh as j_read_mesh
from iifea_tpu.models import elasticity as j_el
from iifea_tpu.ops.extraction import ExtractionOperator as JExtraction
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.demos import linear_elasticity
from iifea_tpu_torch.demos.linear_elasticity import flip_materials
from iifea_tpu_torch.mesh.core import Mesh
from iifea_tpu_torch.mesh.generators import rectangle_mesh
from iifea_tpu_torch.mesh.io import read_mesh
from iifea_tpu_torch.models import elasticity as el
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.projection import assemble_background_system
from iifea_tpu_torch.solvers.ksp import solve_ksp

from torch_mesh_fixtures import write_family

REF = 1             # the plates' files: hole_in_plate/.../R1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_flip(m):
    """The JAX demo's swap of the quadratic files' materials."""
    f = np.where(m.material == 1, 2, np.where(m.material == 2, 1,
                                              m.material))
    return JMesh(m.coords, m.cells, f, m.cell_nodes)


class KirschPair:
    """The plate of degree k read from its files by both packages, its
    problem, M and projected system."""

    def __init__(self, root, k, sym=True):
        family = ("hole_in_plate/Linear" if k == 1
                  else "hole_in_plate/Quadratic")
        path = write_family(root, family, REF)
        self.mesh, self.mesh_j = read_mesh(path), j_read_mesh(path)
        if k == 2:
            self.mesh, self.mesh_j = (flip_materials(self.mesh),
                                      _jax_flip(self.mesh_j))
        self.prob = el.ElasticityProblem(self.mesh, k=k, sym=sym,
                                         device="cpu")
        self.prob_j = j_el.ElasticityProblem(self.mesh_j, k=k, sym=sym)
        csv = os.path.join(path, "ExOp_Cons.csv")
        self.M = ExtractionOperator.from_exop_csv(
            csv, self.prob.space.n_nodes, n_fields=2, device="cpu")
        self.M_j = JExtraction.from_exop_csv(csv, self.prob_j.space.n_nodes,
                                             n_fields=2)
        self.A, self.b = assemble_background_system(
            self.prob.form, torch.zeros(self.prob.space.n_dofs,
                                        dtype=torch.float64), self.M)
        form_j = self.prob_j.form
        A_j, self.b_j = jax.jit(lambda u: j_assemble(form_j, u, self.M_j))(
            jnp.zeros(form_j.n_dofs))
        self.A_j = JBackgroundOperator(form_j, A_j.blocks, self.M_j)
        self.root, self._jax = root, {}

    def jax_solve(self, method="direct", pc=None):
        """The JAX package's solve of its system and the stress error norm
        of its solution, once per (method, pc)."""
        if (method, pc) not in self._jax:
            u, info = j_solve_ksp(self.A_j, self.b_j, method=method, pc=pc,
                                  monitor=False)
            self._jax[method, pc] = (
                u, info, self.prob_j.stress_error_norm(self.M_j.mv(u)))
        return self._jax[method, pc]


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plates"))
    return {k: KirschPair(root, k) for k in (1, 2)}


def test_torch_kirsch_facet_classes_match_jax(plates):
    """The signed classifier on the P1 plate, the flipped P2 plate and a
    plate with hole cells (every class taken)."""
    for k in (1, 2):
        p = plates[k]
        c = el.classify_elasticity_facets(p.mesh)
        assert np.array_equal(c, j_el.classify_elasticity_facets(p.mesh_j))
        # the arc is the plate's boundary, in no class (0)
        assert set(np.unique(c)) == {0, el.LEFT_ID, el.BOTTOM_ID, el.TOP_ID,
                                     el.RIGHT_ID, el.PLATE_ID}
    # [0, 4]² in squares, the cells with centroid r < 1 marked hole (1):
    # hole interior and boundary, rim and plate classes
    m = rectangle_mesh((0.0, 0.0), (4.0, 4.0), 12, 12)
    r = np.linalg.norm(m.cell_coords.mean(1), axis=1)
    material = np.where(r < 1.0, 1, 2)
    m = Mesh(m.coords, m.cells, material)
    m_j = JMesh(m.coords, m.cells, material)
    c = el.classify_elasticity_facets(m)
    assert np.array_equal(c, j_el.classify_elasticity_facets(m_j))
    assert set(np.unique(c)) == {el.HOLE_ID, el.PLATE_ID, el.RIM_ID,
                                 el.LEFT_ID, el.BOTTOM_ID, el.TOP_ID,
                                 el.RIGHT_ID}


def test_torch_kirsch_exact_matches_jax():
    """σ, ε and u of the closed form at seeded points of the plate (and on
    the axes, where arctan(y/x) meets x = 0), with and without an offset
    origin."""
    rng = np.random.default_rng(13)
    pts = np.concatenate([rng.random((200, 2)) * 4.0,
                          [[0.0, 2.0], [3.0, 0.0], [1.0, 1e-9]]])
    for args in ((1.0, 1e6, 200e9, 0.3), (0.7, 2.5, 1.0, 0.25, 0.1, -0.2)):
        f, f_j = el.kirsch_exact(*args), j_el.kirsch_exact(*args)
        out = torch.func.vmap(f)(torch.from_numpy(pts))
        out_j = jax.vmap(f_j)(jnp.asarray(pts))
        for a, b in zip(out, out_j):
            assert _rel(a.numpy(), b) <= 1e-14


def test_torch_kirsch_sigma_matches_jax():
    """σ(∇u) with the bulk modulus in λ's place, on seeded gradients."""
    g = np.random.default_rng(5).standard_normal((50, 2, 2))
    sigma = el.sigma_of(3.5, 1.25)(torch.from_numpy(g))
    sigma_j = jax.vmap(j_el.sigma_of(3.5, 1.25))(jnp.asarray(g))
    assert _rel(sigma.numpy(), sigma_j) <= 1e-15


@pytest.mark.parametrize("k", [1, 2])
def test_torch_kirsch_system_matches_jax(plates, k):
    """The projected operator (to_scipy) and right-hand side of the P1
    plate and of the flipped P2 plate; the facet domains' sizes."""
    p = plates[k]
    assert p.prob.space.n_nodes == p.prob_j.space.n_nodes
    for dom in ("cell_dom", "neumann_dom", "sym_dom"):
        assert getattr(p.prob, dom).n_elem == getattr(p.prob_j, dom).n_elem > 0
    A, A_j = p.A.to_scipy(), p.A_j.to_scipy()
    assert A.shape == A_j.shape == (p.M.n_bg_dofs,) * 2
    assert abs(A - A_j).max() <= 1e-12 * abs(A_j).max()
    assert _rel(p.b.numpy(), p.b_j) <= 1e-12


def test_torch_kirsch_nonsymmetric_system_matches_jax(tmp_path):
    """sym=False flips the adjoint-consistency sign in both packages."""
    p = KirschPair(str(tmp_path), 1, sym=False)
    A, A_j = p.A.to_scipy(), p.A_j.to_scipy()
    assert abs(A - A_j).max() <= 1e-12 * abs(A_j).max()
    assert abs(A - A.T).max() > 1e-6 * abs(A).max()


@pytest.mark.parametrize("k", [1, 2])
def test_torch_kirsch_stress_norm_matches_jax(plates, k):
    """The direct solve and the stress error norm; P2 below P1."""
    p = plates[k]
    u, _ = solve_ksp(p.A, p.b, method="direct", monitor=False)
    norm = p.prob.stress_error_norm(p.M.mv(u))
    norm_j = p.jax_solve()[2]
    assert abs(norm - norm_j) <= 1e-10 * norm_j
    assert 0 < norm < 0.2
    res = (p.A.mv(u) - p.b).norm() / p.b.norm()
    assert float(res) < 1e-10
    if k == 2:
        assert norm < plates[1].jax_solve()[2]


@pytest.mark.parametrize("k,argv", [
    (1, []), (2, []), (2, ["--solv", "gmres", "--pc", "asm"]),
])
def test_torch_elasticity_file_demo_matches_jax(plates, k, argv, tmp_path,
                                                capsys):
    """The Kirsch plate through demos/linear_elasticity.py on the plates'
    files (k = 2: the quadratic files' materials swapped back): the stress
    error norm against the JAX package's solve (1e-8), the report and the
    CSV line ref,norm,t_solve,t_extract; GMRES with asm takes JAX's
    iterations."""
    p = plates[k]
    of = tmp_path / "e.csv"
    out = linear_elasticity.main(
        ["--k", str(k), "--ref", str(REF), "--mesh-root", p.root,
         "--device", "cpu", "--wf", "True", "--of", str(of)] + argv)
    printed = capsys.readouterr().out
    method, pc = ("gmres", "asm") if argv else ("mumps", None)
    _, info, norm = p.jax_solve(method, pc)
    assert abs(out["norm"] - norm) <= 1e-8 * norm
    if argv:
        assert out["info"].iters == int(info.iters) > 0
    assert out["prob"].space.n_nodes == p.prob.space.n_nodes
    assert f"Extraction error norm: {out['norm']}" in printed
    assert "Symmetric Nitsche Method" in printed
    fields = of.read_text().split("\n")[1].split(",")
    assert fields[0] == str(REF) and float(fields[1]) == out["norm"]
    assert float(fields[2]) == out["t_solve"]
    assert float(fields[3]) == out["t_extract"] >= 0
