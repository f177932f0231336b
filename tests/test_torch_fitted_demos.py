"""The port's demos on mesh files (--mesh-root DIR --device cpu: the file
branches of demos/{poisson,biharmonic,tg_vortex}.py and the fitted
demos/{pinned_shell,cut_shell}.py; linear_elasticity.py's is in
tests/test_torch_kirsch.py) against the JAX package's
same steps in process, on the generated files of
tests/torch_mesh_fixtures.py (the specs are the JAX demos of those names).

Tolerances: error norms and tracked displacements 1e-8 relative, Krylov
and Newton iteration counts equal (both packages run the same algorithm
in f64 on the same system)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iifea_tpu.api import l2_project as j_l2_project
from iifea_tpu.mesh.core import FunctionSpace as JFunctionSpace
from iifea_tpu.mesh.io import read_mesh as j_read_mesh
from iifea_tpu.models import navier_stokes as jns
from iifea_tpu.models.biharmonic import BiharmonicProblem as JBiharmonic
from iifea_tpu.models.kl_shell import KLShellProblem as JKLShell
from iifea_tpu.models.poisson import PoissonProblem as JPoisson
from iifea_tpu.models.poisson import select_coercive_beta as j_select_beta
from iifea_tpu.ops.extraction import ExtractionOperator as JExtraction
from iifea_tpu.ops.projection import BackgroundOperator as JBackgroundOperator
from iifea_tpu.ops.projection import (
    assemble_background_system as j_assemble,
)
from iifea_tpu.solvers import newton as jnewton
from iifea_tpu.solvers.ksp import solve_ksp as j_solve_ksp
from iifea_tpu_torch.demos import (
    biharmonic,
    cut_shell,
    pinned_shell,
    poisson,
    tg_vortex,
)

from torch_mesh_fixtures import write_family

FAMILIES = {"square/Linear": 1, "square/Quadratic": 0, "cube/Linear": 0,
            "cube/Quadratic": 1, "bent_tab": 0}
TG_REF = 2          # square/Linear/R1 is too coarse for the Newton steps


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A mesh root with one directory of each family."""
    root = str(tmp_path_factory.mktemp("meshes"))
    for family, ref in FAMILIES.items():
        write_family(root, family, ref)
    write_family(root, "square/Linear", TG_REF)
    return root


def _close(a, b, rel=1e-8):
    return abs(a - b) <= rel * abs(b)


_SYSTEMS = {}       # (id(form), id(M)) -> (form, M, A, b), for this module


def _jax_system(form, M):
    """The JAX package's assemble_background_system at u = 0, jitted, once
    for each (form, M): a step that assembles a system an earlier step of
    the same test assembled reuses it instead of compiling it again."""
    key = (id(form), id(M))
    if key not in _SYSTEMS:
        A, b = jax.jit(lambda u: j_assemble(form, u, M))(
            jnp.zeros(form.n_dofs))
        _SYSTEMS[key] = (form, M, JBackgroundOperator(form, A.blocks, M), b)
    return _SYSTEMS[key][2:]


def _jitted_assembly(monkeypatch, module):
    """Route ``module``'s assemble_background_system (called at u = 0 by
    the JAX select_coercive_beta and l2_project) through _jax_system."""
    def assemble(form, u, M):
        assert not np.any(np.asarray(u))
        return _jax_system(form, M)

    monkeypatch.setattr(module, "assemble_background_system", assemble)


def _jax_files(path, n_nodes, n_fields=1):
    return JExtraction.from_exop_csv(os.path.join(path, "ExOp_Cons.csv"),
                                     n_nodes, n_fields=n_fields)


def _jax_norms(prob, M, method, path, ex=True):
    """The JAX package's solve on (prob, M), the Poisson problem of the
    files at ``path`` (``ex`` False: M the identity and the solve trimmed at
    bfr 1e-9, as --Ex False runs it): (norms,
    iterations), the norms those of JAX's solution through the port's
    error integrals (held against JAX's in tests/test_torch_poisson.py,
    test_torch_p2.py and test_torch_slice3d.py; JAX's take longer here than
    the rest of a test)."""
    import torch

    from iifea_tpu_torch.mesh.io import read_mesh
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator

    A, b = _jax_system(prob.form, M)
    u, info = j_solve_ksp(A, b, method=method, pc="jacobi",
                          bfr_tol=None if ex else 1e-9, monitor=False)
    port = PoissonProblem(read_mesh(path), k=prob.space.degree, sym=True,
                          beta_value=10.0, device="cpu")
    n = port.space.n_nodes
    M_t = (ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), n, device="cpu") if ex
           else ExtractionOperator.identity(n, device="cpu"))
    norms = port.error_norms(M_t.mv(torch.from_numpy(np.array(u))))
    return norms, None if info is None else int(info.iters)


def _same_norms(out, ref, iters):
    for key in ("L2", "H10", "H1"):
        assert _close(out["norms"][key], ref[key]), key
    if iters is not None:
        assert out["info"].iters == iters > 0


def test_torch_poisson_file_demo_matches_jax(root, tmp_path, capsys,
                                             monkeypatch):
    """demos/poisson.py on square/Linear (GMRES with Jacobi) and with
    --beta auto against the JAX demo's steps (the JAX selection gives the
    problem both are held to: the smallest coercive β is 10 here): norms,
    GMRES iterations, the selection's report, the CSV line."""
    of = tmp_path / "p.csv"
    argv = ["--ref", "1", "--mesh-root", root, "--device", "cpu"]
    out = poisson.main(argv + ["--wf", "True", "--of", str(of)])
    auto = poisson.main(argv + ["--beta", "auto"])
    assert ("auto-selected Nitsche beta = 10.0"
            in capsys.readouterr().out)
    path = os.path.join(root, "square/Linear/R1")
    mesh = j_read_mesh(path)
    M = _jax_files(path, JFunctionSpace(mesh, 1).n_nodes)
    import iifea_tpu.ops.projection as j_projection

    _jitted_assembly(monkeypatch, j_projection)
    beta, prob = j_select_beta(mesh, M, k=1, beta0=10.0)
    monkeypatch.undo()
    assert beta == 10.0
    ref, iters = _jax_norms(prob, M, "gmres", path)
    _same_norms(out, ref, iters)
    _same_norms(auto, ref, iters)
    line = of.read_text().split("\n")[1]
    assert line == f"1,{out['norms']['H10']},{out['norms']['L2']},1"


@pytest.mark.parametrize("argv,sub,method,ex", [
    (["--ref", "0", "--k", "2"], "square/Quadratic/R0", "gmres", True),
    (["--ref", "0", "--dim", "3"], "cube/Linear/R0", "direct", True),
    (["--ref", "1", "--Ex", "False"], "square/Linear/R1", "gmres", False),
])
def test_torch_poisson_file_demo_variants_match_jax(root, argv, sub, method,
                                                    ex):
    """demos/poisson.py on P2 square files (Exodus ids), on cube files (the
    direct solve of 3D) and with --Ex False (identity M, bfr 1e-9): norms
    and GMRES iterations against the JAX demo's steps."""
    out = poisson.main(argv + ["--mesh-root", root, "--device", "cpu"])
    path = os.path.join(root, sub)
    k = 2 if "Quadratic" in sub else 1
    mesh = j_read_mesh(path)
    prob = JPoisson(mesh, k=k, sym=True, beta_value=10.0)
    M = (_jax_files(path, prob.space.n_nodes) if ex
         else JExtraction.identity(prob.space.n_nodes))
    _same_norms(out, *_jax_norms(prob, M, method, path, ex))


def test_torch_poisson_file_demo_devices(root, capsys):
    """--devices 2 on a file mesh: each gloo rank reads the files itself;
    norms equal the single-device Jacobi-CG run's (1e-8)."""
    argv = ["--ref", "1", "--mesh-root", root, "--device", "cpu"]
    one = poisson.main(argv + ["--solv", "cg"])
    two = poisson.main(argv + ["--devices", "2"])
    assert "SPMD solve over 2 ranks (gloo)" in capsys.readouterr().out
    for key in ("L2", "H10", "H1"):
        assert _close(two["norms"][key], one["norms"][key]), key


def test_torch_biharmonic_file_demo_matches_jax(root):
    """demos/biharmonic.py on square/Quadratic (P2 on Exodus ids, host LU)
    against the JAX demo's steps: the projected system (A by to_scipy, b)
    to 1e-12 and the relative norms of both solutions through the port's
    error integrals to 1e-8 (those integrals are held against JAX's in
    tests/test_torch_biharmonic.py; JAX's compile for longer than the rest
    of this test runs)."""
    import torch

    from iifea_tpu_torch.mesh.io import read_mesh
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.ops.projection import assemble_background_system

    out = biharmonic.main(["--ref", "0", "--mesh-root", root, "--device",
                           "cpu"])
    path = os.path.join(root, "square/Quadratic/R0")
    prob_j = JBiharmonic(j_read_mesh(path))
    M_j = _jax_files(path, prob_j.space.n_nodes)
    A_j, b_j = _jax_system(prob_j.form, M_j)
    u, _ = j_solve_ksp(A_j, b_j, method="direct", monitor=False)
    prob = BiharmonicProblem(read_mesh(path), device="cpu")
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes,
        device="cpu")
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    S, S_j = A.to_scipy(), A_j.to_scipy()
    assert abs(S - S_j).max() <= 1e-12 * abs(S_j).max()
    b_j = np.asarray(b_j)
    assert np.abs(b.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()
    ref = prob.error_norms(M.mv(torch.from_numpy(np.array(u))))
    for key in ("L2_rel", "H1_rel", "H2_rel"):
        assert _close(out["norms"][key], ref[key]), key


def test_torch_biharmonic3_file_demo(root, monkeypatch):
    """demos/biharmonic.py --dim 3 on cube/Quadratic (P2 tetrahedra on
    Exodus ids, defect-correction Newton on host LU) against the JAX demo's
    steps on the same files: the projected system (A by to_scipy, b) to
    1e-12, the defect-correction iterations equal, and the norms of both
    solutions through the port's error integrals to 1e-8 (those integrals
    are held against JAX's in tests/test_torch_biharmonic3d.py; JAX's 3D
    ones compile for longer than this whole solve runs). The solutions are
    not compared entrywise: this system's diagonal spans 5.8e-8 of its
    largest entry, its solution takes values near 3e10 at foreground nodes
    outside the cube (no norm reads them) that the two LU runs fix only to
    about 1e-5 relative, and on the cube's nodes the two agree to about
    1e-8, the conditioning's limit rather than a margin."""
    import torch

    from iifea_tpu_torch.mesh.io import read_mesh
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import newton

    port_calls = _counted(monkeypatch, newton)
    port_calls.append(0)
    out = biharmonic.main(["--dim", "3", "--ref", "1", "--mesh-root", root,
                           "--device", "cpu"])
    monkeypatch.undo()
    path = os.path.join(root, "cube/Quadratic/R1")
    prob_j = JBiharmonic(j_read_mesh(path))
    M_j = _jax_files(path, prob_j.space.n_nodes)
    u0 = jnp.zeros(prob_j.space.n_dofs)
    # the JAX Newton's own jitted assembly: its solve below reuses it
    blocks, L_b = jnewton._assemble(prob_j.form, u0, M_j, {}, None)
    prob = BiharmonicProblem(read_mesh(path), device="cpu")
    M = ExtractionOperator.from_exop_csv(
        os.path.join(path, "ExOp_Cons.csv"), prob.space.n_nodes,
        device="cpu")
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64), M)
    S, S_j = A.to_scipy(), JBackgroundOperator(prob_j.form, blocks,
                                               M_j).to_scipy()
    assert abs(S - S_j).max() <= 1e-12 * abs(S_j).max()
    L_b = np.asarray(L_b)
    assert np.abs(b.numpy() + L_b).max() <= 1e-12 * np.abs(L_b).max()
    calls = _counted(monkeypatch)
    calls.append(0)
    u_p, _ = jnewton.solve_newtons_linear(
        prob_j.form, u0, M_j, jnp.zeros(M_j.n_bg_dofs), max_iters=20,
        relative_tolerance=1e-12, linear_method="direct",
        monitor_newton=False)
    u_p = np.array(u_p)
    assert port_calls == calls and calls[0] >= 2
    ref = prob.error_norms(M.mv(torch.from_numpy(u_p)))
    for key in ("L2_rel", "H1_rel", "H2_rel"):
        assert _close(out["norms"][key], ref[key]), key


def _counted(monkeypatch, newton=jnewton, per_call=False):
    """Count the linear solves (one a Newton iteration) of a package's
    Newton loops into the last entry of the returned list; with
    ``per_call`` each ``solve_nonlinear`` call opens a new entry."""
    calls = []
    solve = newton.solve_ksp

    def counted(*a, **k):
        calls[-1] += 1
        return solve(*a, **k)

    monkeypatch.setattr(newton, "solve_ksp", counted)
    if per_call:
        outer = newton.solve_nonlinear

        def stepped(*a, **k):
            calls.append(0)
            return outer(*a, **k)

        monkeypatch.setattr(newton, "solve_nonlinear", stepped)
    return calls


def test_torch_tg_file_demo_matches_jax(root, monkeypatch):
    """demos/tg_vortex.py on square/Linear/R2 for two steps (GMRES with
    Jacobi, the trim of --bfr): Newton iterations per step and the
    velocity and pressure norms against the JAX demo's steps, the norms of
    both solutions through the port's error integrals (held against JAX's
    in tests/test_torch_navier_stokes.py; JAX's compile for longer than
    its two steps run)."""
    import torch

    from iifea_tpu_torch import solvers
    from iifea_tpu_torch.solvers import newton

    T, bfr = 0.17, 1e-9
    port_calls = _counted(monkeypatch, newton, per_call=True)
    monkeypatch.setattr(solvers, "solve_nonlinear", newton.solve_nonlinear)
    out = tg_vortex.main(["--ref", str(TG_REF), "--T", str(T), "--bfr",
                          str(bfr), "--mesh-root", root, "--device", "cpu"])
    monkeypatch.undo()
    path = os.path.join(root, f"square/Linear/R{TG_REF}")
    mesh = j_read_mesh(path)
    n_steps = int(np.ceil(T / (4 / np.sqrt(mesh.n_cells))))
    Dt = T / n_steps
    M = _jax_files(path, JFunctionSpace(mesh, 1).n_nodes, 3)
    prob = jns.TaylorGreenProblem(mesh, k=1, Re=100.0, Dt=Dt, sym=False,
                                  n_bg_dofs=M.n_bg_dofs)

    def ic(x):
        u = jns.u_exact(x, prob.nu, 0.0)
        return jnp.array([u[0], u[1], 0.0])

    import iifea_tpu.api as j_api

    _jitted_assembly(monkeypatch, j_api)
    up_p, up_f = j_l2_project(ic, prob.space, prob.cell_dom, M)
    calls = _counted(monkeypatch)
    t = 0.0
    for _ in range(n_steps):
        calls.append(0)
        t += 0.5 * Dt
        up_p, up_f = jnewton.solve_nonlinear(
            prob.form, up_f, M, up_p, aux={"up_old": up_f},
            params={"t": jnp.asarray(t)}, max_iters=10,
            linear_method="gmres", linear_pc="jacobi", n_fields=3,
            bfr_tol=bfr, monitor_newton=False, relative_tolerance=5e-4,
            absolute_tolerance=1e-4, absolute_tolerance_res=1e-5)
        t += 0.5 * Dt
    ref = out["prob"].error_norms(torch.from_numpy(np.array(up_f)), t)
    assert out["n_steps"] == n_steps == 2 and out["t"] == t
    assert port_calls == calls and min(calls) >= 1
    for key in ("L2u", "H1u", "L2p", "H1p"):
        assert _close(out["norms"][key], ref[key]), key


def _shell_pair(root, sub, surface, problem):
    mesh = j_read_mesh(os.path.join(root, sub))
    prob = JKLShell(mesh, surface, **problem)
    return prob, _jax_files(os.path.join(root, sub), prob.space.n_nodes, 3)


def test_torch_pinned_shell_file_demo_matches_jax(root, monkeypatch):
    """demos/pinned_shell.py on square/Quadratic: Newton iterations and the
    centre displacement (its in-plane part zero)."""
    out = pinned_shell.main(["--ref", "0", "--mesh-root", root, "--device",
                             "cpu"])
    prob, M = _shell_pair(root, "square/Quadratic/R0",
                          lambda xi: jnp.array([xi[0], xi[1], 0.0]),
                          pinned_shell.PROBLEM)
    calls = _counted(monkeypatch)
    calls.append(0)
    _, u_f = jnewton.solve_nonlinear(
        prob.form, jnp.zeros(prob.space.n_dofs), M,
        jnp.zeros(M.n_bg_dofs), **pinned_shell.NEWTON)
    disp = prob.evaluate(u_f, [[0.0, 0.0]])[0]
    assert out["newton_iters"] == calls[0] >= 2
    assert _close(out["disp"][2], disp[2])
    assert max(map(abs, out["disp"][:2])) < 1e-10


def test_torch_cut_shell_file_demo_matches_jax(root, monkeypatch, tmp_path):
    """demos/cut_shell.py on bent_tab for two load steps: Newton iterations
    per step and the three tracker histories against the JAX demo's steps;
    --of writes them, --wv the series, and a run resumed from the first
    step's checkpoint ends where the whole run did."""
    monkeypatch.chdir(tmp_path)
    argv = ["--ref", "0", "--steps", "2", "--mesh-root", root, "--device",
            "cpu"]
    ckpt = str(tmp_path / "ckpt")
    out = cut_shell.main(argv + ["--of", "True", "--wv", "True", "--ckpt",
                                 ckpt, "--ckpt-every", "1"])
    prob, M = _shell_pair(
        root, "bent_tab/FG_R0/R0",
        lambda xi: jnp.array([xi[0], xi[1], 0.5 * (1.0 - xi[0] ** 2)]),
        cut_shell.PROBLEM)
    calls = _counted(monkeypatch)
    u_p, u_f = jnp.zeros(M.n_bg_dofs), jnp.zeros(prob.space.n_dofs)
    hist = []
    for i in range(2):
        calls.append(0)
        u_p, u_f = jnewton.solve_nonlinear(
            prob.form, u_f, M, u_p, params={"t": jnp.asarray(0.5 * i)},
            max_iters=100, linear_method="direct", monitor_newton=False)
        hist.append(prob.evaluate(u_f, list(cut_shell.TRACKERS.values())))
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    assert out["newton_iters"] == calls
    for j, name in enumerate(cut_shell.TRACKERS):
        h = np.array([hh[j] for hh in hist])
        assert np.abs(out["hist"][name] - h).max() <= 1e-8 * np.abs(h).max()
        saved = np.loadtxt(f"bent_shell_results/{name}.csv", delimiter=",",
                           skiprows=1)
        assert np.array_equal(saved, out["hist"][name])
    assert os.path.exists("bent_shell_results/disp.pvd")
    with open(os.path.join(ckpt, "latest"), "w") as f:
        f.write("ckpt_00000001.npz")
    again = cut_shell.main(argv + ["--ckpt", ckpt])
    assert again["newton_iters"] == out["newton_iters"][1:]
    assert np.array_equal(again["hist"]["circle_tip"],
                          out["hist"]["circle_tip"])
