"""The port's mesh-file door (iifea_tpu_torch/mesh/io.py,
ExtractionOperator.from_exop_csv, Mesh(cell_nodes=) with the P2 space on
Exodus node ids) vs the JAX package on the same generated files
(tests/torch_mesh_fixtures.py; the specs are iifea_tpu/mesh/io.py,
ops/extraction.py:133-150, mesh/core.py:51-68, :205-223 and
tests/test_tools.py).

Tolerances: everything read from a file equals the JAX package's reading
exactly (the same parse of the same text); the Exodus-id P2 node
coordinates too (the same midpoint arithmetic)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from iifea_tpu.mesh.core import FunctionSpace as JFunctionSpace
from iifea_tpu.mesh.core import Mesh as JMesh
from iifea_tpu.mesh.io import read_exop_triples as j_read_exop_triples
from iifea_tpu.mesh.io import read_mesh as j_read_mesh
from iifea_tpu.ops.extraction import ExtractionOperator as JExtraction
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.mesh import io
from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
from iifea_tpu_torch.ops.extraction import ExtractionOperator

from torch_mesh_fixtures import (
    FAMILIES,
    REPO,
    exodus_ids,
    family_problem,
    write_family,
)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{family: its directory} at ref 1."""
    root = str(tmp_path_factory.mktemp("meshes"))
    return {fam: write_family(root, fam, 1) for fam in FAMILIES}


def _same_mesh(m, m_j):
    assert np.array_equal(m.coords, m_j.coords)
    assert m.coords.dtype == m_j.coords.dtype == np.float64
    assert np.array_equal(m.cells, m_j.cells)
    assert np.array_equal(m.material, m_j.material)
    if m_j.cell_nodes is None:
        assert m.cell_nodes is None
    else:
        assert np.array_equal(m.cell_nodes, m_j.cell_nodes)


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_read_mesh_matches_jax(files, family):
    """Coordinates, cells, material and cell_nodes, from the directory and
    from its .xdmf file."""
    path = files[family]
    m, m_j = io.read_mesh(path), j_read_mesh(path)
    _same_mesh(m, m_j)
    _same_mesh(io.read_mesh(os.path.join(path, "mesh.xdmf")), m_j)
    quadratic = "Quadratic" in family or family == "bent_tab"
    assert (m.cell_nodes is not None) == quadratic
    assert set(np.unique(m.material)) <= {1, 2}


def test_torch_read_exop_triples_matches_jax(files, tmp_path):
    """One path, and a list of two blocks concatenated in order; ids stay
    1-based."""
    path = os.path.join(files["hole_in_plate/Linear"], "ExOp_Cons.csv")
    tri = io.read_exop_triples(path)
    assert np.array_equal(tri, j_read_exop_triples(path))
    assert tri.dtype == np.float64 and tri.shape[1] == 3
    assert tri[:, :2].min() == 1
    lines = open(path).read().splitlines()
    parts = [tmp_path / "a.csv", tmp_path / "b.csv"]
    parts[0].write_text("\n".join(lines[:5]) + "\n")
    parts[1].write_text("\n".join(lines[5:]) + "\n")
    both = io.read_exop_triples([str(p) for p in parts])
    assert np.array_equal(both, j_read_exop_triples([str(p) for p in parts]))
    assert np.array_equal(both, tri)
    # one line alone is still (1, 3)
    one = tmp_path / "one.csv"
    one.write_text(lines[0] + "\n")
    assert io.read_exop_triples(str(one)).shape == (1, 3)


@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_torch_from_exop_csv_matches_jax(files, n_fields):
    """M from the P2 bent tab's file (Exodus foreground ids) with 1, 2 and 3
    fields equals the JAX package's, through to_scipy; a foreground id 0
    is dropped."""
    path = os.path.join(files["bent_tab"], "ExOp_Cons.csv")
    n_nodes = FunctionSpace(io.read_mesh(files["bent_tab"]), 2).n_nodes
    M = ExtractionOperator.from_exop_csv(path, n_nodes, n_fields=n_fields,
                                         device="cpu")
    M_j = JExtraction.from_exop_csv(path, n_nodes, n_fields=n_fields)
    assert (M.n_fg_dofs, M.n_bg_dofs) == (M_j.n_fg_dofs, M_j.n_bg_dofs)
    assert M.n_fg_dofs == n_nodes * n_fields
    A, A_j = M.to_scipy(), M_j.to_scipy()
    assert (A != A_j).nnz == 0 and A.nnz == A_j.nnz > 0
    with_zero = path + ".zero"
    with open(with_zero, "w") as f:
        f.write(open(path).read() + "0 1 0.5\n")
    assert (ExtractionOperator.from_exop_csv(
        with_zero, n_nodes, n_fields=n_fields, device="cpu").to_scipy()
        != A).nnz == 0


def test_torch_exop_round_trip_is_bitwise(tmp_path):
    """M read back from a written ExOp file equals M of the in-memory
    triples bitwise (17 significant digits per weight)."""
    mesh, (fg, bg, w), cn = family_problem("hole_in_plate/Quadratic", 1)
    io.write_exop_triples(str(tmp_path / "e.csv"), fg, bg, w)
    n_nodes = int(cn.max()) + 1
    M = ExtractionOperator.from_exop_csv(str(tmp_path / "e.csv"), n_nodes,
                                         n_fields=2, device="cpu")
    M0 = ExtractionOperator.from_triples(fg, bg, w, n_nodes, n_fields=2,
                                         device="cpu")
    assert (M.to_scipy() != M0.to_scipy()).nnz == 0
    assert np.array_equal(M.val_np, M0.val_np)


@pytest.mark.parametrize("family", ["square/Quadratic", "cube/Quadratic",
                                    "bent_tab", "hole_in_plate/Quadratic"])
def test_torch_exodus_p2_space_matches_jax(files, family):
    """A P2 space on a mesh with cell_nodes takes the Exodus ids: cell_dofs,
    n_nodes (max + 1), node_coords and flat_cell_dofs equal JAX's; the same
    mesh without cell_nodes keeps the port's own numbering."""
    m = io.read_mesh(files[family])
    m_j = JMesh(m.coords, m.cells, m.material, m.cell_nodes)
    for n_fields in (1, 3):
        V, V_j = FunctionSpace(m, 2, n_fields), JFunctionSpace(m_j, 2,
                                                                n_fields)
        assert np.array_equal(V.cell_dofs, V_j.cell_dofs)
        assert np.array_equal(V.cell_dofs, m.cell_nodes)
        assert V.n_nodes == V_j.n_nodes == int(m.cell_nodes.max()) + 1
        assert V.n_dofs == V_j.n_dofs
        assert np.array_equal(V.node_coords, V_j.node_coords)
        assert np.array_equal(V.flat_cell_dofs(), V_j.flat_cell_dofs())
    own = FunctionSpace(Mesh(m.coords, m.cells, m.material), 2)
    assert np.array_equal(own.cell_dofs, Mesh(m.coords, m.cells).p2_nodes[0])
    # the files' ids are a permutation of the port's own numbering
    ids = exodus_ids(own, seed=1)
    assert np.array_equal(ids[own.cell_dofs], m.cell_nodes)
    assert np.array_equal(V.node_coords[ids], own.node_coords)


def test_torch_exodus_p2_space_refuses_wrong_width():
    m = Mesh(np.array([[0., 0.], [1., 0.], [0., 1.]]), np.array([[0, 1, 2]]),
             cell_nodes=np.array([[0, 1, 2, 3]]))
    with pytest.raises(ValueError, match="expected 6"):
        FunctionSpace(m, 2)


def test_torch_flat_cell_dofs_matches_jax(files):
    """P1 and P2 interleaved dof ids for 1 to 3 fields."""
    m = io.read_mesh(files["square/Linear"])
    m_j = j_read_mesh(files["square/Linear"])
    for degree in (1, 2):
        for nf in (1, 2, 3):
            V = FunctionSpace(m, degree, nf)
            V_j = JFunctionSpace(m_j, degree, nf)
            assert np.array_equal(V.flat_cell_dofs(), V_j.flat_cell_dofs())


def test_torch_from_numpy_state_carries_cell_nodes(files):
    """A JAX Mesh read from files crosses over whole."""
    m_j = j_read_mesh(files["hole_in_plate/Quadratic"])
    st = from_numpy_state(coords=m_j.coords, cells=m_j.cells,
                          material=m_j.material, cell_nodes=m_j.cell_nodes,
                          device="cpu")
    _same_mesh(st.mesh, m_j)
    assert FunctionSpace(st.mesh, 2).n_nodes == JFunctionSpace(m_j,
                                                               2).n_nodes


def test_torch_mesh_convert_exodus_round_trip(tmp_path):
    """tools/mesh_convert.py on an Exodus file of the P2 bent tab (two
    blocks, TRI6, corners numbered first), then both packages' read_mesh on
    its output: equal, and equal to the mesh written."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "test_tools_writer", os.path.join(REPO, "tests", "test_tools.py"))
    tools_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_test)
    mesh, _, cn = family_problem("bent_tab", 0)
    pts = np.zeros((int(cn.max()) + 1, 3))
    V = FunctionSpace(Mesh(mesh.coords, mesh.cells, mesh.material, cn), 2)
    pts[:, :2] = V.node_coords
    blocks = [("TRI6", cn[mesh.material == b]) for b in (1, 2)]
    exo = tmp_path / "tab.exo"
    tools_test.write_exodus_netcdf3(str(exo), pts, blocks)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mesh_convert.py"),
         "--fi", str(exo), "--fo", str(tmp_path / "mesh.xdmf")],
        capture_output=True, text=True, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    m, m_j = io.read_mesh(str(tmp_path)), j_read_mesh(str(tmp_path))
    _same_mesh(m, m_j)
    order = np.concatenate([np.where(mesh.material == b)[0] for b in (1, 2)])
    assert np.array_equal(m.cell_nodes, cn[order])
    assert np.array_equal(m.cells, mesh.cells[order])
    assert np.array_equal(m.material, mesh.material[order])
    assert np.array_equal(m.coords, mesh.coords)


def test_torch_read_mesh_needs_h5py(files, monkeypatch):
    """Without h5py, read_mesh raises the ImportError that names it: no
    fallback. The CSV readers need numpy alone."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        io.read_mesh(files["square/Linear"])
    path = files["square/Quadratic"]
    assert io.read_cell_nodes(os.path.join(path, "cell_nodes.csv")).ndim == 2
    assert io.read_exop_triples(os.path.join(path, "ExOp_Cons.csv")).ndim == 2


@pytest.mark.parametrize("present,need_exop,missing", [
    ((), True, "mesh.xdmf"),
    (("mesh.xdmf",), True, "ExOp_Cons.csv"),
    (("mesh.xdmf",), False, None),
    (("mesh.xdmf", "ExOp_Cons.csv"), True, None),
])
def test_torch_require_mesh_dir(tmp_path, present, need_exop, missing):
    """The demos' check of a mesh directory: it exits naming the first
    missing file (ExOp_Cons.csv only where it is needed) and otherwise
    returns the directory."""
    for name in present:
        (tmp_path / name).write_text("")
    if missing is None:
        assert io.require_mesh_dir(str(tmp_path), need_exop) == str(tmp_path)
        return
    with pytest.raises(SystemExit,
                       match=re.escape(f"no {tmp_path / missing}:")):
        io.require_mesh_dir(str(tmp_path), need_exop)
