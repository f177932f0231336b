"""Mesh directories in the reference's file layout, generated at tiny sizes
for the mesh-file tests (no JAX here: the port's generators make the
meshes, ``tools/mesh_convert.write_xdmf`` writes ``mesh.xdmf`` + ``mesh.h5``
with h5py, and the port's writers the two CSV files).

``write_family(root, family, ref, lref=0)`` writes one directory under
``root`` at the path the demos read and returns it:

  square/Linear/R{ref}      the rotated cut square (block = material 2),
                            P1 foreground, a P1 background grid
  square/Quadratic/R{ref}   the same in P2 on nested quadratic B-splines
  cube/Linear/R{ref}        the rotated cut cube, P1 on P1
  cube/Quadratic/R{ref}     the same in P2 on nested quadratic B-splines
  hole_in_plate/Linear/R{ref}
                            the fitted quarter plate (material 2) on
                            quadratic B-splines over [0, 4]²
  hole_in_plate/Quadratic/FG_R{lref}/R{ref}
                            the same in P2, the plate marked 1 (the
                            quadratic files' swapped materials)
  bent_tab/FG_R{lref}/R{ref}
                            the trimmed bent tab (block = material 2), P2 on
                            quadratic B-splines over [-1, 1]²

P2 directories carry ``cell_nodes.csv`` on Exodus-style node ids: the
vertices keep their ids, the edge nodes are shuffled (seeded). The ExOp
triples keep the background functions that are nonzero at a node of the
block, renumbered, as the reference's files do.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

from iifea_tpu_torch.mesh.core import FunctionSpace
from iifea_tpu_torch.mesh.generators import (
    bspline_triples,
    exop_triples,
    immersed_cube_bspline_problem,
    immersed_cube_problem,
    immersed_square_bspline_problem,
    immersed_square_problem,
    quarter_plate_mesh,
)
from iifea_tpu_torch.mesh.io import write_cell_nodes, write_exop_triples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("square/Linear", "square/Quadratic", "cube/Linear",
            "cube/Quadratic", "hole_in_plate/Linear",
            "hole_in_plate/Quadratic", "bent_tab")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_convert():
    """``tools/mesh_convert.py`` as a module."""
    return _load("mesh_convert", os.path.join(REPO, "tools",
                                              "mesh_convert.py"))


def exodus_ids(space: FunctionSpace, seed: int = 0) -> np.ndarray:
    """A map from the port's P2 node ids to Exodus-style ids: vertices keep
    theirs, the edge nodes are permuted."""
    n_v = space.mesh.n_verts
    ids = np.arange(space.n_nodes)
    ids[n_v:] = n_v + np.random.default_rng(seed).permutation(
        space.n_nodes - n_v)
    return ids


def family_path(root: str, family: str, ref: int, lref: int = 0) -> str:
    if family in ("hole_in_plate/Quadratic", "bent_tab"):
        return os.path.join(root, family, f"FG_R{lref}", f"R{ref}")
    return os.path.join(root, family, f"R{ref}")


def write_dir(path: str, mesh, triples, cell_nodes=None) -> str:
    """mesh.xdmf + mesh.h5, cell_nodes.csv (P2) and ExOp_Cons.csv."""
    os.makedirs(path, exist_ok=True)
    mesh_convert().write_xdmf(os.path.join(path, "mesh.xdmf"), mesh.coords,
                              mesh.cells, mesh.material)
    if cell_nodes is not None:
        write_cell_nodes(os.path.join(path, "cell_nodes.csv"), cell_nodes)
    write_exop_triples(os.path.join(path, "ExOp_Cons.csv"), *triples)
    return path


def block_nodes(space: FunctionSpace, block_id: int = 2) -> np.ndarray:
    return np.unique(space.cell_dofs[space.mesh.material == block_id])


def family_problem(family: str, ref: int, lref: int = 0):
    """(mesh, triples, cell_nodes or None) of a family at ``ref``; triples
    on the file's node ids."""
    from iifea_tpu_torch.demos.background_unfitted.cut_shell_unfitted import (
        tab_mesh,
    )

    if family == "square/Linear":
        n = 8 * 2 ** ref
        mesh, M = immersed_square_problem(n_fg=n, n_bg=n // 2, device="cpu")
        return mesh, exop_triples(M, block_nodes(FunctionSpace(mesh))), None
    if family == "cube/Linear":
        n = 4 * 2 ** ref
        mesh, M = immersed_cube_problem(n_fg=int(n * 1.19), n_bg=n,
                                        device="cpu")
        return mesh, exop_triples(M, block_nodes(FunctionSpace(mesh))), None
    if family in ("square/Quadratic", "cube/Quadratic"):
        square = family == "square/Quadratic"
        n_bg = (4 if square else 2) * 2 ** ref - 1
        make = (immersed_square_bspline_problem if square
                else immersed_cube_bspline_problem)
        mesh, M, _ = make(n_fg=2 * n_bg, n_bg=n_bg, device="cpu")
        space = FunctionSpace(mesh, degree=2)
        fg, bg, w = exop_triples(M, block_nodes(space))
    else:
        n = 4 * 2 ** ref
        if family == "bent_tab":
            mesh, box, keep = tab_mesh(n), ((-1.0, -1.0), (1.0, 1.0)), 2
        else:
            quad = family == "hole_in_plate/Quadratic"
            mesh = quarter_plate_mesh(n, material=1 if quad else 2)
            box, keep = ((0.0, 0.0), (4.0, 4.0)), 1 if quad else 2
        degree = 1 if family == "hole_in_plate/Linear" else 2
        space = FunctionSpace(mesh, degree=degree)
        fg, bg, w = bspline_triples(space.node_coords, max(n // 2, 2),
                                    *box, keep_nodes=block_nodes(space, keep))
        if degree == 1:
            return mesh, (fg, bg, w), None
    ids = exodus_ids(space, seed=ref)
    return mesh, (ids[fg], bg, w), ids[space.cell_dofs]


def write_family(root: str, family: str, ref: int, lref: int = 0) -> str:
    """Write one family's directory under ``root``; returns its path."""
    mesh, triples, cell_nodes = family_problem(family, ref, lref)
    return write_dir(family_path(root, family, ref, lref), mesh, triples,
                     cell_nodes)
