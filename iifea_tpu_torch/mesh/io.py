"""Readers of the reference mesh pipeline's files (port of
``iifea_tpu/mesh/io.py``).

The files are what the offline converter writes (``tools/mesh_convert.py``):
``mesh.xdmf`` with ``mesh.h5`` (datasets data0 = coordinates, data1 =
connectivity, data2 = cell material), ``cell_nodes.csv`` (the Exodus
TRI6/TET10 connectivity of quadratic meshes) and ``ExOp_Cons.csv``
extraction triples ("%d %d %1.16f", ids 1-based). h5py is imported inside
``read_mesh`` only: the CSV readers need numpy alone. The triples are read
with ``np.loadtxt`` (the reference's accelerated reader parses the same
text), and no platform is chosen here: the caller gives each problem its
device. ``write_exop_triples`` and ``write_cell_nodes`` write the two
CSV files in the same layout.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from iifea_tpu_torch.mesh.core import Mesh


def _h5_datasets_from_xdmf(xdmf_path: str) -> dict[str, tuple[str, str]]:
    """Map logical names -> (h5 file, dataset path) from the XDMF index:
    "coords", "cells" and one entry per cell attribute."""
    root = ET.parse(xdmf_path).getroot()
    out: dict[str, tuple[str, str]] = {}

    def data_item(el):
        txt = (el.text or "").strip()
        m = re.match(r"(.+?):(/.+)", txt)
        return (m.group(1), m.group(2)) if m else (txt, "")

    for geom in root.iter("Geometry"):
        out["coords"] = data_item(geom.find("DataItem"))
    for topo in root.iter("Topology"):
        out["cells"] = data_item(topo.find("DataItem"))
    for attr in root.iter("Attribute"):
        out[attr.get("Name", "attr")] = data_item(attr.find("DataItem"))
    return out


def require_mesh_dir(path: str, need_exop: bool = True) -> str:
    """Exit the program, naming the missing path, unless the mesh directory
    ``path`` holds ``mesh.xdmf`` and (with ``need_exop``) ``ExOp_Cons.csv``;
    returns ``path``. The demos' check before they read their files."""
    import sys

    for name in ("mesh.xdmf",) + (("ExOp_Cons.csv",) if need_exop else ()):
        if not os.path.exists(os.path.join(path, name)):
            sys.exit(f"no {os.path.join(path, name)}: the reference's mesh "
                     "files")
    return path


def read_mesh(path: str) -> Mesh:
    """Read a mesh directory (its ``mesh.xdmf``) or an ``.xdmf`` file with
    its sibling ``.h5``: the 'material' cell attribute when present, and
    ``cell_nodes.csv`` (quadratic connectivity) when the directory has
    one. Raises ImportError without h5py."""
    import h5py

    xdmf = os.path.join(path, "mesh.xdmf") if os.path.isdir(path) else path
    base = os.path.dirname(xdmf)
    dsets = _h5_datasets_from_xdmf(xdmf)

    def load(key):
        fname, dpath = dsets[key]
        with h5py.File(os.path.join(base, fname), "r") as f:
            return np.array(f[dpath])

    material = (load("material").astype(np.int32) if "material" in dsets
                else None)
    cn_path = os.path.join(base, "cell_nodes.csv")
    cell_nodes = read_cell_nodes(cn_path) if os.path.exists(cn_path) else None
    return Mesh(load("coords"), load("cells"), material, cell_nodes)


def read_cell_nodes(path: str) -> np.ndarray:
    """Exodus high-order connectivity, one comma-separated row per cell."""
    return np.loadtxt(path, delimiter=",", dtype=np.int64).astype(np.int32)


def read_exop_triples(paths: str | list[str]) -> np.ndarray:
    """Extraction triples (fg_exo_id, bg_id, weight) of one file or of
    several, concatenated in order: whitespace-delimited, ids 1-based and
    kept so. Returns a (nnz, 3) float64 array."""
    if isinstance(paths, str):
        paths = [paths]
    return np.concatenate([np.atleast_2d(np.loadtxt(p, dtype=np.float64))
                           for p in paths], axis=0)


def write_exop_triples(path: str, fg, bg, w) -> None:
    """Write 0-based (fg node, bg id, weight) triples as an ExOp file: ids
    1-based, one triple a line. The converter writes the weight as
    "%1.16f"; here it takes 17 significant digits, so the file reads back
    to the same doubles."""
    data = np.stack([np.asarray(fg, np.float64) + 1,
                     np.asarray(bg, np.float64) + 1,
                     np.asarray(w, np.float64)], axis=1)
    np.savetxt(path, data, fmt="%d %d %.17g")


def write_cell_nodes(path: str, cell_nodes: np.ndarray) -> None:
    """Write P2 connectivity as ``cell_nodes.csv``."""
    np.savetxt(path, np.asarray(cell_nodes), fmt="%d", delimiter=",")
