"""Solution-field export: VTK XML unstructured grids (.vtu) and ParaView
collections (.pvd) (port of ``iifea_tpu/utils/fieldio.py``; host numpy
code, the same files byte for byte).

Plain XML with inline base64 binary DataArrays, readable by ParaView, VisIt
and meshio; no VTK dependency. Local node orderings line up with VTK by
construction: FunctionSpace P2 numbers vertices first, then edge midsides
in (0,1),(1,2),(2,0)[,(0,3),(1,3),(2,3)] order, which is exactly
VTK_QUADRATIC_TRIANGLE (22) / VTK_QUADRATIC_TETRA (24) ordering.

Foreground vectors are node-interleaved (dof = node*n_fields + field);
``point_data`` arrays may be passed flat (n_nodes*nf,) or shaped
(n_nodes, nf), as numpy arrays or tensors on any device (copied to the
host).
"""
from __future__ import annotations

import base64
import os
import struct
import xml.etree.ElementTree as ET

import numpy as np
import torch

_VTK_CELL = {(2, 1): 5, (2, 2): 22, (3, 1): 10, (3, 2): 24}

_VTK_TYPE = {
    np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32", np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _host(a) -> np.ndarray:
    """A numpy view of an array or a tensor (copied off the device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _b64(a: np.ndarray) -> str:
    raw = np.ascontiguousarray(a).tobytes()
    return base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode()


def _data_array(name: str, a: np.ndarray, n_comp: int | None = None) -> str:
    t = _VTK_TYPE[a.dtype]
    comp = f' NumberOfComponents="{n_comp}"' if n_comp else ""
    nm = f' Name="{name}"' if name else ""
    return (f'<DataArray type="{t}"{nm}{comp} format="binary">'
            f"{_b64(a)}</DataArray>")


def _norm_point_data(data, n_nodes: int):
    """-> list of (name, (n_nodes, c) float64 array with c in (1, 3))."""
    out = []
    for name, a in (data or {}).items():
        a = _host(a).astype(np.float64)
        if a.ndim == 1 and a.size != n_nodes:
            if a.size % n_nodes:
                raise ValueError(
                    f"point_data '{name}' has {a.size} entries for "
                    f"{n_nodes} nodes"
                )
            a = a.reshape(n_nodes, a.size // n_nodes)
        if a.ndim == 1:
            a = a[:, None]
        if a.shape[1] == 2:   # ParaView vectors are 3-component
            a = np.hstack([a, np.zeros((n_nodes, 1))])
        out.append((name, a))
    return out


def write_vtu(path, space_or_mesh, point_data=None, cell_data=None,
              points=None):
    """Write one unstructured-grid snapshot.

    ``space_or_mesh``: a FunctionSpace (P1/P2 nodes become VTK points, cells
    become (quadratic) simplices) or a Mesh (P1 view). ``point_data`` maps
    name -> nodal array (flat interleaved or (n_nodes, nf)); ``cell_data``
    maps name -> per-cell array (e.g. ``mesh.material``). ``points``
    overrides the node coordinates (n_nodes, 2|3) — e.g. a shell's mapped
    3D midsurface in place of its 2D parametric domain."""
    mesh = getattr(space_or_mesh, "mesh", space_or_mesh)
    space = space_or_mesh if hasattr(space_or_mesh, "cell_dofs") else None
    if space is not None:
        points = np.asarray(
            space.node_coords if points is None else points, dtype=np.float64
        )
        cells = np.asarray(space.cell_dofs, dtype=np.int64)
        degree = space.degree
    else:
        points = np.asarray(
            mesh.coords if points is None else points, dtype=np.float64
        )
        cells = np.asarray(mesh.cells, dtype=np.int64)
        degree = 1
    dim = points.shape[1]
    n_nodes, n_cells = points.shape[0], cells.shape[0]
    if dim == 2:
        points = np.hstack([points, np.zeros((n_nodes, 1))])
    ctype = _VTK_CELL[(dim, degree)]

    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n_nodes}" NumberOfCells="{n_cells}">',
        "<Points>",
        _data_array("", points, n_comp=3),
        "</Points>",
        "<Cells>",
        _data_array("connectivity", cells.ravel().astype(np.int64)),
        _data_array(
            "offsets",
            (np.arange(1, n_cells + 1) * cells.shape[1]).astype(np.int64),
        ),
        _data_array("types", np.full(n_cells, ctype, dtype=np.uint8)),
        "</Cells>",
    ]
    pdata = _norm_point_data(point_data, n_nodes)
    if pdata:
        parts.append("<PointData>")
        for name, a in pdata:
            parts.append(_data_array(
                name, a, n_comp=a.shape[1] if a.shape[1] > 1 else None
            ))
        parts.append("</PointData>")
    if cell_data:
        parts.append("<CellData>")
        for name, a in cell_data.items():
            a = _host(a)
            if not np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.int32)
            parts.append(_data_array(name, a))
        parts.append("</CellData>")
    parts += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as f:
        f.write("\n".join(parts))


def _decode(el) -> np.ndarray:
    dt = {v: k for k, v in _VTK_TYPE.items()}[el.get("type")]
    raw = base64.b64decode(el.text.strip())
    (nbytes,) = struct.unpack("<Q", raw[:8])
    a = np.frombuffer(raw[8:8 + nbytes], dtype=dt)
    nc = int(el.get("NumberOfComponents") or 1)
    return a.reshape(-1, nc) if nc > 1 else a


def read_vtu(path):
    """Round-trip reader (tests + downstream tooling): returns a dict with
    points, cells, cell_type, point_data, cell_data."""
    root = ET.parse(path).getroot()
    piece = root.find("UnstructuredGrid/Piece")
    arrays = {"Points": {}, "Cells": {}, "PointData": {}, "CellData": {}}
    for sec in arrays:
        node = piece.find(sec)
        if node is None:
            continue
        for i, el in enumerate(node.findall("DataArray")):
            arrays[sec][el.get("Name") or f"_{i}"] = _decode(el)
    conn = arrays["Cells"]["connectivity"]
    offs = arrays["Cells"]["offsets"]
    nloc = int(offs[0])
    return {
        "points": next(iter(arrays["Points"].values())),
        "cells": conn.reshape(-1, nloc),
        "cell_type": int(arrays["Cells"]["types"][0]),
        "point_data": arrays["PointData"],
        "cell_data": arrays["CellData"],
    }


class PVDSeries:
    """ParaView time-series collection: one .pvd indexing per-step .vtu files
    (the File("...pvd") role, cut_shell.py:342-349). The .pvd is rewritten on
    every snapshot so a crashed/interrupted run still opens cleanly."""

    def __init__(self, path: str):
        if not str(path).endswith(".pvd"):
            path = str(path) + ".pvd"
        self.path = str(path)
        self.base = os.path.splitext(self.path)[0]
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._steps: list[tuple[float, str]] = []

    def write(self, t: float, space_or_mesh, point_data=None, cell_data=None,
              points=None):
        fn = f"{self.base}_{len(self._steps):06d}.vtu"
        write_vtu(fn, space_or_mesh, point_data, cell_data, points=points)
        self._steps.append((float(t), os.path.basename(fn)))
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" '
            'byte_order="LittleEndian">',
            "<Collection>",
        ]
        lines += [
            f'<DataSet timestep="{ts}" group="" part="0" file="{f}"/>'
            for ts, f in self._steps
        ]
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.path, "w") as f:
            f.write("\n".join(lines))
