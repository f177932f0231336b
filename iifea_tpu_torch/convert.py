"""Carry the reference package's state into the port.

The system has no weights; its state is the foreground mesh, the extraction
operator and the stencil coefficients. ``from_numpy_state`` builds the
port's objects from the JAX package's objects given as numpy arrays, so
both packages can start from identical state:

    >>> st = from_numpy_state(
    ...     coords=mesh.coords, cells=mesh.cells, material=mesh.material,
    ...     idx=M.idx_np, val=M.val_np, n_bg_dofs=M.n_bg_dofs,
    ...     coeffs=np.asarray(S.coeffs), lattice_shape=S.shape,
    ...     radius=S.radius, device="cpu")

``coeffs`` must be the logical (m², nx1, ny1) or (m³, nx1, ny1, nz1)
planes (``S.coeffs``), never the TPU tile-padded storage, or a block
operator's (nF, nF, m², nx1, ny1) or (nF, nF, m³, nx1, ny1, nz1) planes;
their rank picks ``StencilOperator2D``, ``StencilOperator3D``,
``StencilOperatorBlock2D`` or ``StencilOperatorBlock3D``.
A tetrahedron mesh (3D coords, 4 vertices per cell) is carried like a
triangle mesh.

A time-stepping run's state is not carried here but by its checkpoint
directory (``utils/checkpoint.py``), whose files both packages write and
read alike. The Taylor-Green vortex's state is the pair ``up_p`` (the
background dof vector at the step's end) and ``up_old_f`` (the foreground
field of the step before, the VMS kernel's ``up_old``), with the step and
``t`` in its ``.meta.json``: ``demos/tg_vortex.py --ckpt DIR`` resumes a
directory written by either package's demo.

A Kirchhoff-Love shell's state is its numpy mesh (``coords``, ``cells``,
``material``) through ``from_numpy_state`` and the vectors ``u_f`` (the
foreground displacement, node-interleaved) and ``u_p`` (the background
one); the B-spline extraction M is rebuilt in each package from the same
node coordinates (``BSplineSpace2D.transfer_matrix``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from iifea_tpu_torch.mesh.core import Mesh
from iifea_tpu_torch.ops.extraction import ExtractionOperator
from iifea_tpu_torch.ops.stencil import (
    StencilOperator2D,
    StencilOperator3D,
    StencilOperatorBlock2D,
    StencilOperatorBlock3D,
)


class State(NamedTuple):
    mesh: Mesh | None
    M: ExtractionOperator | None
    S: (StencilOperator2D | StencilOperator3D | StencilOperatorBlock2D
        | StencilOperatorBlock3D | None)


def from_numpy_state(*, coords=None, cells=None, material=None, idx=None,
                     val=None, n_bg_dofs=None, coeffs=None,
                     lattice_shape=None, radius: int = 2,
                     device) -> State:
    """Build whichever of (Mesh, ExtractionOperator, stencil operator) the
    given arrays determine; the others are None."""
    mesh = None
    if coords is not None:
        mesh = Mesh(np.asarray(coords), np.asarray(cells),
                    None if material is None else np.asarray(material))
    M = None
    if idx is not None:
        M = ExtractionOperator(np.asarray(idx), np.asarray(val), n_bg_dofs,
                               device)
    S = None
    if coeffs is not None:
        C = np.array(coeffs)
        shape = tuple(lattice_shape)
        if C.shape[-len(shape):] != shape:
            raise ValueError(
                f"coefficient planes {C.shape} do not match lattice {shape} "
                "(pass the logical S.coeffs, not the padded S.cp)"
            )
        cls = {3: StencilOperator2D, 4: StencilOperator3D,
               5: StencilOperatorBlock2D, 6: StencilOperatorBlock3D}[C.ndim]
        S = cls(torch.as_tensor(C, device=device), shape, radius)
    return State(mesh, M, S)
