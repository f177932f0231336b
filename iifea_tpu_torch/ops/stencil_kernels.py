"""Hand-written CUDA kernels for the 2D stencil apply and Jacobi sweep.

Port of the Pallas TPU kernels ``iifea_tpu/ops/pallas_stencil.py``
(``stencil_mv`` and ``jacobi_smooth``) to Hopper. The CUDA source is
``iifea_tpu_torch/csrc/stencil2d.cu``; it is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/iifea_tpu_torch/`` at the repository
root (a plain C interface loaded with ``ctypes``), keyed by a hash of the
source and flags, so a fresh checkout builds everything it runs.

Dispatch rule of both wrappers: a CPU tensor runs the plain PyTorch version
in this module; a CUDA tensor always launches the kernel (or raises). Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

Layout: coefficients are ``((2r+1)², nx1, ny1)`` contiguous f32 planes with
plane index k = (oi+r)·m + (oj+r); vectors are flat ``(nx1·ny1,)`` with node
id = i·ny1 + j. x is zero outside the lattice.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stencil2d.cu"
BUILD_DIR = _PKG.parent / "build" / "iifea_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# -- plain PyTorch versions (CPU path and the on-card reference) ---------------


def stencil_mv_plain(C, x, shape, radius):
    """y = A x as (2r+1)² shifted multiply-adds over the zero-padded x.

    Any float dtype; x may carry leading batch dims (..., n)."""
    nx1, ny1 = shape
    r = radius
    m = 2 * r + 1
    x2 = x.reshape(*x.shape[:-1], nx1, ny1)
    xp = F.pad(x2, (r, r, r, r))
    y = torch.zeros_like(x2)
    for oi in range(-r, r + 1):
        for oj in range(-r, r + 1):
            k = (oi + r) * m + (oj + r)
            y = y + C[k] * xp[..., oi + r:oi + r + nx1, oj + r:oj + r + ny1]
    return y.reshape(x.shape)


def jacobi_smooth_plain(C, invd, b, x, omega, shape, radius):
    """One weighted-Jacobi sweep x + ω·invd·(b − A x)."""
    return x + omega * invd * (b - stencil_mv_plain(C, x, shape, radius))


# -- build and load -------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the shared library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstencil2d_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the CUDA source unless a library for this exact source and
    flag set exists. The compiler's resource report (registers, shared
    memory, spills) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stencil2d_mv.argtypes = [p, p, p, i, i, i, p]
    lib.stencil2d_mv.restype = i
    lib.stencil2d_jacobi.argtypes = [p, p, p, p, f, p, i, i, i, p]
    lib.stencil2d_jacobi.restype = i
    return lib


# -- wrappers -------------------------------------------------------------------


def _check(C, x, shape, radius, *planes) -> str:
    """Validate the operands; returns the device type ('cpu' or 'cuda')."""
    if radius not in (1, 2):
        raise ValueError(f"radius must be 1 or 2, got {radius}")
    nx1, ny1 = shape
    m = 2 * radius + 1
    if tuple(C.shape) != (m * m, nx1, ny1):
        raise ValueError(
            f"coefficients {tuple(C.shape)} != {(m * m, nx1, ny1)}"
        )
    for v in (x, *planes):
        if tuple(v.shape) != (nx1 * ny1,):
            raise ValueError(f"vector {tuple(v.shape)} != {(nx1 * ny1,)}")
    for t in (C, x, *planes):
        if t.dtype != torch.float32:
            raise TypeError(f"stencil kernels take float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("stencil kernels take contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def stencil_mv(C, x, shape, radius):
    """y = A x (f32). CPU: plain version; CUDA: the stencil2d_mv kernel."""
    if _check(C, x, shape, radius) == "cpu":
        return stencil_mv_plain(C, x, shape, radius)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil2d_mv(
            C.data_ptr(), x.data_ptr(), y.data_ptr(), shape[0], shape[1],
            radius, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil2d_mv")
    stencil_mv.launches += 1
    return y


def jacobi_smooth(C, invd, b, x, omega, shape, radius):
    """y = x + ω·invd·(b − A x) in one pass (f32). CPU: plain version;
    CUDA: the stencil2d_jacobi kernel."""
    if _check(C, x, shape, radius, invd, b) == "cpu":
        return jacobi_smooth_plain(C, invd, b, x, omega, shape, radius)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil2d_jacobi(
            C.data_ptr(), invd.data_ptr(), b.data_ptr(), x.data_ptr(),
            float(omega), y.data_ptr(), shape[0], shape[1], radius,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil2d_jacobi")
    jacobi_smooth.launches += 1
    return y


stencil_mv.launches = 0
jacobi_smooth.launches = 0


def reset_launches() -> None:
    stencil_mv.launches = 0
    jacobi_smooth.launches = 0
