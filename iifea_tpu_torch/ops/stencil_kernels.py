"""Hand-written CUDA kernels for the 2D and 3D stencil applies and
smoothing sweeps.

Port of the Pallas TPU kernels of ``iifea_tpu/ops/pallas_stencil.py`` to
Hopper: ``stencil_mv``/``jacobi_smooth`` (``csrc/stencil2d.cu``, which also
holds the two entries built on them for block operators and small lattices:
``stencil_mv_block``, a block (multi-field) apply or residual b − A x in
one launch, and ``smooth``, a multigrid level's ν sweeps and trailing
residual in one launch) and
``stencil_mv3``/``jacobi_smooth3`` (``csrc/stencil3d.cu``, which also holds
the fused Chebyshev step ``cheb_step3`` of the 3D V-cycle smoother and
``stencil3d_block``, the 3D block apply, residual and point-block sweep in
one launch). Every
``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` at first use
(one nvcc per source, run together, then one link) into one shared library
in ``build/iifea_tpu_torch/`` at the repository root (a plain C interface
loaded with ``ctypes``), keyed by a hash of all sources and the flags, so a
fresh checkout builds everything it runs.

Dispatch rule of every wrapper: a CPU tensor runs the plain PyTorch version
in this module; a CUDA tensor always launches the kernel (or raises). Each
wrapper counts its kernel launches in ``<wrapper>.launches``; a smoothing
call that takes one launch per pass counts its sweeps under
``jacobi_smooth`` and its residual under ``stencil_mv_block``.

Layout: 2D coefficients are ``((2r+1)², nx1, ny1)`` contiguous f32 planes
with plane index k = (oi+r)·m + (oj+r) and node id i·ny1 + j; 3D ones are
``((2r+1)³, nx1, ny1, nz1)`` with k = ((oi+r)·m + (oj+r))·m + (ok+r) and
node id (i·ny1 + j)·nz1 + k. Vectors are flat. x is zero outside the
lattice. A 2D block operator's coefficients are (nF, nF, (2r+1)², nx1, ny1)
on field-blocked vectors (nF·n,), its nodal smoother blocks (nF, nF, n);
scalar planes are the nF = 1 case (smoother "block": the flat 1/diag). A 3D
block operator's are (nF, nF, (2r+1)³, nx1, ny1, nz1) likewise.
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
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "iifea_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def stencil_mv_block_plain(C, x, shape, radius):
    """Block apply y[f1] = Σ_f2 C[f1, f2] ⋆ x[f2] on field-blocked vectors
    (nF·n,); C is (nF, nF, (2r+1)², nx1, ny1). x may carry leading batch
    dims (..., nF·n)."""
    nF = C.shape[0]
    xs = x.reshape(*x.shape[:-1], nF, -1)
    y = torch.stack([
        sum(stencil_mv_plain(C[f1, f2], xs[..., f2, :], shape, radius)
            for f2 in range(nF))
        for f1 in range(nF)
    ], dim=-2)
    return y.reshape(x.shape)


def jacobi_smooth_plain(C, invd, b, x, omega, shape, radius):
    """One weighted-Jacobi sweep x + ω·invd·(b − A x)."""
    return x + omega * invd * (b - stencil_mv_plain(C, x, shape, radius))


def apply_plain(C, x, shape, radius):
    """A x for scalar planes (C 3-D) or a block operator (C 5-D)."""
    mv = stencil_mv_plain if C.dim() == 3 else stencil_mv_block_plain
    return mv(C, x, shape, radius)


def residual_plain(C, b, x, shape, radius):
    """b − A x for scalar planes or a block operator."""
    return b - apply_plain(C, x, shape, radius)


def sweep_plain(C, binv, b, x, omega, shape, radius):
    """One sweep x + ω·Binv·(b − A x): weighted Jacobi on scalar planes
    (``binv`` the flat 1/diag) or point-block Jacobi on a block operator
    (``binv`` the (nF, nF, n) nodal blocks)."""
    if C.dim() == 3:
        return jacobi_smooth_plain(C, binv, b, x, omega, shape, radius)
    r = residual_plain(C, b, x, shape, radius).reshape(1, C.shape[0], -1)
    return x + omega * (binv * r).sum(dim=1).reshape(-1)


def smooth_plain(C, binv, b, x, omega, sweeps, shape, radius,
                 with_residual=False):
    """``sweeps`` sweeps of ``sweep_plain`` from x (None: from zero);
    returns x_ν, or (x_ν, b − A x_ν) when ``with_residual``."""
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(sweeps):
        x = sweep_plain(C, binv, b, x, omega, shape, radius)
    if with_residual:
        return x, residual_plain(C, b, x, shape, radius)
    return x


def stencil_mv3_plain(C, x, shape, radius):
    """y = A x as (2r+1)³ shifted multiply-adds over the zero-padded x.

    Any float dtype; x may carry leading batch dims (..., n)."""
    nx1, ny1, nz1 = shape
    r = radius
    m = 2 * r + 1
    x3 = x.reshape(*x.shape[:-1], nx1, ny1, nz1)
    xp = F.pad(x3, (r, r, r, r, r, r))
    y = torch.zeros_like(x3)
    for oi in range(m):
        for oj in range(m):
            for ok in range(m):
                k = (oi * m + oj) * m + ok
                y = y + C[k] * xp[..., oi:oi + nx1, oj:oj + ny1,
                                  ok:ok + nz1]
    return y.reshape(x.shape)


def jacobi_smooth3_plain(C, invd, b, x, omega, shape, radius):
    """One 3D weighted-Jacobi sweep x + ω·invd·(b − A x)."""
    return x + omega * invd * (b - stencil_mv3_plain(C, x, shape, radius))


def cheb_step3_plain(C, invd, b, x, d, alpha, beta, shape, radius):
    """One Chebyshev smoothing step: r = invd·(b − A x), d' = α·r + β·d,
    x' = x + d'. ``d`` is None on the first step (β = 0). Returns
    (x', d')."""
    r = invd * (b - stencil_mv3_plain(C, x, shape, radius))
    dn = alpha * r if d is None else alpha * r + beta * d
    return x + dn, dn


def apply3_block_plain(C, x, shape, radius):
    """3D A x for scalar planes (C 4-D) or a block operator (C 6-D,
    (nF, nF, (2r+1)³, nx1, ny1, nz1)) on field-blocked vectors (nF·n,); x
    may carry leading batch dims."""
    if C.dim() == 4:
        return stencil_mv3_plain(C, x, shape, radius)
    nF = C.shape[0]
    xs = x.reshape(*x.shape[:-1], nF, -1)
    y = torch.stack([
        sum(stencil_mv3_plain(C[f1, f2], xs[..., f2, :], shape, radius)
            for f2 in range(nF))
        for f1 in range(nF)
    ], dim=-2)
    return y.reshape(x.shape)


def residual3_block_plain(C, b, x, shape, radius):
    """3D b − A x for scalar planes or a block operator."""
    return b - apply3_block_plain(C, x, shape, radius)


def sweep3_block_plain(C, binv, b, x, omega, shape, radius):
    """One 3D sweep x + ω·Binv·(b − A x) from x (None: from zero, ω·Binv·b):
    weighted Jacobi on scalar planes (``binv`` the flat 1/diag) or
    point-block Jacobi on a block operator (``binv`` (nF, nF, n))."""
    r = b if x is None else residual3_block_plain(C, b, x, shape, radius)
    if C.dim() == 4:
        d = omega * binv * r
    else:
        d = omega * (binv * r.reshape(1, C.shape[0], -1)).sum(dim=1).reshape(-1)
    return d if x is None else x + d


# -- build and load -------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstencil_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every CUDA source unless a library for these exact sources
    and flags exists: one nvcc per source, all started together, then one
    link. The compiler's resource report (registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    jobs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    for cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
        log.append(stdout + stderr)
    tmp = out.with_name(f"{tag}.tmp")
    cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}"
        )
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stencil2d_mv.argtypes = [p, p, p, i, i, i, p]
    lib.stencil2d_block.argtypes = [p, p, p, p, f, p, i, i, i, i, i, p]
    lib.stencil2d_smooth.argtypes = [p, p, p, p, f, i, p, p, p, i, i, i, i,
                                     p]
    lib.stencil2d_smooth_plan.argtypes = [i, i, i, i]
    lib.stencil3d_mv.argtypes = [p, p, p, i, i, i, i, p]
    lib.stencil3d_jacobi.argtypes = [p, p, p, p, f, p, i, i, i, i, p]
    lib.stencil3d_cheb.argtypes = [p, p, p, p, p, f, f, p, i, i, i, i, p]
    lib.stencil3d_block.argtypes = [p, p, p, p, f, p, i, i, i, i, i, i, p]
    for fn in (lib.stencil2d_mv, lib.stencil2d_block,
               lib.stencil2d_smooth, lib.stencil2d_smooth_plan,
               lib.stencil3d_mv, lib.stencil3d_jacobi, lib.stencil3d_cheb,
               lib.stencil3d_block):
        fn.restype = i
    return lib


# -- wrappers -------------------------------------------------------------------


def _check(C, x, shape, radius, *planes, dim: int = 2) -> str:
    """Validate the operands of a ``dim``-D kernel; returns the device type
    ('cpu' or 'cuda')."""
    if radius not in (1, 2):
        raise ValueError(f"radius must be 1 or 2, got {radius}")
    shape = tuple(shape)
    if len(shape) != dim:
        raise ValueError(f"a {dim}D kernel got the lattice shape {shape}")
    m = 2 * radius + 1
    want = (m ** len(shape), *shape)
    if tuple(C.shape) != want:
        raise ValueError(f"coefficients {tuple(C.shape)} != {want}")
    n = 1
    for s_ in shape:
        n *= s_
    for v in (x, *planes):
        if tuple(v.shape) != (n,):
            raise ValueError(f"vector {tuple(v.shape)} != {(n,)}")
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


# passes of the stencil2d_block and stencil3d_block entries
_APPLY, _RESIDUAL, _SWEEP, _SWEEP_FROM_ZERO = range(4)
# routes of a level's smoothing call: one launch per pass, or all passes in
# one launch of a cooperative grid
PER_PASS, GRID = range(2)


def _check_block(C, shape, radius, vectors, binv=None, dim: int = 2):
    """Validate the operands of the ``dim``-D block entries: coefficients
    (nF, nF, m^dim, *shape), or scalar planes (m^dim, *shape) as nF = 1;
    ``vectors`` (nF·n,); ``binv`` (nF, nF, n), scalar (n,). Returns (device
    type, nF)."""
    if radius not in (1, 2):
        raise ValueError(f"radius must be 1 or 2, got {radius}")
    shape = tuple(shape)
    if len(shape) != dim:
        raise ValueError(f"a {dim}D kernel got the lattice shape {shape}")
    m2 = (2 * radius + 1) ** dim
    block = C.dim() == dim + 3
    nF = C.shape[0] if block else 1
    if nF not in (1, 2, 3):
        raise ValueError(f"block kernels take 1 to 3 fields, got {nF}")
    if tuple(C.shape) != ((nF, nF, m2, *shape) if block else (m2, *shape)):
        raise ValueError(
            f"coefficients {tuple(C.shape)} are neither (nF, nF, {m2}, "
            f"*{shape}) nor ({m2}, *{shape})")
    nn = 1
    for s_ in shape:
        nn *= s_
    for v in vectors:
        if tuple(v.shape) != (nF * nn,):
            raise ValueError(f"vector {tuple(v.shape)} != {(nF * nn,)}")
    tensors = [C, *vectors]
    if binv is not None:
        want = (nF, nF, nn) if block else (nn,)
        if tuple(binv.shape) != want:
            raise ValueError(f"smoother blocks {tuple(binv.shape)} != {want}")
        tensors.append(binv)
    device = vectors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"stencil kernels take float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError("stencil kernels take contiguous tensors")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type, nF


def _launch_block(mode, C, x, b, binv, omega, shape, radius, nF):
    """One stencil2d_block launch of pass ``mode`` into a new vector, which
    it returns. Checked CUDA operands only; an operand the pass does not
    read is None."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    y = torch.empty_like(x if b is None else b)
    with torch.cuda.device(y.device):
        rc = _lib().stencil2d_block(
            ptr(C), ptr(x), ptr(b), ptr(binv), float(omega), y.data_ptr(),
            shape[0], shape[1], radius, nF, mode,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil2d_block")
    return y


def _sweep_cuda(C, binv, b, x, omega, shape, radius, nF, mode=_SWEEP):
    """The ``jacobi_smooth`` launch on checked CUDA operands: one sweep
    x + ω·Binv·(b − A x); with x None the same sweep applied to ω·Binv·b
    (two sweeps from zero), or with ``mode`` _SWEEP_FROM_ZERO ω·Binv·b
    alone."""
    y = _launch_block(mode, C, x, b, binv, omega, shape, radius, nF)
    jacobi_smooth.launches += 1
    return y


def _apply_cuda(C, x, b, shape, radius, nF):
    """The ``stencil_mv_block`` launch on checked CUDA operands: A x, or
    b − A x where b is given."""
    y = _launch_block(_APPLY if b is None else _RESIDUAL, C, x, b, None, 0.0,
                      shape, radius, nF)
    stencil_mv_block.launches += 1
    return y


def jacobi_smooth(C, invd, b, x, omega, shape, radius):
    """y = x + ω·invd·(b − A x) in one pass (f32), on scalar planes. CPU:
    plain version; CUDA: the sweep pass of the stencil2d_block kernel."""
    if _check(C, x, shape, radius, invd, b) == "cpu":
        return jacobi_smooth_plain(C, invd, b, x, omega, shape, radius)
    return _sweep_cuda(C, invd, b, x, omega, shape, radius, 1)


def stencil_mv_block(C, x, shape, radius, b=None):
    """Block apply y[f1] = Σ_f2 C[f1, f2] ⋆ x[f2] (f32) on field-blocked
    vectors (nF·n,), C (nF, nF, (2r+1)², nx1, ny1) contiguous (or scalar
    planes, nF = 1); with ``b`` the residual b − A x. CPU: plain version;
    CUDA: ONE launch of the stencil2d_block kernel, which stages the x
    tiles of all fields once and keeps nF accumulators per point."""
    kind, nF = _check_block(C, shape, radius, (x,) if b is None else (x, b))
    if kind == "cpu":
        if b is None:
            return apply_plain(C, x, shape, radius)
        return residual_plain(C, b, x, shape, radius)
    return _apply_cuda(C, x, b, shape, radius, nF)


@functools.cache
def _smooth_route(shape, radius, nF, device_index) -> int:
    """GRID where a level's smoothing call fits one fused launch, else
    PER_PASS; asked of the library once per (lattice, radius, fields,
    device): it decides from the tile count and an occupancy query."""
    with torch.cuda.device(device_index):
        route = _lib().stencil2d_smooth_plan(shape[0], shape[1], radius, nF)
    if route not in (PER_PASS, GRID):
        raise RuntimeError(f"stencil2d_smooth_plan failed: {route}")
    return route


def _smooth_cuda(route, C, binv, b, x, omega, sweeps, shape, radius, nF,
                 with_residual):
    """``smooth`` on checked CUDA operands by ``route``: PER_PASS is one
    ``jacobi_smooth`` launch per sweep (two sweeps from zero are one
    launch) and a ``stencil_mv_block`` launch for the residual; GRID is one
    stencil2d_smooth launch (counted as ``smooth``), which needs
    sweeps ≥ 1 and a level whose tiles are all co-resident (else the launch
    is refused and this raises)."""
    if route == PER_PASS:
        if x is None and sweeps == 0:
            x = torch.zeros_like(b)
        elif x is None and sweeps == 1:
            x = _sweep_cuda(C, binv, b, None, omega, shape, radius, nF,
                            _SWEEP_FROM_ZERO)
        else:
            # from zero, the first sweep (ω·Binv·b, no coefficient read) is
            # computed by the second sweep's launch while it stages its x
            for _ in range(sweeps - (x is None)):
                x = _sweep_cuda(C, binv, b, x, omega, shape, radius, nF)
        if not with_residual:
            return x
        return x, _apply_cuda(C, x, b, shape, radius, nF)
    out = torch.empty_like(b)
    res = torch.empty_like(b) if with_residual else None
    # the sweep from zero is folded into the next pass and needs no buffer
    tmp = torch.empty_like(b) if sweeps - (x is None) >= 2 else None
    with torch.cuda.device(b.device):
        rc = _lib().stencil2d_smooth(
            C.data_ptr(), binv.data_ptr(), b.data_ptr(),
            None if x is None else x.data_ptr(), float(omega), sweeps,
            out.data_ptr(), None if tmp is None else tmp.data_ptr(),
            None if res is None else res.data_ptr(), shape[0], shape[1],
            radius, nF, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil2d_smooth")
    smooth.launches += 1
    return (out, res) if with_residual else out


def smooth(C, binv, b, x, omega, sweeps, shape, radius, with_residual=False):
    """A multigrid level's smoothing call (f32): ``sweeps`` sweeps
    x ← x + ω·Binv·(b − A x) from x, or from zero when ``x`` is None (the
    first sweep is then ω·Binv·b and reads no coefficient), and with
    ``with_residual`` also r = b − A x_ν; returns x_ν or (x_ν, r). Scalar
    planes take ``binv`` = the flat 1/diag, block coefficients the
    (nF, nF, n) nodal blocks.

    CPU: plain version. CUDA: where the level's tiles are all co-resident,
    all passes in ONE launch of the stencil2d_smooth kernel (a cooperative
    grid, a barrier between the passes, each point's coefficients read once
    per call; the library decides from the tile count and the card's
    occupancy), else one launch per pass; either way the same arithmetic,
    bitwise."""
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    kind, nF = _check_block(C, shape, radius, (b,) if x is None else (b, x),
                            binv)
    if kind == "cpu":
        return smooth_plain(C, binv, b, x, omega, sweeps, shape, radius,
                            with_residual)
    route = PER_PASS
    if sweeps >= 1 and sweeps + bool(with_residual) >= 2:
        route = _smooth_route(tuple(shape), radius, nF, b.device.index or 0)
    return _smooth_cuda(route, C, binv, b, x, omega, sweeps, shape, radius,
                        nF, with_residual)


def stencil_mv3(C, x, shape, radius):
    """y = A x on a 3D lattice (f32). CPU: plain version; CUDA: the
    stencil3d_mv kernel."""
    if _check(C, x, shape, radius, dim=3) == "cpu":
        return stencil_mv3_plain(C, x, shape, radius)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil3d_mv(
            C.data_ptr(), x.data_ptr(), y.data_ptr(), *shape, radius,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil3d_mv")
    stencil_mv3.launches += 1
    return y


def jacobi_smooth3(C, invd, b, x, omega, shape, radius):
    """y = x + ω·invd·(b − A x) in one pass on a 3D lattice (f32). CPU:
    plain version; CUDA: the stencil3d_jacobi kernel."""
    if _check(C, x, shape, radius, invd, b, dim=3) == "cpu":
        return jacobi_smooth3_plain(C, invd, b, x, omega, shape, radius)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil3d_jacobi(
            C.data_ptr(), invd.data_ptr(), b.data_ptr(), x.data_ptr(),
            float(omega), y.data_ptr(), *shape, radius,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil3d_jacobi")
    jacobi_smooth3.launches += 1
    return y


def cheb_step3(C, invd, b, x, d, alpha, beta, shape, radius):
    """One Chebyshev smoothing step in one pass on a 3D lattice (f32):
    r = invd·(b − A x), d' = α·r + β·d, x' = x + d'. ``d`` is None on the
    first step (β must be 0). Returns (x', d'). CPU: plain version; CUDA:
    the stencil3d_cheb kernel, which writes x' to a new tensor and d' over
    ``d`` (each point reads only its own d)."""
    if d is None and beta != 0:
        raise ValueError("the first Chebyshev step (d=None) takes beta=0")
    if d is not None and d.data_ptr() == x.data_ptr():
        raise ValueError("d is updated in place and must not alias x")
    planes = (invd, b) if d is None else (invd, b, d)
    if _check(C, x, shape, radius, *planes, dim=3) == "cpu":
        return cheb_step3_plain(C, invd, b, x, d, alpha, beta, shape, radius)
    y = torch.empty_like(x)
    if d is None:
        d = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil3d_cheb(
            C.data_ptr(), invd.data_ptr(), b.data_ptr(), x.data_ptr(),
            d.data_ptr(), float(alpha), float(beta), y.data_ptr(), *shape,
            radius, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil3d_cheb")
    cheb_step3.launches += 1
    return y, d


def stencil3d_block(C, x, shape, radius, b=None, binv=None, omega=1.0):
    """The 3D block entry (f32) on field-blocked vectors (nF·n,), C
    (nF, nF, (2r+1)³, nx1, ny1, nz1) contiguous (or scalar planes, nF = 1):

    * ``b`` None: the apply y[f1] = Σ_f2 C[f1, f2] ⋆ x[f2];
    * ``b`` given: the residual b − A x;
    * ``b`` and ``binv`` given: one sweep x + ω·Binv·(b − A x) on the
      (nF, nF, n) nodal blocks (scalar planes: the flat 1/diag); with ``x``
      None the sweep from zero, ω·Binv·b, which reads no coefficient.

    CPU: the plain versions; CUDA: ONE launch of the stencil3d_block
    kernel, which stages the x tiles of all fields once and keeps nF
    accumulators per point."""
    if binv is not None and b is None:
        raise ValueError("a sweep needs b")
    if x is None and binv is None:
        raise ValueError("only a sweep can start from zero (x=None)")
    vectors = [v for v in (x, b) if v is not None]
    kind, nF = _check_block(C, shape, radius, vectors, binv, dim=3)
    if kind == "cpu":
        if binv is not None:
            return sweep3_block_plain(C, binv, b, x, omega, shape, radius)
        if b is not None:
            return residual3_block_plain(C, b, x, shape, radius)
        return apply3_block_plain(C, x, shape, radius)
    mode = (_APPLY if b is None else _RESIDUAL if binv is None
            else _SWEEP_FROM_ZERO if x is None else _SWEEP)

    def ptr(t):
        return None if t is None else t.data_ptr()

    y = torch.empty_like(vectors[0])
    with torch.cuda.device(y.device):
        rc = _lib().stencil3d_block(
            C.data_ptr(), ptr(x), ptr(b), ptr(binv), float(omega),
            y.data_ptr(), *shape, radius, nF, mode,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil3d_block")
    stencil3d_block.launches += 1
    return y


WRAPPERS = (stencil_mv, jacobi_smooth, stencil_mv_block, smooth, stencil_mv3,
            jacobi_smooth3, cheb_step3, stencil3d_block)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    """Launch counts of every wrapper, by name."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


reset_launches()
