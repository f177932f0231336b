"""Hand-written CUDA kernels for the 2D and 3D stencil applies and
smoothing sweeps.

Port of the Pallas TPU kernels of ``iifea_tpu/ops/pallas_stencil.py`` to
Hopper: ``stencil_mv``/``jacobi_smooth`` (``csrc/stencil2d.cuh``, which also
holds the two entries built on them for block operators and small lattices:
``stencil_mv_block``, a block (multi-field) apply or residual b − A x in
one launch, and ``smooth``, a multigrid level's ν sweeps and trailing
residual in one launch) and
``stencil_mv3``/``jacobi_smooth3`` (``csrc/stencil3d.cuh``: one marching
kernel behind ``stencil_mv3`` (its apply pass), ``jacobi_smooth3``, the
fused Chebyshev step ``cheb_step3`` of the 3D V-cycle smoother and
``stencil3d_block``, the 3D block apply, residual and point-block sweep in
one launch; ``smooth3``, a 3D level's whole smoothing call, is one
cooperative launch of it on the small levels). The kernels live in the
two headers; each scalar type's instances are compiled from sources of
their own, the radius-4 ones apart (``stencil2d.cu`` and ``stencil3d.cu``:
the f32 instances at r = 1–3 and the entries; ``stencil2d_f64.cu``,
``stencil3d_f64.cu``; ``stencil{2d,3d}_r4{,_f64}.cu``); every radius from 5
runs the runtime-radius instances (``stencil2d_rn.cu`` from
``csrc/stencil_rn.cuh``, ``stencil3d_rn.cu``: the marching kernel with the
radius a kernel argument, which also takes the 3D lattices whose x planes
a block cannot stage at r = 1–4). Every ``csrc/*.cu``
source is compiled with ``nvcc`` for ``sm_90a`` at first use (one nvcc per
source, run together, then one link) into one shared library in
``build/iifea_tpu_torch/`` at the repository root (a plain C interface
loaded with ``ctypes``), keyed by a hash of all sources, the headers and
the flags, so a fresh checkout builds everything it runs.

Dispatch rule of every wrapper: a CPU tensor runs the plain PyTorch version
in this module; a CUDA tensor always launches the kernel (or raises).
Launches are counted where they are made (``launches()``): a 2D wrapper's
in ``<wrapper>.launches`` (a 2D smoothing call that takes one launch per
pass counts its sweeps under ``jacobi_smooth`` and its residual under
``stencil_mv_block``, the functions that launch them); ``stencil_mv3``'s
(its apply pass of ``stencil3d_pass``, not counted under ``apply3``) and
``smooth3``'s (a 3D level's one cooperative launch) likewise; every other
launch of the 3D marching entry ``stencil3d_pass`` under the name of its
pass and instance, ``PASS3_NAMES`` (``jacobi_smooth3``, ``cheb_step3``,
``stencil3d_block``, …), whichever wrapper made it.

Instances (``_check_instance``): every kernel, 2D and 3D, takes f32 and
f64 for 1 to 3 fields at every radius from 1 (r = 3: a quadratic B-spline
background's 49 and 343 taps, r = 4 a cubic one's 81 and 729, r = 5 a
quartic one's 121 and 1,331): fixed-radius instances at r = 1 to 4, the
runtime-radius ones above. On the card a 2D radius is limited by the
staged tile of the runtime-radius instances (``max_radius2d``: 41 in f64
with three fields); the plain versions take any. At r ≥ 5 a level's
smoothing call is one cooperative launch of the runtime-radius level
kernels (``level2d_kernel``, ``march_rn_level_kernel``) where the plan
says so, as at r = 1–4. The 3D marching passes stage
the x planes of one field at a time where a block cannot hold those of
every field (the plan's staging, f64 at r = 4 with three fields from a
73-point row), and none where it cannot hold one field's (f64 at r = 4
from about a 313-point row, long k rows at any radius) and at every radius
from 5: the runtime-radius kernel reads x through the read-only cache; one
launch per pass there too. No 3D marching pass reads the
coefficient of a tap whose x lies outside the lattice
(``outside_taps``). Every 3D lattice has a plan. The operands
of one call share one dtype; their scalars (omega, alpha, beta) are
passed in double.

Layout: 2D coefficients are ``((2r+1)², nx1, ny1)`` contiguous planes
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
import math
import operator
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


def outside_taps(shape, radius, device=None):
    """The taps of a 2D or 3D lattice (by ``shape``'s rank) whose x lies
    outside it: a bool tensor ((2r+1)^d, *shape) in the planes' layout,
    True where the offset takes the point off the lattice. Their
    coefficients multiply the zero padding, so every result is the same
    whatever they hold; the 3D marching kernels do not read them."""
    r, m = radius, 2 * radius + 1
    out = torch.zeros((m,) * len(shape) + tuple(shape), dtype=torch.bool,
                      device=device)
    d = len(shape)
    for a, n in enumerate(shape):
        o = torch.arange(m, device=device) - r
        p = torch.arange(n, device=device)
        off = (p[None, :] + o[:, None] < 0) | (p[None, :] + o[:, None] >= n)
        view = [1] * (2 * d)
        view[a], view[d + a] = m, n
        out |= off.reshape(view)
    return out.reshape(m ** d, *shape)


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


def smooth3_plain(C, binv, b, x, steps, shape, radius, with_residual=False,
                  cheb=False):
    """The plain version of ``smooth3``: its steps one after another with
    the single-pass plain functions (from zero the first step is
    ``sweep3_block_plain`` from None, and for Chebyshev d its result),
    then b − A x_ν where asked."""
    if x is None:
        if steps:
            x = sweep3_block_plain(C, binv, b, None, steps[0][0], shape,
                                   radius)
        else:
            x = torch.zeros_like(b)
        d, todo = x, steps[1:]
    else:
        d, todo = None, steps
    for s0, s1 in todo:
        if cheb:
            x, d = cheb_step3_plain(C, binv, b, x, d, s0, s1, shape, radius)
        else:
            x = sweep3_block_plain(C, binv, b, x, s0, shape, radius)
    if with_residual:
        return x, residual3_block_plain(C, b, x, shape, radius)
    return x


# -- build and load -------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the shared library for the current sources (the ``.cu`` files
    and the headers they include) and flags lives."""
    h = hashlib.sha256()
    for src in sorted((_PKG / "csrc").glob("*.cu*")):
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
    p, i = ctypes.c_void_p, ctypes.c_int
    d = ctypes.c_double
    lib.stencil2d_mv.argtypes = [p, p, p, i, i, i, i, p]
    lib.stencil2d_block.argtypes = [p, p, p, p, d, p, i, i, i, i, i, i, p]
    lib.stencil2d_smooth.argtypes = [p, p, p, p, d, i, p, p, p, i, i, i, i,
                                     i, p]
    lib.stencil2d_smooth_plan.argtypes = [i, i, i, i, i]
    lib.stencil3d_plan.argtypes = [i, i, i, i, i, i, p]
    lib.stencil3d_pass.argtypes = [p, p, p, p, p, d, d, d, p, i, i, i, i, i,
                                   i, i, i, i, p]
    lib.stencil3d_level.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                    i, i, i, i, i, i, p]
    for fn in (lib.stencil2d_mv, lib.stencil2d_block,
               lib.stencil2d_smooth, lib.stencil2d_smooth_plan,
               lib.stencil3d_plan, lib.stencil3d_pass,
               lib.stencil3d_level):
        fn.restype = i
    return lib


# -- wrappers -------------------------------------------------------------------

# the runtime-radius 2D instances (csrc/stencil_rn.cuh, r >= 5) stage an
# RN_TILE² tile of x with its 2r halo, every field, in one block's shared
# memory: at most the H100's opt-in limit a block, 227 KB
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, which the kernels' launch asks
# of the card: optin_bytes in csrc/stencil_rn.cuh)
RN_TILE = 16
H100_SMEM_OPTIN_BYTES = 232448


def max_radius2d(dtype, nF: int) -> int:
    """The largest radius whose 2D tile a block can stage on an H100:
    nF·(16 + 2r)² values of ``dtype`` in H100_SMEM_OPTIN_BYTES (f64: 77
    with one field, 41 with three; f32: 112, 61)."""
    side = math.isqrt(H100_SMEM_OPTIN_BYTES
                      // (nF * torch.finfo(dtype).bits // 8))
    return (side - RN_TILE) // 2


def _check_instance(dtype, radius, nF, dim: int = 2, device: str = "cuda"):
    """Refuse operands no kernel instance takes: TypeError for a dtype,
    ValueError for a field count or a radius below 1 or, for the card's 2D
    kernels (``device`` "cuda"), above ``max_radius2d``. The plain versions
    (``device`` "cpu") take any radius, as the JAX package does."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil kernels take float32 or float64, got "
                        f"{dtype}")
    if nF not in (1, 2, 3):
        raise ValueError(f"block kernels take 1 to 3 fields, got {nF}")
    if operator.index(radius) < 1:
        raise ValueError(f"stencil radius must be >= 1, got {radius}")
    if device == "cuda" and dim == 2 and radius > max_radius2d(dtype, nF):
        raise ValueError(
            f"the 2D stencil kernels take radius 1 to "
            f"{max_radius2d(dtype, nF)} for {nF} field(s) in {dtype}, got "
            f"{radius}: a {RN_TILE} x {RN_TILE} tile of x with its 2r halo "
            f"must fit one block's {H100_SMEM_OPTIN_BYTES} bytes of shared "
            f"memory")


def _check(C, x, shape, radius, *planes, dim: int = 2) -> str:
    """Validate the operands of a ``dim``-D kernel; returns the device type
    ('cpu' or 'cuda')."""
    _check_instance(C.dtype, radius, 1, dim, x.device.type)
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
        if t.dtype != C.dtype:
            raise TypeError(f"operands in {t.dtype} and {C.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("stencil kernels take contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _f64(t) -> int:
    """The kernels' scalar-type flag of a checked operand."""
    return int(t.dtype == torch.float64)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def stencil_mv(C, x, shape, radius):
    """y = A x (f32 or f64). CPU: plain version; CUDA: the stencil2d_mv
    kernel."""
    if _check(C, x, shape, radius) == "cpu":
        return stencil_mv_plain(C, x, shape, radius)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().stencil2d_mv(
            C.data_ptr(), x.data_ptr(), y.data_ptr(), shape[0], shape[1],
            radius, _f64(x), torch.cuda.current_stream().cuda_stream,
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
    block = C.dim() == dim + 3
    nF = C.shape[0] if block else 1
    _check_instance(C.dtype, radius, nF, dim, vectors[0].device.type)
    shape = tuple(shape)
    if len(shape) != dim:
        raise ValueError(f"a {dim}D kernel got the lattice shape {shape}")
    m2 = (2 * radius + 1) ** dim
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
        if t.dtype != C.dtype:
            raise TypeError(f"operands in {t.dtype} and {C.dtype}")
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
            shape[0], shape[1], radius, nF, mode, _f64(y),
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
    """y = x + ω·invd·(b − A x) in one pass (f32 or f64), on scalar
    planes. CPU: plain version; CUDA: the sweep pass of the stencil2d_block
    kernel."""
    if _check(C, x, shape, radius, invd, b) == "cpu":
        return jacobi_smooth_plain(C, invd, b, x, omega, shape, radius)
    return _sweep_cuda(C, invd, b, x, omega, shape, radius, 1)


def stencil_mv_block(C, x, shape, radius, b=None):
    """Block apply y[f1] = Σ_f2 C[f1, f2] ⋆ x[f2] (f32 or f64) on
    field-blocked vectors (nF·n,), C (nF, nF, (2r+1)², nx1, ny1) contiguous (or scalar
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
def _smooth_route(shape, radius, nF, device_index, f64: bool = False) -> int:
    """GRID where a level's smoothing call fits one fused launch, else
    PER_PASS; asked of the library once per (lattice, radius, fields,
    device, scalar type): it decides from the tile count and an occupancy
    query of that instance."""
    with torch.cuda.device(device_index):
        route = _lib().stencil2d_smooth_plan(shape[0], shape[1], radius, nF,
                                             int(f64))
    if route not in (PER_PASS, GRID):
        raise RuntimeError(f"stencil2d_smooth_plan failed: {route}")
    return route


def _smooth_cuda(route, C, binv, b, x, omega, sweeps, shape, radius, nF,
                 with_residual):
    """``smooth`` on checked CUDA operands by ``route``: PER_PASS is one
    ``jacobi_smooth`` launch per sweep (two sweeps from zero are one
    launch) and a ``stencil_mv_block`` launch for the residual; GRID is one
    stencil2d_smooth launch (counted as ``smooth``; from r = 5 the
    runtime-radius level kernel), which needs sweeps ≥ 1 and a level whose
    tiles are all co-resident (else the launch is refused and this
    raises)."""
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
            radius, nF, _f64(b), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "stencil2d_smooth")
    smooth.launches += 1
    return (out, res) if with_residual else out


def smooth(C, binv, b, x, omega, sweeps, shape, radius, with_residual=False):
    """A multigrid level's smoothing call (f32 or f64): ``sweeps`` sweeps
    x ← x + ω·Binv·(b − A x) from x, or from zero when ``x`` is None (the
    first sweep is then ω·Binv·b and reads no coefficient), and with
    ``with_residual`` also r = b − A x_ν; returns x_ν or (x_ν, r). Scalar
    planes take ``binv`` = the flat 1/diag, block coefficients the
    (nF, nF, n) nodal blocks.

    CPU: plain version. CUDA: where the level's tiles are all co-resident
    (the library's plan, at every radius), all passes in ONE launch of the
    stencil2d_smooth kernel (a cooperative grid, a
    barrier between the passes; at r = 1–4 each point's coefficients read
    once per call where they fit its registers), else one launch per pass;
    either way the same arithmetic, bitwise."""
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    kind, nF = _check_block(C, shape, radius, (b,) if x is None else (b, x),
                            binv)
    if kind == "cpu":
        return smooth_plain(C, binv, b, x, omega, sweeps, shape, radius,
                            with_residual)
    route = PER_PASS
    if sweeps >= 1 and sweeps + bool(with_residual) >= 2:
        route = _smooth_route(tuple(shape), radius, nF, b.device.index or 0,
                              b.dtype == torch.float64)
    return _smooth_cuda(route, C, binv, b, x, omega, sweeps, shape, radius,
                        nF, with_residual)


def stencil_mv3(C, x, shape, radius):
    """y = A x on a 3D lattice (f32 or f64, any radius). CPU: plain
    version; CUDA: one launch of the marching kernel's apply pass
    (stencil3d_pass) at the plan's split and staging, counted as
    ``stencil_mv3``."""
    if _check(C, x, shape, radius, dim=3) == "cpu":
        return stencil_mv3_plain(C, x, shape, radius)
    y = _pass3(_APPLY, C, x, None, None, shape, radius, 1, count=False)
    stencil_mv3.launches += 1
    return y


# passes of the stencil3d_pass entry (_APPLY, _RESIDUAL, _SWEEP as above)
_CHEB, _ZERO = 3, 4
_PASSES = ("apply", "residual", "sweep", "cheb", "zero")
# The name a stencil3d_pass launch counts under, by (pass, nF > 1): the
# passes of march_kernel and the sweep from zero (march_zero_kernel), on
# one field (scalar planes) or on a block operator's 2 or 3
# (``stencil_mv3``'s apply passes count under its own name).
PASS3_NAMES = {
    ("apply", False): "apply3", ("residual", False): "residual3",
    ("sweep", False): "jacobi_smooth3", ("cheb", False): "cheb_step3",
    ("zero", False): "zero3",
    ("apply", True): "stencil3d_block", ("residual", True): "residual3_block",
    ("sweep", True): "sweep3_block", ("zero", True): "zero3_block",
}
_pass3_launches = dict.fromkeys(PASS3_NAMES.values(), 0)
# the most steps a level's smoothing launch takes (kMaxSteps)
MAX_LEVEL_STEPS3 = 8
# the marching passes' staging (the plan's out[3]): every field's x planes
# at once, one field's at a time, or none (the runtime-radius kernel reads
# x through the read-only cache)
ALL_FIELDS, PER_FIELD, UNSTAGED = range(3)
# the smallest radius of the runtime-radius instances (csrc/stencil_rn.cuh,
# march_rn_kernel and march_rn_level_kernel)
RN_RADIUS = 5


@functools.cache
def _plan3(shape, radius, nF, device_index, f64: bool = False):
    """(split, level, level_blocks, staging) of a 3D level shape, asked of
    the library once per (lattice, radius, fields, device, scalar type):
    threads per point, whether a smoothing call there is one launch (1) or
    one launch per pass (0), the blocks the card holds of a level's launch,
    and ALL_FIELDS, PER_FIELD (at r = 1–4 where a block cannot hold the
    staged x planes of every field: f64, r = 4, three fields from a
    73-point row on) or UNSTAGED (where it cannot hold one field's: f64,
    r = 4 from about a 313-point row, long k rows; at every radius from
    5). The library decides from the run count, occupancy queries of the
    instance and, for the level launch, the rule ``level_pays`` (the
    level's in-lattice coefficients within the card's L2); every lattice
    has a plan."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = _lib().stencil3d_plan(*shape, radius, nF, int(f64), out)
    if rc != 0:
        raise RuntimeError(f"stencil3d_plan failed: {rc}")
    return tuple(out)


def _pass3(pass_, C, x, b, binv, shape, radius, nF, omega0=0.0, s0=0.0,
           s1=0.0, d=None, y=None, split=None, staging=None, count=True):
    """One stencil3d_pass launch of ``pass_`` on checked CUDA operands into
    ``y`` (new when None), which it returns, counted under its
    ``PASS3_NAMES`` entry (``count`` False: by the caller); ``split`` and
    ``staging`` override the plan's. The _ZERO pass is omega0·Binv·b (also
    into ``d`` when given)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    if y is None:
        y = torch.empty_like(b if b is not None else x)
    with torch.cuda.device(y.device):
        if split is None or staging is None:
            plan = _plan3(tuple(shape), radius, nF, y.device.index or 0,
                          y.dtype == torch.float64)
            split = plan[0] if split is None else split
            staging = plan[3] if staging is None else staging
        rc = _lib().stencil3d_pass(
            ptr(C), ptr(x), ptr(b), ptr(binv), ptr(d), float(omega0),
            float(s0), float(s1), y.data_ptr(), *shape, radius, nF, _f64(y),
            pass_, split, staging, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "stencil3d_pass")
    if count:
        _pass3_launches[PASS3_NAMES[_PASSES[pass_], nF > 1]] += 1
    return y


def jacobi_smooth3(C, invd, b, x, omega, shape, radius):
    """y = x + ω·invd·(b − A x) in one pass on a 3D lattice (f32 or f64,
    any radius). CPU: plain version; CUDA: the sweep pass of the
    stencil3d_pass kernel instance."""
    if _check(C, x, shape, radius, invd, b, dim=3) == "cpu":
        return jacobi_smooth3_plain(C, invd, b, x, omega, shape, radius)
    return _pass3(_SWEEP, C, x, b, invd, shape, radius, 1, s0=omega)


def cheb_step3(C, invd, b, x, d, alpha, beta, shape, radius):
    """One Chebyshev smoothing step in one pass on a 3D lattice (f32 or
    f64, any radius): r = invd·(b − A x), d' = α·r + β·d, x' = x + d'.
    ``d`` is None on the first step (β must be 0). Returns (x', d'). CPU:
    plain version; CUDA: the Chebyshev pass of the stencil3d_pass kernel
    instance, which writes x' to a new tensor and d' over ``d`` (each point
    reads only its own d)."""
    if d is None and beta != 0:
        raise ValueError("the first Chebyshev step (d=None) takes beta=0")
    if d is not None and d.data_ptr() == x.data_ptr():
        raise ValueError("d is updated in place and must not alias x")
    planes = (invd, b) if d is None else (invd, b, d)
    if _check(C, x, shape, radius, *planes, dim=3) == "cpu":
        return cheb_step3_plain(C, invd, b, x, d, alpha, beta, shape, radius)
    if d is None:
        d = torch.empty_like(x)
    y = _pass3(_CHEB, C, x, b, invd, shape, radius, 1, s0=alpha, s1=beta,
               d=d)
    return y, d


def stencil3d_block(C, x, shape, radius, b=None, binv=None, omega=1.0):
    """The 3D block entry (f32 or f64) on field-blocked vectors (nF·n,), C
    (nF, nF, (2r+1)³, nx1, ny1, nz1) contiguous (or scalar planes, nF = 1):

    * ``b`` None: the apply y[f1] = Σ_f2 C[f1, f2] ⋆ x[f2];
    * ``b`` given: the residual b − A x;
    * ``b`` and ``binv`` given: one sweep x + ω·Binv·(b − A x) on the
      (nF, nF, n) nodal blocks (scalar planes: the flat 1/diag); with ``x``
      None the sweep from zero, ω·Binv·b, which reads no coefficient.

    CPU: the plain versions; CUDA: ONE launch of the stencil3d_pass
    kernel, which stages the x planes of all fields once per block and
    keeps nF accumulators per point."""
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
            else _ZERO if x is None else _SWEEP)
    return _pass3(mode, C, x, b, binv, shape, radius, nF, omega0=omega,
                  s0=omega)


def passes3(sweeps: int, from_zero: bool, with_residual: bool) -> list:
    """The launches of a 3D smoothing call on the per-pass route, in order:
    "zero" (the first step from zero, ω·Binv·b), one ("step", k) per
    further step k, "residual"."""
    first = int(from_zero and sweeps >= 1)
    return (["zero"] * first + [("step", k) for k in range(first, sweeps)]
            + ["residual"] * with_residual)


def _smooth3_route(shape, radius, nF, device_index, f64, sweeps, from_zero,
                   with_residual) -> int:
    """GRID where the plan says the level's smoothing call fits one
    cooperative launch and the call has at least two passes, else
    PER_PASS."""
    if not 1 <= sweeps <= MAX_LEVEL_STEPS3:
        return PER_PASS
    if len(passes3(sweeps, from_zero, with_residual)) < 2:
        return PER_PASS
    return GRID if _plan3(tuple(shape), radius, nF, device_index,
                          f64)[1] else PER_PASS


def _smooth3_cuda(route, C, binv, b, x, steps, shape, radius, nF,
                  with_residual, cheb, split=None, staging=None):
    """``smooth3`` on checked CUDA operands by ``route``. PER_PASS launches
    ``passes3``, each counted by ``_pass3``. GRID is one stencil3d_level
    launch (counted as ``smooth3``), refused (this raises) where the
    level's blocks are not all co-resident: at r = 1–4 it stages every
    field's x planes (ValueError for PER_FIELD and UNSTAGED; the step from
    zero folded into the next pass's staging), from r = 5 none (ValueError
    for PER_FIELD; the step from zero a phase of its own). ``split`` and
    ``staging`` override the plan's."""
    sweeps = len(steps)
    s0 = [float(a) for a, _ in steps]
    s1 = [float(c) for _, c in steps]
    if split is None or staging is None:
        plan = _plan3(tuple(shape), radius, nF, b.device.index or 0,
                      b.dtype == torch.float64)
        split = plan[0] if split is None else split
        staging = plan[3] if staging is None else staging
    d = torch.empty_like(b) if cheb and sweeps >= 1 else None
    if route == GRID:
        rn = radius >= RN_RADIUS
        if staging != (UNSTAGED if rn else ALL_FIELDS):
            raise ValueError(
                "a level's one launch stages every field's x planes at "
                "r = 1-4 and none from r = 5: a lattice staged otherwise "
                "takes one launch a pass")
        out = torch.empty_like(b)
        res = torch.empty_like(b) if with_residual else None
        # the fixed-radius kernels fold the step from zero into the next
        # pass's staging; the runtime-radius one writes it
        folded = x is None and not rn
        tmp = torch.empty_like(b) if sweeps - folded >= 2 else None
        a0 = (ctypes.c_double * len(s0))(*s0)
        a1 = (ctypes.c_double * len(s1))(*s1)

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(b.device):
            rc = _lib().stencil3d_level(
                C.data_ptr(), binv.data_ptr(), b.data_ptr(), ptr(x), ptr(d),
                out.data_ptr(), ptr(tmp), ptr(res), a0, a1, sweeps,
                int(cheb), *shape, radius, nF, _f64(b), split,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(rc, "stencil3d_level")
        smooth3.launches += 1
        return (out, res) if with_residual else out
    out, r = (torch.zeros_like(b) if x is None and sweeps == 0 else x), None
    for p in passes3(sweeps, x is None, with_residual):
        if p == "residual":
            r = _pass3(_RESIDUAL, C, out, b, binv, shape, radius, nF,
                       split=split, staging=staging)
        elif p == "zero":
            out = _pass3(_ZERO, C, None, b, binv, shape, radius, nF,
                         omega0=s0[0], d=d, split=split, staging=staging)
        else:
            k = p[1]
            out = _pass3(_CHEB if cheb else _SWEEP, C, out, b, binv, shape,
                         radius, nF, s0=s0[k], s1=s1[k], d=d, split=split,
                         staging=staging)
    return (out, r) if with_residual else out


def smooth3(C, binv, b, x, steps, shape, radius, with_residual=False,
            cheb=False):
    """A 3D multigrid level's smoothing call: ``len(steps)`` steps from x,
    or from zero when ``x`` is None, and with ``with_residual`` also
    r = b − A x_ν; returns x_ν or (x_ν, r). ``steps`` holds (s0, s1) per
    step:

    * sweeps (``cheb`` False): x ← x + s0·Binv·(b − A x), s1 unused; scalar
      planes take ``binv`` = the flat 1/diag (weighted Jacobi), block
      coefficients (nF, nF, (2r+1)³, *shape) the (nF, nF, n) nodal blocks;
    * Chebyshev steps (``cheb``, scalar planes): r = binv·(b − A x),
      d ← s0·r + s1·d, x ← x + d, with s1 = 0 on the first step; from zero
      the first step is the sweep s0·binv·b and d its result.

    CPU: ``smooth3_plain``. CUDA: where the plan says so (the level's
    blocks all co-resident and its in-lattice coefficients within the
    card's L2), all passes in ONE launch of the stencil3d_level kernel (a
    cooperative grid, a barrier between passes; from r = 5
    ``march_rn_level_kernel``), else one launch per pass; either way the
    same arithmetic, bitwise."""
    steps = [(float(a), float(c)) for a, c in steps]
    if cheb and C.dim() != 4:
        raise ValueError("the Chebyshev smoother takes scalar planes")
    if cheb and steps and steps[0][1] != 0:
        raise ValueError("the first Chebyshev step takes s1 = 0")
    vectors = (b,) if x is None else (b, x)
    if C.dim() == 4:
        kind = _check(C, b, shape, radius, binv, *vectors[1:], dim=3)
        nF = 1
    else:
        kind, nF = _check_block(C, shape, radius, vectors, binv, dim=3)
    if kind == "cpu":
        return smooth3_plain(C, binv, b, x, steps, shape, radius,
                             with_residual, cheb)
    route = _smooth3_route(tuple(shape), radius, nF, b.device.index or 0,
                           b.dtype == torch.float64, len(steps), x is None,
                           with_residual)
    return _smooth3_cuda(route, C, binv, b, x, steps, shape, radius, nF,
                         with_residual, cheb)


WRAPPERS = (stencil_mv, jacobi_smooth, stencil_mv_block, smooth, stencil_mv3,
            smooth3)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for name in _pass3_launches:
        _pass3_launches[name] = 0


def launches() -> dict:
    """Launch counts by name: each wrapper that launches a kernel itself,
    and each stencil3d_pass pass (``PASS3_NAMES``)."""
    return {**{fn.__name__: fn.launches for fn in WRAPPERS},
            **_pass3_launches}


reset_launches()
