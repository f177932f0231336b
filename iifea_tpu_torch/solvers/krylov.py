"""Matrix-free Krylov solvers (port of ``iifea_tpu/solvers/krylov.py``):
preconditioned CG, BiCGStab, restarted (F)GMRES and GCR(restart).

Every solver takes ``matvec`` and an optional preconditioner ``minv`` as
callables on flat tensors. The loops stay on the device: scalars such as
α and β are 0-d tensors, and the residual norm is read back to the host
once per chunk of ``check_every`` iterations (the only host syncs of the
loop), so CG and BiCGStab may run up to check_every − 1 iterations past the
tolerance. Convergence test: ‖r‖ ≤ max(rtol·‖b‖, atol).

Deliberate differences from the JAX package:

* GMRES reads its Givens residual estimate |g[j+1]| every ``check_every``
  Arnoldi steps (default 1; the JAX cycle tests it after every step, on
  the device), so with check_every > 1 its iteration count may run up to
  check_every − 1 past JAX's. The Givens rotations and the
  back-substitution of the small Hessenberg system run on the host in
  numpy, in the system's dtype, on the columns read back at each check.
* GMRES and GCR orthogonalise against the filled rows ``V[:j+1]`` only; the
  JAX code multiplies by all rows, the unfilled ones being zero, which is
  the same arithmetic.
* CG stops after three checks without a 0.1% new least residual and
  returns that residual's iterate, as GMRES stops after three such cycles
  in both packages; JAX's CG has no such stop. A system CG solves never
  meets it before convergence, so its iterates are JAX's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SolveInfo(NamedTuple):
    """iters: iterations run; resnorm: final ‖r‖ (GMRES: the true residual
    of the last cycle); converged: resnorm ≤ tol; history: ‖r‖ at each
    check (per chunk for CG/BiCGStab, per cycle for GMRES/GCR); stalled:
    CG or GMRES stopped on stagnation."""

    iters: int
    resnorm: float
    converged: bool
    history: list | None = None
    stalled: bool | None = None


def _tol(b: torch.Tensor, rtol: float, atol: float, norm=None) -> float:
    norm = norm or torch.linalg.vector_norm
    return max(rtol * float(norm(b)), atol)


def _identity(x):
    return x


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, and 0 where den == 0: over-iterating a solved system
    within a chunk must not blow up. The selects stay on the device."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       minv: Callable | None = None, rtol: float = 1e-8, atol: float = 1e-9,
       max_it: int = 10000, check_every: int = 8,
       dot: Callable | None = None):
    """Preconditioned conjugate gradients. iters is a multiple of
    check_every. Stops on convergence, on max_it, or after three
    consecutive checks that do not lower the least residual seen by 0.1%,
    and then returns the iterate of that least residual: a residual at its
    arithmetic's floor only wanders (an f32 pass of the mixed route).

    ``dot(a, b)`` forms every inner product and norm (‖v‖ = √dot(v, v)):
    a row-block sharded solve passes the local dot followed by a sum over
    the ranks, so every rank sees the same scalars and takes the same
    branches. None: ``torch.dot`` and ``torch.linalg.vector_norm``."""
    minv = minv or _identity
    if dot is None:
        dot, norm = torch.dot, torch.linalg.vector_norm
    else:
        def norm(v):
            return torch.sqrt(dot(v, v))
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol, norm)
    chunk = max(int(check_every), 1)

    r = b - matvec(x)
    z = minv(r)
    p = z
    rz = dot(r, z)
    it = 0
    rn = float(norm(r))
    history = [rn]
    best, x_best, stuck = rn, x, 0
    while rn > tol and it < max_it and stuck < 3:
        for _ in range(chunk):
            Ap = matvec(p)
            alpha = _safe_div(rz, dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = minv(r)
            rz_new = dot(r, z)
            p = z + _safe_div(rz_new, rz) * p
            rz = rz_new
        it += chunk
        rn = float(norm(r))
        history.append(rn)
        if rn < 0.999 * best:
            best, x_best, stuck = rn, x, 0
        else:
            stuck += 1
    if stuck >= 3:
        return x_best, SolveInfo(it, best, False, history, True)
    return x, SolveInfo(it, rn, rn <= tol, history)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, minv: Callable | None = None,
             rtol: float = 1e-8, atol: float = 1e-9, max_it: int = 10000,
             check_every: int = 8):
    """BiCGStab for the nonsymmetric Nitsche variants (right
    preconditioning, as the JAX package). iters is a multiple of
    check_every."""
    minv = minv or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol)
    chunk = max(int(check_every), 1)

    r = b - matvec(x)
    rh = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    it = 0
    rn = float(torch.linalg.vector_norm(r))
    history = [rn]
    while rn > tol and it < max_it:
        for _ in range(chunk):
            rho_new = torch.dot(rh, r)
            beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
            p = r + beta * (p - omega * v)
            phat = minv(p)
            v = matvec(phat)
            alpha = _safe_div(rho_new, torch.dot(rh, v))
            s = r - alpha * v
            shat = minv(s)
            t = matvec(shat)
            omega = _safe_div(torch.dot(t, s), torch.dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho = rho_new
        it += chunk
        rn = float(torch.linalg.vector_norm(r))
        history.append(rn)
    return x, SolveInfo(it, rn, rn <= tol, history)


def _givens(H: np.ndarray, cs, sn, g, j0: int, j1: int) -> None:
    """Apply the accumulated Givens rotations to Hessenberg columns
    j0..j1-1 of H (host, in place), form each column's new rotation, and
    update g (the JAX cycle's per-step rotation, in the same order)."""
    for j in range(j0, j1):
        col = H[:, j]
        for i in range(j):
            a = cs[i] * col[i] + sn[i] * col[i + 1]
            col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
            col[i] = a
        denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
        c = col[j] / denom if denom > 0 else col.dtype.type(1.0)
        s = col[j + 1] / denom if denom > 0 else col.dtype.type(0.0)
        cs[j], sn[j] = c, s
        col[j], col[j + 1] = denom, 0.0
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]


def _back_substitute(R: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Solve the upper-triangular R y = g with the JAX cycle's relative
    breakdown guard: a near-dead direction (|R_jj| below eps·max|R_jj|, or
    the dtype's tiny) gets 1 added to its diagonal and a zero right-hand
    side instead of dividing O(1/eps) noise into y."""
    m = R.shape[0]
    d = np.abs(np.diag(R))
    eps = 1e-13 if R.dtype == np.float64 else 1e-5
    bad = d < max(eps * (d.max() if m else 0.0), np.finfo(R.dtype).tiny)
    R = R + np.diag(bad.astype(R.dtype))
    gm = np.where(bad, 0.0, g).astype(R.dtype)
    y = np.zeros(m, dtype=R.dtype)
    for j in range(m - 1, -1, -1):
        y[j] = (gm[j] - R[j, j + 1:] @ y[j + 1:]) / R[j, j]
    return y


def _gmres_cycle(matvec, minv, b, x0, m: int, tol: float, chunk: int):
    """One restart cycle of right-preconditioned GMRES. Returns
    (x, true residual norm, Arnoldi steps)."""
    r0 = b - matvec(x0)
    beta = torch.linalg.vector_norm(r0)
    V = torch.empty((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    V[0] = r0 / torch.where(beta > 0, beta, 1.0)
    Hd = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    npdt = np.float64 if b.dtype == torch.float64 else np.float32
    H = np.zeros((m + 1, m), dtype=npdt)
    cs = np.zeros(m, dtype=npdt)
    sn = np.zeros(m, dtype=npdt)
    g = np.zeros(m + 1, dtype=npdt)
    g[0] = float(beta)
    steps = 0
    while steps < m and abs(g[steps]) > tol:
        j0 = steps
        for j in range(j0, min(j0 + chunk, m)):
            w = matvec(minv(V[j]))
            Vj = V[:j + 1]
            # modified Gram-Schmidt, then one classical DGKS
            # re-orthogonalisation for robustness in f32
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            hn = torch.linalg.vector_norm(w)
            Hd[:j + 1, j] = h + h2
            Hd[j + 1, j] = hn
            V[j + 1] = torch.where(hn > 1e-300,
                                   w / torch.where(hn > 0, hn, 1.0), 0.0)
            steps = j + 1
        H[:, j0:steps] = Hd[:, j0:steps].cpu().numpy()
        _givens(H, cs, sn, g, j0, steps)
    y = _back_substitute(H[:steps, :steps], g[:steps])
    yt = torch.as_tensor(y, device=b.device)
    x = x0 + minv(V[:steps].T @ yt) if steps else x0
    # the TRUE residual: the Givens estimate drifts on basis breakdown
    return x, float(torch.linalg.vector_norm(b - matvec(x))), steps


def gmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
          minv: Callable | None = None, rtol: float = 1e-8,
          atol: float = 1e-9, max_it: int = 10000, restart: int = 100,
          check_every: int = 1):
    """Restarted (F)GMRES; with a constant (linear) preconditioner right-
    preconditioned GMRES and FGMRES coincide. Stops on convergence, on
    max_it // restart + 1 cycles, or after three consecutive cycles that
    improve the true residual by less than 0.1% (stagnation on singular
    projected systems)."""
    minv = minv or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol)
    m = max(int(restart), 1)
    max_cycles = max(int(max_it) // m + 1, 1)
    chunk = max(int(check_every), 1)
    rn = float(torch.linalg.vector_norm(b - matvec(x)))
    history = [rn]
    it = cyc = stall = 0
    while rn > tol and cyc < max_cycles and stall < 3:
        x, rn_new, steps = _gmres_cycle(matvec, minv, b, x, m, tol, chunk)
        stall = 0 if rn_new < 0.999 * rn else stall + 1
        rn = rn_new
        history.append(rn)
        it += steps
        cyc += 1
    return x, SolveInfo(it, rn, rn <= tol, history, stall >= 3)


def gcr(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
        minv: Callable | None = None, rtol: float = 1e-8, atol: float = 1e-9,
        max_it: int = 10000, restart: int = 30):
    """GCR(restart): full cycles of ``restart`` steps, the residual norm
    read once per cycle. iters = cycles · restart."""
    minv = minv or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol)
    m = max(int(restart), 1)
    max_cycles = max(int(max_it) // m + 1, 1)
    n = b.shape[0]
    rn = float(torch.linalg.vector_norm(b - matvec(x)))
    history = [rn]
    cycles = 0
    while rn > tol and cycles < max_cycles:
        r = b - matvec(x)
        P = torch.empty((m, n), dtype=b.dtype, device=b.device)
        AP = torch.empty_like(P)
        for j in range(m):
            p = minv(r)
            Ap = matvec(p)
            # orthogonalise Ap against the previous AP
            coeff = AP[:j] @ Ap
            p = p - P[:j].T @ coeff
            Ap = Ap - AP[:j].T @ coeff
            inv = _safe_div(torch.ones((), dtype=b.dtype, device=b.device),
                            torch.linalg.vector_norm(Ap))
            p = p * inv
            Ap = Ap * inv
            alpha = torch.dot(Ap, r)
            x = x + alpha * p
            r = r - alpha * Ap
            P[j] = p
            AP[j] = Ap
        rn = float(torch.linalg.vector_norm(r))
        history.append(rn)
        cycles += 1
    return x, SolveInfo(cycles * m, rn, rn <= tol, history)
