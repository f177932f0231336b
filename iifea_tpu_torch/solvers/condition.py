"""Condition-number estimation (port of
``iifea_tpu/solvers/condition.py``): Golub–Kahan–Lanczos bidiagonalization
on the operator's ``mv`` and ``mv_t`` with full reorthogonalization, and a
small host SVD of the bidiagonal. The basis lives on the host in f64; each
step moves one vector to the operator's device and back.
"""
from __future__ import annotations

import numpy as np
import torch


def estimate_condition_number(A, iters: int = 100, seed: int = 0):
    """Returns (sigma_max, sigma_min) estimates of A, whose vectors live on
    the device of its extraction operator ``A.M`` (on the CPU for an
    operator without one)."""
    device = getattr(getattr(A, "M", None), "device", "cpu")

    def apply(fn, v):
        return fn(torch.as_tensor(v, device=device)).cpu().numpy()

    n = A.n
    rng = np.random.default_rng(seed)
    k = min(iters, n)
    U = np.zeros((k + 1, n))
    V = np.zeros((k + 1, n))
    alphas = np.zeros(k)
    betas = np.zeros(k)

    u = rng.standard_normal(n)
    U[0] = u / np.linalg.norm(u)
    v = np.zeros(n)
    beta = 0.0
    actual = k
    for j in range(k):
        v_new = apply(A.mv_t, U[j]) - beta * v
        v_new -= V[: j + 1].T @ (V[: j + 1] @ v_new)
        alpha = np.linalg.norm(v_new)
        if alpha < 1e-14:
            actual = j
            break
        v = v_new / alpha
        V[j] = v
        u_new = apply(A.mv, v) - alpha * U[j]
        u_new -= U[: j + 1].T @ (U[: j + 1] @ u_new)
        beta = np.linalg.norm(u_new)
        alphas[j] = alpha
        betas[j] = beta
        if beta < 1e-14:
            actual = j + 1
            break
        U[j + 1] = u_new / beta

    if actual == 0:
        return 0.0, 0.0
    B = np.zeros((actual + 1, actual))
    for j in range(actual):
        B[j, j] = alphas[j]
        B[j + 1, j] = betas[j]
    s = np.linalg.svd(B, compute_uv=False)
    s = s[s > 0]
    return float(s.max()), float(s.min())
