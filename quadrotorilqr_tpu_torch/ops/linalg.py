"""Unrolled pivot-free Cholesky solves for small SPD systems.

Counterpart of `quadrotorilqr_tpu/ops/linalg.py:20-90`: the 3x3 inertia and
the 4x4 Quu are tiny and SPD, so the solve is a fully unrolled Cholesky
(n square roots, no pivoting), in the same operation order as the CUDA
kernels' `chol_solve` (kernels/csrc/lanes.cuh). Broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def cholesky_small(a):
    """Lower Cholesky factor of a small SPD matrix (..., n, n)."""
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = torch.sqrt(s)
        l[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [
        torch.stack([l[i][j] if j <= i else zero for j in range(n)], -1)
        for i in range(n)
    ]
    return torch.stack(rows, -2)


def _solve_lower(l, b, inv=None):
    """l y = b; with `inv` (the pivots' reciprocals) multiplying by them
    where the plain solve divides by the pivots."""
    n = l.shape[-1]
    ys = []
    for i in range(n):
        s = b[..., i, :]
        for j in range(i):
            s = s - l[..., i, j, None] * ys[j]
        ys.append(s / l[..., i, i, None] if inv is None else s * inv[..., i, None])
    return torch.stack(ys, -2)


def _solve_upper_t(l, y, inv=None):
    n = l.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        s = y[..., i, :]
        for j in range(i + 1, n):
            s = s - l[..., j, i, None] * xs[j]
        xs[i] = s / l[..., i, i, None] if inv is None else s * inv[..., i, None]
    return torch.stack(xs, -2)


def chol_solve_small(a, b):
    """Solve a @ x = b for SPD a (..., n, n) and b (..., n, k); batch dims
    broadcast (a shared `a` is factored once, not once per batch entry:
    the same values either way)."""
    return chol_solve_factored(cholesky_small(a), b)


def chol_solve_factored(l, b):
    """chol_solve_small from the factor l = cholesky_small(a): the same
    values, for a matrix solved against many right-hand sides in turn."""
    return _solve_upper_t(l, _solve_lower(l, b))


def chol_solve_small_rcp(a, b):
    """chol_solve_small with each pivot's reciprocal 1 / l_jj (as the
    factorization computes it) multiplied in where the solve divides by
    l_jj: the box-QP's solves, in the CUDA kernels' order
    (kernels/csrc/lanes.cuh chol_solve_rcp)."""
    l = cholesky_small(a)
    inv = 1.0 / torch.diagonal(l, dim1=-2, dim2=-1)
    return _solve_upper_t(l, _solve_lower(l, b, inv), inv)


def chol_solve_vec(a, b):
    """Solve a @ x = b for SPD a (..., n, n) and a vector b (..., n)."""
    return chol_solve_small(a, b[..., None])[..., 0]
