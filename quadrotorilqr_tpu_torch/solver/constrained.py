"""Control-limited iLQR: box constraints lo <= u <= hi, batched over B.

Counterpart of `quadrotorilqr_tpu/solver/constrained.py` (control-limited
DDP after Tassa, Mansard & Todorov, ICRA 2014):

  * backward pass: each stage's gain solve is the box-QP
        min_du  1/2 du' Quu du + Qu' du   s.t.  lo - u <= du <= hi - u
    by projected Newton with a fixed iteration count (`_PN_ITERS` masked
    4x4 Cholesky solves, multiplying by the pivots' reciprocals as the
    kernels do: `ops.linalg.chol_solve_small_rcp`); the feedback rows of
    clamped controls are zero, and the value update takes its general-gain
    form;
  * rollout: u = clip(u_old + alpha k + K (x (-) x_old), lo, hi), which
    `solver.ilqr.forward_sim` runs when given `limits`;
  * outer loop, line search, convergence: the exact loop of
    `solver.ilqr.solve_loop`, as `kernels.solve.counted_plain_solve` runs it.

`backward_pass_box` with the clamped rollout makes the plain versions that
the CUDA kernels' box variants (`csrc/backward.cu`, `rollout.cu`,
`solve.cu` with `kBox`) are held against. Bounds are scalars, (u,) shared,
or (B, u) per scenario (`prep_limits`), u the control width; the kernels'
box variants are the quadrotor's (u = 4).
"""

from __future__ import annotations

import torch

from ..ops.linalg import chol_solve_small_rcp
from .ilqr import Trajectory, backward_pass

# Projected-Newton iterations per stage (the JAX package's): the active set
# of a 4-dim box-QP settles within 4 changes along the Newton path.
_PN_ITERS = 4


def _bound(b, dtype, device):
    """A bound as a tensor on `device`: a Python number is filled there,
    with no copy from the host (a copy would sync every MPC tick)."""
    if isinstance(b, (int, float)):
        return torch.full((), b, dtype=dtype, device=device)
    return torch.as_tensor(b, dtype=dtype, device=device)


def prep_limits(limits, batch, dtype, device, u_dim):
    """(lo, hi) as tensors: both (u,) when each bound is a scalar or (u,)
    shared by the batch, both (B, u) when either is per scenario (a shared
    one is broadcast up), as the JAX package's `_prep_limits`; u = u_dim."""
    lo, hi = (_bound(b, dtype, device) for b in limits)
    shape = (batch, u_dim) if lo.ndim == 2 or hi.ndim == 2 else (u_dim,)
    for b in (lo, hi):
        if b.ndim > 2 or (b.ndim == 2 and b.shape[0] != batch):
            raise ValueError(
                f"a bound of shape {tuple(b.shape)}: expected (), ({u_dim},) or ({batch}, {u_dim})"
            )
    return lo.expand(shape).contiguous(), hi.expand(shape).contiguous()


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _diag(v):
    return v[..., :, None] * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)


def _solve_vec(a, b):
    return chol_solve_small_rcp(a, b[..., None])[..., 0]


def _boxqp_gains(q_uu, q_u, q_ux, lo_d, hi_d):
    """Projected-Newton box-QP of one stage, batched over leading dims.

    Returns (k, K): the clamped feedforward step and the feedback with the
    rows of clamped controls zero."""
    dtype = q_u.dtype
    eps = 1e-9 if dtype == torch.float64 else 1e-6
    # the unconstrained Newton step, clipped into the box
    delta = torch.clamp(-_solve_vec(q_uu, q_u), lo_d, hi_d)
    free = torch.ones_like(delta)
    for _ in range(_PN_ITERS):
        grad = q_u + _matvec(q_uu, delta)
        clamped = ((delta <= lo_d + eps) & (grad > 0)) | ((delta >= hi_d - eps) & (grad < 0))
        free = (~clamped).to(dtype)
        held = clamped.to(dtype)
        # Quu on the free block, the identity on the clamped one
        a = q_uu * free[..., :, None] * free[..., None, :] + _diag(held)
        rhs = q_u + _matvec(q_uu, delta * held)
        step = -_solve_vec(a, rhs * free)  # clamped rows solve to 0
        delta = torch.clamp(step + delta * held, lo_d, hi_d)
    # feedback on the final free set only
    a = q_uu * free[..., :, None] * free[..., None, :] + _diag(1.0 - free)
    return delta, -chol_solve_small_rcp(a, q_ux * free[..., :, None])


def box_gains_update(q_x, q_u, q_xx, q_uu, q_xu, lo_d, hi_d):
    """The box-QP gains and the general-gain value update (the clamped rows
    of K are zero, so the unconstrained simplification no longer holds),
    with the per-stage symmetrization of V_xx.

    Returns (k, K, v_x', v_xx', Qu.k, k.Quu.k), as
    `solver.ilqr.riccati_gains_update`."""
    k, big_k = _boxqp_gains(q_uu, q_u, q_xu.transpose(-1, -2), lo_d, hi_d)
    quu_k = _matvec(q_uu, k)
    big_kt = big_k.transpose(-1, -2)
    v_x_new = q_x + _matvec(big_kt, quu_k) + _matvec(big_kt, q_u) + _matvec(q_xu, k)
    s = q_xx + q_xu @ big_k + big_kt @ q_xu.transpose(-1, -2) + big_kt @ (q_uu @ big_k)
    v_xx_new = 0.5 * (s + s.transpose(-1, -2))
    return k, big_k, v_x_new, v_xx_new, (q_u * k).sum(-1), (k * quu_k).sum(-1)


def backward_pass_box(params, cost, traj: Trajectory, dt_s, limits, quu_reg=0.0, model=None):
    """Riccati recursion with per-stage box-QP gains over (..., N, ...)
    trajectories; `limits` = (lo, hi) broadcasting against (..., u).
    Returns (ks, Ks, QuTk, kTQuuk), as `solver.ilqr.backward_pass`."""
    lo, hi = limits

    def gains(q_x, q_u, q_xx, q_uu, q_xu, n):
        u = traj.controls[..., n, :]
        return box_gains_update(q_x, q_u, q_xx, q_uu, q_xu, lo - u, hi - u)

    return backward_pass(params, cost, traj, dt_s, quu_reg, gains_update=gains, model=model)
