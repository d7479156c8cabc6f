"""Quadratic Lie-residual tracking cost with Gauss-Newton differentials.

Counterpart of `quadrotorilqr_tpu/costs/quadratic.py`:

    J(x, u, i) = dx' Q dx + du' R du        (no 1/2 factor)
    dx = x (-) x_d[i],  du = u - u_d[i]
    C.x = 2 dx' Q J_dx,  C.xx = 2 J_dx' Q J_dx,  C.u = 2 du' R,  C.uu = 2 R,
    C.xu = 0

with J_dx = d(x (-) x_d)/dx (Gauss-Newton: the curvature of (-) is dropped).

Stage weights are not ported yet (ROADMAP Queue 1 item 5, "stage_weights").
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import quadrotor as qm
from ..models.quadrotor import State

STAGE_WEIGHTS_TODO = (
    "stage_weights are not ported yet (ROADMAP Queue 1 item 5, stage_weights)"
)


@dataclass
class QuadraticTrackingCost:
    """Q (..., 12, 12), R (..., 4, 4) and the stacked desired trajectory
    (leaves (..., N, d)). Each leaf may carry a leading scenario dim."""

    Q: torch.Tensor
    R: torch.Tensor
    desired_states: State
    desired_controls: torch.Tensor
    stage_weights: torch.Tensor | None = None


def check_supported(cost: QuadraticTrackingCost):
    if cost.stage_weights is not None:
        raise NotImplementedError(STAGE_WEIGHTS_TODO)


def cost_batched_flags(cost: QuadraticTrackingCost):
    """Same structure as `cost`, with bools marking the leaves that carry a
    leading per-scenario axis (every core is 2-dim except stage_weights)."""
    des = cost.desired_states
    return QuadraticTrackingCost(
        Q=cost.Q.ndim == 3,
        R=cost.R.ndim == 3,
        desired_states=State(
            pose=type(des.pose)(quat=des.pose.quat.ndim == 3, trans=des.pose.trans.ndim == 3),
            vel=des.vel.ndim == 3,
        ),
        desired_controls=cost.desired_controls.ndim == 3,
        stage_weights=(
            None if cost.stage_weights is None else cost.stage_weights.ndim == 2
        ),
    )


def _weights_over_stages(cost: QuadraticTrackingCost):
    """(Q, R) shaped to broadcast against (B, N, ...) stage stacks."""
    q = cost.Q[:, None] if cost.Q.ndim == 3 else cost.Q
    r = cost.R[:, None] if cost.R.ndim == 3 else cost.R
    return q, r


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def stage_cost_with_diffs(cost: QuadraticTrackingCost, x: State, u, x_d: State, u_d):
    """(J, C_x, C_u, C_xx, C_uu) for stage-stacked (B, N, ...) states."""
    q, r = _weights_over_stages(cost)
    dx, j_dx, _ = qm.minus_jacobians(x, x_d)
    du = u - u_d
    q_dx = _matvec(q, dx)
    r_du = _matvec(r, du)
    j = (dx * q_dx).sum(-1) + (du * r_du).sum(-1)
    c_x = 2.0 * (j_dx.transpose(-1, -2) @ q_dx[..., None])[..., 0]
    c_xx = 2.0 * (j_dx.transpose(-1, -2) @ q @ j_dx)
    c_u = 2.0 * r_du
    c_uu = 2.0 * r
    return j, c_x, c_u, c_xx, c_uu


def per_stage_terms(cost: QuadraticTrackingCost, states: State, controls):
    """(dx'Q dx, du'R du), each (..., N): the two summands of every stage."""
    q, r = _weights_over_stages(cost)
    dx = qm.minus(states, cost.desired_states)
    du = controls - cost.desired_controls
    return (dx * _matvec(q, dx)).sum(-1), (du * _matvec(r, du)).sum(-1)


def per_stage_costs(cost: QuadraticTrackingCost, states: State, controls):
    """Per-stage cost (..., N), dx'Q dx + du'R du: the summands the FDDP line
    search folds stage by stage (solver/fddp.py), never with a pairwise sum."""
    check_supported(cost)
    xq, ur = per_stage_terms(cost, states, controls)
    return xq + ur


def trajectory_cost(cost: QuadraticTrackingCost, states: State, controls):
    """Total cost of a stacked trajectory, accumulated stage by stage in the
    kernels' order `cost + dx'Q dx + du'R du`. A pairwise `sum` over N would
    round differently in float32 and move line-search accept boundaries."""
    check_supported(cost)
    xq, ur = per_stage_terms(cost, states, controls)
    total = torch.zeros_like(xq[..., 0])
    for n in range(xq.shape[-1]):
        total = total + xq[..., n] + ur[..., n]
    return total
