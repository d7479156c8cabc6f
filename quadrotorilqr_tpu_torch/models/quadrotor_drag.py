"""Quadrotor with linear body-frame drag, PyTorch.

Counterpart of `quadrotorilqr_tpu/models/quadrotor_drag.py`. The quadrotor
of `models/quadrotor.py` with diagonal drag on the body linear and angular
velocity:

    dv_lin/dt += -(1/m) diag(drag_lin) v_lin
    dv_ang/dt += -I^-1  diag(drag_ang) v_ang

The control map is unchanged. The drag couples only the velocity blocks of
the Jacobian, diagonally, so the kernels keep the quadrotor's j_x blocks
with the velocity block I3 - dt diag(drag_lin / m) and the -I^-1
diag(drag_ang) term folded into the angular one
(`kernels.models.DRAG_QUADROTOR`, csrc/quadrotor.cuh `DragQuadrotor`).
With zero coefficients every function here gives the quadrotor's values.
The manifold arithmetic (add, minus, the Euler step and their Jacobians)
is the quadrotor module's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..lie import so3
from ..ops.linalg import chol_solve_factored, chol_solve_small, cholesky_small
from .quadrotor import (  # noqa: F401  the model protocol's shared state ops
    CONTROL_DIM,
    STATE_DIM,
    QuadrotorParams,
    State,
    _ez,
    _matvec,
    add,
    add_jacobians,
    euler_step,
    euler_step_jacobians,
    minus,
    minus_jacobians,
    moment_arms,
    validate_inertia,
)


@dataclass
class DragQuadrotorParams:
    """QuadrotorParams and the body-frame drag coefficients. Every leaf may
    carry a leading scenario dim (per-scenario params: then ALL leaves
    carry it)."""

    mass_kg: torch.Tensor  # (...)
    inertia: torch.Tensor  # (..., 3, 3) symmetric positive definite
    arm_length_m: torch.Tensor  # (...)
    torque_to_thrust_ratio_m: torch.Tensor  # (...)
    g_mpss: torch.Tensor  # (...)
    drag_lin: torch.Tensor  # (..., 3) N per (m/s), body frame
    drag_ang: torch.Tensor  # (..., 3) N m per (rad/s), body frame

    @staticmethod
    def create(mass_kg, inertia, arm_length_m, torque_to_thrust_ratio_m, drag_lin, drag_ang,
               g_mpss=9.81, dtype=None, device=None):
        inertia = torch.as_tensor(inertia, dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=inertia.dtype, device=inertia.device)
        return DragQuadrotorParams(
            mass_kg=as_t(mass_kg),
            inertia=inertia,
            arm_length_m=as_t(arm_length_m),
            torque_to_thrust_ratio_m=as_t(torque_to_thrust_ratio_m),
            g_mpss=as_t(g_mpss),
            drag_lin=as_t(drag_lin),
            drag_ang=as_t(drag_ang),
        )

    @property
    def batched(self):
        return self.mass_kg.ndim >= 1

    def validate(self):
        """Host-side symmetric positive-definite check of the inertia."""
        validate_inertia(self.inertia)
        return self

    def dragless(self) -> QuadrotorParams:
        """The drag-free QuadrotorParams of the same rigid body."""
        return QuadrotorParams(
            mass_kg=self.mass_kg,
            inertia=self.inertia,
            arm_length_m=self.arm_length_m,
            torque_to_thrust_ratio_m=self.torque_to_thrust_ratio_m,
            g_mpss=self.g_mpss,
        )


def continuous_dynamics(params: DragQuadrotorParams, x: State, u):
    """State time-derivative as a 12-tangent (..., 12) [vel, accel]."""
    return _continuous(params, moment_arms(params), cholesky_small(params.inertia), x, u)


def _continuous(params, arms, inertia_factor, x, u):
    """continuous_dynamics with the params' moment arms and the Cholesky
    factor of the inertia given: the quadrotor's terms, then the drag."""
    ez = _ez(u)
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), ez)
    v_lin = x.vel[..., 0:3]
    acc_lin = (
        -params.g_mpss[..., None] * r_t_ez
        + (u.sum(-1) / params.mass_kg)[..., None] * ez
        - params.drag_lin * v_lin / params.mass_kg[..., None]
    )
    omega = x.vel[..., 3:6]
    torque = _matvec(arms, u)
    i_omega = _matvec(params.inertia, omega)
    rhs = torque - so3.cross(omega, i_omega) - params.drag_ang * omega
    acc_ang = chol_solve_factored(inertia_factor, rhs[..., None])
    return torch.cat([x.vel, acc_lin, acc_ang[..., 0]], -1)


def continuous_dynamics_jacobians(params: DragQuadrotorParams, x: State, u):
    """(xdot, J_x (..., 12, 12), J_u (..., 12, 4)), analytic: the
    quadrotor's blocks, d(acc_lin)/d(v_lin) = -diag(drag_lin) / m and
    diag(drag_ang) inside the I^-1 solve of d(acc_ang)/d(omega)."""
    xdot = continuous_dynamics(params, x, u)
    batch = xdot.shape[:-1]
    kw = dict(dtype=xdot.dtype, device=xdot.device)

    j_x = torch.zeros(batch + (STATE_DIM, STATE_DIM), **kw)
    j_x[..., 0:6, 6:12] = torch.eye(6, **kw)
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), _ez(u))
    j_x[..., 6:9, 3:6] = -params.g_mpss[..., None, None] * so3.hat(r_t_ez)
    dl = params.drag_lin / params.mass_kg[..., None]
    j_x[..., 6:9, 6:9] = -dl[..., None] * torch.eye(3, **kw)
    omega = x.vel[..., 3:6]
    i_omega = _matvec(params.inertia, omega)
    j_x[..., 9:12, 9:12] = -chol_solve_small(
        params.inertia,
        so3.hat(omega) @ params.inertia - so3.hat(i_omega) + torch.diag_embed(params.drag_ang),
    )

    j_u = torch.zeros(batch + (STATE_DIM, CONTROL_DIM), **kw)
    j_u[..., 8, :] = (1.0 / params.mass_kg)[..., None]
    j_u[..., 9:12, :] = chol_solve_small(params.inertia, moment_arms(params))
    return xdot, j_x, j_u


def discrete_dynamics(params: DragQuadrotorParams, x: State, u, dt_s):
    """One Lie-Euler step of the continuous dynamics."""
    return euler_step(x, continuous_dynamics(params, x, u), dt_s)


def dynamics_step(params: DragQuadrotorParams, dt_s):
    """discrete_dynamics(params, ., ., dt_s) as a function of (x, u), the
    moment arms and the inertia factor made once (the plain loops'
    stage-by-stage rollouts)."""
    arms, factor = moment_arms(params), cholesky_small(params.inertia)
    return lambda x, u: euler_step(x, _continuous(params, arms, factor, x, u), dt_s)


def discrete_dynamics_jacobians(params: DragQuadrotorParams, x: State, u, dt_s):
    """(x_next, J_x (..., 12, 12), J_u (..., 12, 4)): the quadrotor's chain
    rule."""
    xdot, j_cont_x, j_cont_u = continuous_dynamics_jacobians(params, x, u)
    x_next, j_lhs, j_rhs = euler_step_jacobians(x, xdot, dt_s)
    return x_next, j_lhs + j_rhs @ j_cont_x, j_rhs @ j_cont_u
