"""Fully actuated SE(3) rigid body with direct body-wrench control, PyTorch.

Counterpart of `quadrotorilqr_tpu/models/se3_wrench.py:54-162`. The state
is the quadrotor's `State` (SE(3) x R^6, tangent [pose_lin, pose_ang,
vel_lin, vel_ang]); the control is u = [f_body (3), tau_body (3)]:

    d(pose)/dt = v (body twist)
    dv_lin/dt  = -g R^T e_z + f / m
    dv_ang/dt  = I^-1 (tau - omega x (I omega))

With f = [0, 0, sum(u_rotor)] and tau = moment_arms @ u_rotor it is the
quadrotor model (`wrench_from_rotors`). The manifold arithmetic (add, minus,
the Euler step and their Jacobians) is the quadrotor module's: it belongs
to the state, not to the vehicle.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..lie import so3
from ..ops.linalg import chol_solve_small, chol_solve_vec
from .quadrotor import (  # noqa: F401  the model protocol's shared state ops
    STATE_DIM,
    State,
    _ez,
    _matvec,
    add,
    add_jacobians,
    euler_step,
    euler_step_jacobians,
    minus,
    minus_jacobians,
    validate_inertia,
)

CONTROL_DIM = 6


@dataclass
class WrenchParams:
    """Mass, inertia (SPD 3x3) and gravity. Every leaf may carry a leading
    scenario dim (per-scenario params: then ALL leaves carry it)."""

    mass_kg: torch.Tensor  # (...)
    inertia: torch.Tensor  # (..., 3, 3)
    g_mpss: torch.Tensor  # (...)

    @staticmethod
    def create(mass_kg, inertia, g_mpss=9.81, dtype=None, device=None):
        inertia = torch.as_tensor(inertia, dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=inertia.dtype, device=inertia.device)
        return WrenchParams(mass_kg=as_t(mass_kg), inertia=inertia, g_mpss=as_t(g_mpss))

    @property
    def batched(self):
        return self.mass_kg.ndim >= 1

    def validate(self):
        """Host-side symmetric positive-definite check of the inertia."""
        validate_inertia(self.inertia)
        return self


def continuous_dynamics(params: WrenchParams, x: State, u):
    """State time-derivative as a 12-tangent (..., 12) [vel, accel]."""
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), _ez(u))
    acc_lin = -params.g_mpss[..., None] * r_t_ez + u[..., 0:3] / params.mass_kg[..., None]
    omega = x.vel[..., 3:6]
    i_omega = _matvec(params.inertia, omega)
    acc_ang = chol_solve_vec(params.inertia, u[..., 3:6] - so3.cross(omega, i_omega))
    return torch.cat([x.vel, acc_lin, acc_ang], -1)


def continuous_dynamics_jacobians(params: WrenchParams, x: State, u):
    """(xdot, J_x (..., 12, 12), J_u (..., 12, 6)), analytic. J_x has the
    quadrotor's blocks (the state coupling is the rigid body's); J_u is
    [[0], [I3 / m], [I^-1]]."""
    xdot = continuous_dynamics(params, x, u)
    batch = xdot.shape[:-1]
    kw = dict(dtype=xdot.dtype, device=xdot.device)

    j_x = torch.zeros(batch + (STATE_DIM, STATE_DIM), **kw)
    j_x[..., 0:6, 6:12] = torch.eye(6, **kw)
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), _ez(u))
    j_x[..., 6:9, 3:6] = -params.g_mpss[..., None, None] * so3.hat(r_t_ez)
    omega = x.vel[..., 3:6]
    i_omega = _matvec(params.inertia, omega)
    j_x[..., 9:12, 9:12] = -chol_solve_small(
        params.inertia, so3.hat(omega) @ params.inertia - so3.hat(i_omega)
    )

    j_u = torch.zeros(batch + (STATE_DIM, CONTROL_DIM), **kw)
    j_u[..., 6:9, 0:3] = torch.eye(3, **kw) / params.mass_kg[..., None, None]
    j_u[..., 9:12, 3:6] = chol_solve_small(
        params.inertia, torch.eye(3, **kw).expand(params.inertia.shape)
    )
    return xdot, j_x, j_u


def discrete_dynamics(params: WrenchParams, x: State, u, dt_s):
    """One Lie-Euler step of the continuous dynamics."""
    return euler_step(x, continuous_dynamics(params, x, u), dt_s)


def discrete_dynamics_jacobians(params: WrenchParams, x: State, u, dt_s):
    """(x_next, J_x (..., 12, 12), J_u (..., 12, 6)): the quadrotor's chain
    rule."""
    xdot, j_cont_x, j_cont_u = continuous_dynamics_jacobians(params, x, u)
    x_next, j_lhs, j_rhs = euler_step_jacobians(x, xdot, dt_s)
    return x_next, j_lhs + j_rhs @ j_cont_x, j_rhs @ j_cont_u


def wrench_from_rotors(quad_params, u_rotor):
    """Quadrotor rotor thrusts (..., 4) -> the equivalent body wrench
    (..., 6): [0, 0, sum u, moment_arms @ u]."""
    from .quadrotor import moment_arms

    thrust = u_rotor.sum(-1, keepdim=True)
    zeros = torch.zeros_like(thrust)
    tau = _matvec(moment_arms(quad_params), u_rotor)
    return torch.cat([zeros, zeros, thrust, tau], -1)
