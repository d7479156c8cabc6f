"""SE(3) x R^6 quadrotor rigid-body model with analytic Jacobians, PyTorch.

Counterpart of `quadrotorilqr_tpu/models/quadrotor.py`. The state is
`State(pose: SE3, vel: (..., 6) [lin, ang])`; its 12-dim tangent is ordered
[pose_lin, pose_ang, vel_lin, vel_ang] and the controls are 4 rotor thrusts.

    d(pose)/dt = v (body twist)
    dv_lin/dt  = -g R^T e_z + (sum u) e_z / m
    dv_ang/dt  = I^-1 (moment_arms @ u - omega x (I omega))

The discrete step is Lie-Euler, x' = (pose (+) dt v, vel + dt a), with the
chain-ruled Jacobians J_x = J_lhs + dt J_rhs J_cont_x, J_u = dt J_rhs J_cont_u.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..lie import se3, so3
from ..lie.se3 import SE3
from ..ops.linalg import chol_solve_factored, chol_solve_small, cholesky_small

STATE_DIM = 12
CONTROL_DIM = 4


@dataclass
class State:
    """Pose in SE(3) and body velocity twist (..., 6) [lin, ang]."""

    pose: SE3
    vel: torch.Tensor


@dataclass
class QuadrotorParams:
    """Physical parameters. Every leaf may carry a leading scenario dim
    (per-scenario params: then ALL leaves carry it)."""

    mass_kg: torch.Tensor  # (...)
    inertia: torch.Tensor  # (..., 3, 3) symmetric positive definite
    arm_length_m: torch.Tensor  # (...)
    torque_to_thrust_ratio_m: torch.Tensor  # (...)
    g_mpss: torch.Tensor  # (...)

    @staticmethod
    def create(
        mass_kg, inertia, arm_length_m, torque_to_thrust_ratio_m, g_mpss=9.81,
        dtype=None, device=None,
    ):
        inertia = torch.as_tensor(inertia, dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=inertia.dtype, device=inertia.device)
        return QuadrotorParams(
            mass_kg=as_t(mass_kg),
            inertia=inertia,
            arm_length_m=as_t(arm_length_m),
            torque_to_thrust_ratio_m=as_t(torque_to_thrust_ratio_m),
            g_mpss=as_t(g_mpss),
        )

    @property
    def batched(self):
        return self.mass_kg.ndim >= 1

    def validate(self):
        """Host-side symmetric positive-definite check of the inertia."""
        validate_inertia(self.inertia)
        return self


def validate_inertia(inertia):
    """Raise unless the inertia (..., 3, 3) is symmetric positive definite."""
    inertia = inertia.detach().cpu().numpy()
    if not np.allclose(inertia, np.swapaxes(inertia, -1, -2)):
        raise ValueError("Inertia matrix is not symmetric!")
    if not (np.linalg.eigvalsh(inertia) > 0).all():
        raise ValueError("Inertia matrix is not positive definite!")


def params_over_stages(params):
    """Per-scenario params (B, ...) -> (B, 1, ...), so they broadcast
    against (B, N, ...) stage-stacked states; any model family's params
    dataclass. Shared params pass through."""
    if not params.batched:
        return params
    return dataclasses.replace(
        params, **{f.name: getattr(params, f.name)[:, None] for f in dataclasses.fields(params)}
    )


def moment_arms(params: QuadrotorParams):
    """(..., 3, 4) rotor-force -> body-torque map."""
    length = params.arm_length_m
    kappa = params.torque_to_thrust_ratio_m
    zero = torch.zeros_like(length)
    return torch.stack(
        [
            torch.stack([zero, -length, zero, length], -1),
            torch.stack([length, zero, -length, zero], -1),
            torch.stack([-kappa, kappa, -kappa, kappa], -1),
        ],
        -2,
    )


def _ez(like):
    # the identity's last row: made on the device (writing a Python 1.0 into
    # a CUDA tensor would copy it from the host and sync every call)
    ez = torch.eye(3, dtype=like.dtype, device=like.device)[2]
    return ez.expand(like.shape[:-1] + (3,))


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def continuous_dynamics(params: QuadrotorParams, x: State, u):
    """State time-derivative as a 12-tangent (..., 12) [vel, accel]."""
    return _continuous(params, moment_arms(params), cholesky_small(params.inertia), x, u)


def _continuous(params, arms, inertia_factor, x, u):
    """continuous_dynamics with the params' moment arms and the Cholesky
    factor of the inertia given."""
    ez = _ez(u)
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), ez)
    acc_lin = (
        -params.g_mpss[..., None] * r_t_ez
        + (u.sum(-1) / params.mass_kg)[..., None] * ez
    )
    omega = x.vel[..., 3:6]
    torque = _matvec(arms, u)
    i_omega = _matvec(params.inertia, omega)
    acc_ang = chol_solve_factored(inertia_factor, (torque - so3.cross(omega, i_omega))[..., None])
    return torch.cat([x.vel, acc_lin, acc_ang[..., 0]], -1)


def continuous_dynamics_jacobians(params: QuadrotorParams, x: State, u):
    """(xdot, J_x (..., 12, 12), J_u (..., 12, 4)), analytic."""
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
    j_u[..., 8, :] = (1.0 / params.mass_kg)[..., None]
    j_u[..., 9:12, :] = chol_solve_small(params.inertia, moment_arms(params))
    return xdot, j_x, j_u


def add(x: State, tangent):
    """State (+) 12-tangent: pose right-plus, velocity add."""
    return State(pose=se3.plus(x.pose, tangent[..., 0:6]), vel=x.vel + tangent[..., 6:12])


def add_jacobians(x: State, tangent):
    """(x (+) t, J_lhs, J_rhs): the SE(3) plus-Jacobians inside 12x12 identities."""
    pose_next, j_plus_x, j_plus_t = se3.plus_jacobians(x.pose, tangent[..., 0:6])
    added = State(pose=pose_next, vel=x.vel + tangent[..., 6:12])
    batch = added.vel.shape[:-1]
    eye = torch.eye(STATE_DIM, dtype=added.vel.dtype, device=added.vel.device)
    j_lhs = eye.expand(batch + (12, 12)).clone()
    j_lhs[..., 0:6, 0:6] = j_plus_x
    j_rhs = eye.expand(batch + (12, 12)).clone()
    j_rhs[..., 0:6, 0:6] = j_plus_t
    return added, j_lhs, j_rhs


def minus(lhs: State, rhs: State):
    """12-tangent [pose_lhs (-) pose_rhs, vel_lhs - vel_rhs]."""
    return torch.cat([se3.minus(lhs.pose, rhs.pose), lhs.vel - rhs.vel], -1)


def minus_jacobians(lhs: State, rhs: State):
    """(lhs (-) rhs, J_lhs, J_rhs): pose blocks Jr^-1(tau) and -Jl^-1(tau)."""
    tau, j_minus_lhs, j_minus_rhs = se3.minus_jacobians(lhs.pose, rhs.pose)
    diff = torch.cat([tau, lhs.vel - rhs.vel], -1)
    batch = diff.shape[:-1]
    eye = torch.eye(STATE_DIM, dtype=diff.dtype, device=diff.device)
    j_lhs = eye.expand(batch + (12, 12)).clone()
    j_lhs[..., 0:6, 0:6] = j_minus_lhs
    j_rhs = (-eye).expand(batch + (12, 12)).clone()
    j_rhs[..., 0:6, 0:6] = j_minus_rhs
    return diff, j_lhs, j_rhs


def euler_step(x: State, xdot, dt_s):
    return add(x, dt_s * xdot)


def euler_step_jacobians(x: State, xdot, dt_s):
    x_next, j_lhs, j_rhs = add_jacobians(x, dt_s * xdot)
    return x_next, j_lhs, dt_s * j_rhs


def discrete_dynamics(params: QuadrotorParams, x: State, u, dt_s):
    """One Lie-Euler step of the continuous dynamics."""
    return euler_step(x, continuous_dynamics(params, x, u), dt_s)


def dynamics_step(params: QuadrotorParams, dt_s):
    """discrete_dynamics(params, ., ., dt_s) as a function of (x, u), the
    params' moment arms and inertia factor made once: the same values in
    fewer operations, for the plain loops' stage-by-stage rollouts."""
    arms, factor = moment_arms(params), cholesky_small(params.inertia)
    return lambda x, u: euler_step(x, _continuous(params, arms, factor, x, u), dt_s)


def discrete_dynamics_jacobians(params: QuadrotorParams, x: State, u, dt_s):
    """(x_next, J_x (..., 12, 12), J_u (..., 12, 4))."""
    xdot, j_cont_x, j_cont_u = continuous_dynamics_jacobians(params, x, u)
    x_next, j_lhs, j_rhs = euler_step_jacobians(x, xdot, dt_s)
    return x_next, j_lhs + j_rhs @ j_cont_x, j_rhs @ j_cont_u
