"""Generic multirotor: any rotor count and layout on the SE(3) x R^6 body, PyTorch.

Counterpart of `quadrotorilqr_tpu/models/multirotor.py:56-226`. R rotors
each thrust along body +z from a body-frame position, with a signed yaw
drag:

    torque_i = r_i x (u_i e_z) + spin_i kappa u_i e_z
    => moment map MA (3, R), column i = (y_i, -x_i, spin_i kappa)

so hexarotors, octorotors and asymmetric airframes are one family: the
quadrotor's drift with an affine control map. The reference quadrotor is
the case positions (-L, 0, 0), (0, -L, 0), (L, 0, 0), (0, L, 0), spins
(-, +, -, +) (`MultirotorParams.quadrotor`). The state space and its
manifold arithmetic are the quadrotor module's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


@dataclass
class MultirotorParams:
    """An R-rotor airframe. Every leaf may carry a leading scenario dim
    (per-scenario params: then ALL leaves carry it); the rotor count is
    fixed, positions and spins may differ per scenario."""

    mass_kg: torch.Tensor  # (...)
    inertia: torch.Tensor  # (..., 3, 3) symmetric positive definite
    rotor_positions_m: torch.Tensor  # (..., R, 3) body frame
    rotor_spin: torch.Tensor  # (..., R) +-1, the sign of the yaw drag torque
    torque_to_thrust_ratio_m: torch.Tensor  # (...)
    g_mpss: torch.Tensor  # (...)

    @staticmethod
    def create(
        mass_kg, inertia, rotor_positions_m, rotor_spin, torque_to_thrust_ratio_m, g_mpss=9.81,
        dtype=None, device=None,
    ):
        inertia = torch.as_tensor(inertia, dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=inertia.dtype, device=inertia.device)
        return MultirotorParams(
            mass_kg=as_t(mass_kg),
            inertia=inertia,
            rotor_positions_m=as_t(rotor_positions_m),
            rotor_spin=as_t(rotor_spin),
            torque_to_thrust_ratio_m=as_t(torque_to_thrust_ratio_m),
            g_mpss=as_t(g_mpss),
        )

    @staticmethod
    def quadrotor(mass_kg, inertia, arm_length_m, torque_to_thrust_ratio_m, g_mpss=9.81,
                  dtype=None, device=None):
        """The reference airframe: its moment map is the quadrotor model's
        moment_arms, column for column."""
        length = float(arm_length_m)
        positions = [(-length, 0.0, 0.0), (0.0, -length, 0.0), (length, 0.0, 0.0),
                     (0.0, length, 0.0)]
        return MultirotorParams.create(
            mass_kg, inertia, positions, (-1.0, 1.0, -1.0, 1.0), torque_to_thrust_ratio_m,
            g_mpss, dtype, device,
        )

    @staticmethod
    def regular(n_rotors, mass_kg, inertia, arm_length_m, torque_to_thrust_ratio_m,
                g_mpss=9.81, phase_rad=0.0, dtype=None, device=None):
        """A regular planar ring of `n_rotors` (a hexarotor at 6) with
        alternating spin, rotor i at angle phase + 2 pi i / R."""
        ang = phase_rad + 2.0 * np.pi * np.arange(n_rotors) / n_rotors
        positions = np.stack(
            [arm_length_m * np.cos(ang), arm_length_m * np.sin(ang), np.zeros(n_rotors)], -1
        )
        spins = np.where(np.arange(n_rotors) % 2 == 0, -1.0, 1.0)
        return MultirotorParams.create(
            mass_kg, inertia, positions, spins, torque_to_thrust_ratio_m, g_mpss, dtype, device
        )

    @property
    def n_rotors(self):
        return self.rotor_positions_m.shape[-2]

    @property
    def batched(self):
        return self.mass_kg.ndim >= 1

    def validate(self):
        """Host-side positive-definite check of the inertia and +-1 spins."""
        validate_inertia(self.inertia)
        if not np.isin(self.rotor_spin.detach().cpu().numpy(), (-1.0, 1.0)).all():
            raise ValueError("rotor_spin entries must be +-1")
        return self


def moment_map(params: MultirotorParams):
    """(..., 3, R) rotor-thrust -> body-torque map."""
    pos = params.rotor_positions_m
    yaw = params.rotor_spin * params.torque_to_thrust_ratio_m[..., None]
    return torch.stack([pos[..., 1], -pos[..., 0], yaw], -2)


def continuous_dynamics(params: MultirotorParams, x: State, u):
    """State time-derivative as a 12-tangent (..., 12) [vel, accel]: the
    quadrotor's drift with the generic moment map."""
    ez = _ez(u)
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(x.pose.quat), ez)
    acc_lin = (
        -params.g_mpss[..., None] * r_t_ez + (u.sum(-1) / params.mass_kg)[..., None] * ez
    )
    omega = x.vel[..., 3:6]
    torque = _matvec(moment_map(params), u)
    i_omega = _matvec(params.inertia, omega)
    acc_ang = chol_solve_vec(params.inertia, torque - so3.cross(omega, i_omega))
    return torch.cat([x.vel, acc_lin, acc_ang], -1)


def continuous_dynamics_jacobians(params: MultirotorParams, x: State, u):
    """(xdot, J_x (..., 12, 12), J_u (..., 12, R)), analytic: the J_x blocks
    are the airframe's rigid body, J_u carries the moment map."""
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

    j_u = torch.zeros(batch + (STATE_DIM, u.shape[-1]), **kw)
    j_u[..., 8, :] = (1.0 / params.mass_kg)[..., None]
    j_u[..., 9:12, :] = chol_solve_small(params.inertia, moment_map(params))
    return xdot, j_x, j_u


def discrete_dynamics(params: MultirotorParams, x: State, u, dt_s):
    """One Lie-Euler step of the continuous dynamics."""
    return euler_step(x, continuous_dynamics(params, x, u), dt_s)


def discrete_dynamics_jacobians(params: MultirotorParams, x: State, u, dt_s):
    """(x_next, J_x, J_u (..., 12, R)): the quadrotor's chain rule."""
    xdot, j_cont_x, j_cont_u = continuous_dynamics_jacobians(params, x, u)
    x_next, j_lhs, j_rhs = euler_step_jacobians(x, xdot, dt_s)
    return x_next, j_lhs + j_rhs @ j_cont_x, j_rhs @ j_cont_u
