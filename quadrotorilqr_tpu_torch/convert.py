"""Carry state across from the JAX package, and results back.

The JAX package's containers (QuadrotorParams, QuadraticTrackingCost,
Trajectory, State, SE3) are pytrees. Converted leaf by leaf to numpy arrays
(`jax.tree.map(np.asarray, x)`), they become the port's dataclasses here.
Fields are read by attribute name, so this module imports nothing of JAX.
Shared and per-scenario leaves pass through with their shapes unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .costs.quadratic import QuadraticTrackingCost
from .lie.se3 import SE3
from .models.quadrotor import QuadrotorParams, State
from .solver.ilqr import Trajectory
from .tree import tree_map


def _tensor(a, dtype=None, device=None):
    # copies: the arrays may be read-only views of another framework's buffers
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def se3_from_numpy(x, dtype=None, device=None) -> SE3:
    return SE3(quat=_tensor(x.quat, dtype, device), trans=_tensor(x.trans, dtype, device))


def state_from_numpy(x, dtype=None, device=None) -> State:
    return State(
        pose=se3_from_numpy(x.pose, dtype, device), vel=_tensor(x.vel, dtype, device)
    )


def trajectory_from_numpy(t, dtype=None, device=None) -> Trajectory:
    return Trajectory(
        times=_tensor(t.times, dtype, device),
        states=state_from_numpy(t.states, dtype, device),
        controls=_tensor(t.controls, dtype, device),
    )


def params_from_numpy(p, dtype=None, device=None) -> QuadrotorParams:
    return QuadrotorParams(
        mass_kg=_tensor(p.mass_kg, dtype, device),
        inertia=_tensor(p.inertia, dtype, device),
        arm_length_m=_tensor(p.arm_length_m, dtype, device),
        torque_to_thrust_ratio_m=_tensor(p.torque_to_thrust_ratio_m, dtype, device),
        g_mpss=_tensor(p.g_mpss, dtype, device),
    )


def cost_from_numpy(c, dtype=None, device=None) -> QuadraticTrackingCost:
    weights = getattr(c, "stage_weights", None)
    return QuadraticTrackingCost(
        Q=_tensor(c.Q, dtype, device),
        R=_tensor(c.R, dtype, device),
        desired_states=state_from_numpy(c.desired_states, dtype, device),
        desired_controls=_tensor(c.desired_controls, dtype, device),
        stage_weights=None if weights is None else _tensor(weights, dtype, device),
    )


def to_numpy(obj):
    """The port's containers (a bare tensor, or a tuple of them) with numpy
    leaves."""
    if isinstance(obj, tuple):
        return tuple(to_numpy(o) for o in obj)
    return tree_map(lambda a: a.detach().cpu().numpy(), obj)
