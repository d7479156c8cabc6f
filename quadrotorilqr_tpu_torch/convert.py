"""Carry state across from the JAX package, and results back.

The JAX package's containers (QuadrotorParams, DragQuadrotorParams,
WrenchParams, MultirotorParams, QuadraticTrackingCost, Trajectory, State, SE3) are
pytrees. Converted leaf by leaf to numpy arrays
(`jax.tree.map(np.asarray, x)`), they become the port's dataclasses here.
Fields are read by attribute name, so this module imports nothing of JAX.
Shared and per-scenario leaves pass through with their shapes unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .costs.quadratic import QuadraticTrackingCost
from .lie.se3 import SE3
from .models.multirotor import MultirotorParams
from .models.quadrotor import QuadrotorParams, State
from .models.quadrotor_drag import DragQuadrotorParams
from .models.se3_wrench import WrenchParams
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


def params_from_numpy(p, dtype=None, device=None):
    """A model family's params, the family told by the fields `p` carries:
    rotor positions make a MultirotorParams, drag coefficients a
    DragQuadrotorParams, an arm length a QuadrotorParams, mass, inertia and
    gravity alone a WrenchParams."""
    if hasattr(p, "rotor_positions_m"):
        cls = MultirotorParams
    elif hasattr(p, "drag_lin"):
        cls = DragQuadrotorParams
    elif hasattr(p, "arm_length_m"):
        cls = QuadrotorParams
    else:
        cls = WrenchParams
    return cls(**{
        f.name: _tensor(getattr(p, f.name), dtype, device) for f in dataclasses.fields(cls)
    })


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
