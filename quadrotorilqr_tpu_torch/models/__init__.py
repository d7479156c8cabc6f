"""Dynamics models. The solver is model-generic: a module with the
quadrotor module's functions (discrete_dynamics[_jacobians], minus[_jacobians],
add) plugs in; the solvers resolve the module from the params type
(`solver.ilqr.resolve_model`)."""

from . import multirotor, quadrotor, se3_wrench
from .multirotor import MultirotorParams
from .quadrotor import QuadrotorParams, State
from .se3_wrench import WrenchParams

__all__ = [
    "quadrotor",
    "se3_wrench",
    "multirotor",
    "QuadrotorParams",
    "WrenchParams",
    "MultirotorParams",
    "State",
]
