"""Dynamics models. The solver is model-generic: a module with the
quadrotor module's functions (discrete_dynamics[_jacobians], minus[_jacobians],
add) plugs in; the solvers resolve the module from the params type
(`solver.ilqr.resolve_model`). `integrators` wraps a module into its
substepped (`substepped(model, k)`) or chart-RK4 (`rk4(model)`) variant."""

from . import integrators, multirotor, quadrotor, quadrotor_drag, se3_wrench
from .integrators import rk4, substepped
from .multirotor import MultirotorParams
from .quadrotor import QuadrotorParams, State
from .quadrotor_drag import DragQuadrotorParams
from .se3_wrench import WrenchParams

__all__ = [
    "quadrotor",
    "quadrotor_drag",
    "se3_wrench",
    "multirotor",
    "integrators",
    "substepped",
    "rk4",
    "QuadrotorParams",
    "DragQuadrotorParams",
    "WrenchParams",
    "MultirotorParams",
    "State",
]
