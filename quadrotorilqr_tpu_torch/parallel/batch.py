"""Batch helpers (`quadrotorilqr_tpu/parallel/batch.py:158-178`)."""

from __future__ import annotations

from ..solver.ilqr import Trajectory
from ..tree import tree_map


def initial_trajectory_from_state(x0, desired: Trajectory) -> Trajectory:
    """The desired trajectory's times and controls with each scenario's
    initial state at stage 0. x0 leaves may carry a leading batch dim;
    `desired` is shared. The solver's trip-0 full rollout makes it feasible."""
    batch = x0.vel.shape[:-1]

    def with_x0(leaf, x):
        out = leaf.expand(batch + leaf.shape).clone()
        out[..., 0, :] = x
        return out

    return Trajectory(
        times=desired.times.expand(batch + desired.times.shape).clone(),
        states=tree_map(with_x0, desired.states, x0),
        controls=desired.controls.expand(batch + desired.controls.shape).clone(),
    )
