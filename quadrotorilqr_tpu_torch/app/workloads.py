"""Canonical workloads: the hover-to-waypoint benchmark problem, the
long-horizon problem, the aggressive tumble and the reference demo's
parameters and weights (`quadrotorilqr_tpu/app/workloads.py`).

Random draws come from an explicit `torch.Generator`; they do not reproduce
`jax.random`'s numbers for the same seed.
"""

from __future__ import annotations

import torch

from ..costs.quadratic import QuadraticTrackingCost
from ..lie import se3
from ..models.quadrotor import QuadrotorParams, State
from ..parallel.batch import initial_trajectory_from_state
from ..solver.ilqr import Trajectory


def demo_params(dtype=torch.float64, device=None) -> QuadrotorParams:
    """The reference demo's vehicle: 1 kg, unit inertia, 1 m arms."""
    return QuadrotorParams.create(
        mass_kg=1.0,
        inertia=torch.eye(3, dtype=dtype),
        arm_length_m=1.0,
        torque_to_thrust_ratio_m=0.0,
        g_mpss=9.81,
        device=device,
    )


def demo_weights(dtype=torch.float64, device=None):
    """Q = diag(100 * 1_6, 1_6), R = I_4."""
    q = torch.diag(
        torch.cat([100.0 * torch.ones(6, dtype=dtype), torch.ones(6, dtype=dtype)])
    ).to(device)
    r = torch.eye(4, dtype=dtype, device=device)
    return q, r


def hover_to_waypoint(
    generator: torch.Generator, batch, n=100, dt_s=0.02, dtype=torch.float32,
    pose_scale=1.0, device=None,
):
    """Randomized initial SE(3) poses and velocities, and a common hover
    target at the origin with hover thrust (BASELINE.json config 2).

    Returns (initial states with (batch, ...) leaves, desired Trajectory)."""
    draw = lambda shape: torch.randn(
        shape, generator=generator, dtype=dtype, device=generator.device
    ).to(device)
    tau = pose_scale * draw((batch, 6))
    tau[:, 3:6] *= 0.5
    vel = 0.1 * draw((batch, 6))
    init_states = State(pose=se3.exp(tau), vel=vel)
    desired = Trajectory(
        times=torch.arange(n, dtype=dtype, device=device) * dt_s,
        states=State(
            pose=se3.identity((n,), dtype, device),
            vel=torch.zeros((n, 6), dtype=dtype, device=device),
        ),
        controls=torch.full((n, 4), 9.81 / 4.0, dtype=dtype, device=device),
    )
    return init_states, desired


def long_horizon_problem(
    generator: torch.Generator, batch, n, dtype=torch.float32, dt_s=0.02, device=None
):
    """The long-horizon problem of the JAX package's benchmarks and f32
    stability tests (`quadrotorilqr_tpu/app/workloads.py:143-174`):
    hover-to-waypoint starts at pose scale 0.4, the demo weights, and a
    1.3 kg vehicle with inertia diag(0.4, 0.5, 0.6) + 0.05, 0.2 m arms and
    torque ratio 0.016.

    Returns (params, cost, initial trajectories with (batch, n, ...) leaves)."""
    init_states, desired = hover_to_waypoint(
        generator, batch, n=n, dt_s=dt_s, dtype=dtype, pose_scale=0.4, device=device
    )
    q, r = demo_weights(dtype, device)
    cost = QuadraticTrackingCost(
        Q=q, R=r, desired_states=desired.states, desired_controls=desired.controls
    )
    params = QuadrotorParams.create(
        mass_kg=1.3,
        inertia=torch.diag(torch.tensor([0.4, 0.5, 0.6], dtype=dtype)) + 0.05,
        arm_length_m=0.2,
        torque_to_thrust_ratio_m=0.016,
        g_mpss=9.81,
        device=device,
    )
    return params, cost, initial_trajectory_from_state(init_states, desired)


def aggressive_tumble(
    generator: torch.Generator, batch, n=50, dt_s=0.1, scale=1.8, dtype=torch.float32,
    device=None,
):
    """The aggressive-tumble class of the robust solver's headline
    (benchmarks/run_all.py config 6): initial pose Exp(scale N(0, I_6)) and
    body twist scale N(0, I_6), coarse dt, a hover target at the origin. Its
    vehicle: 1 kg, inertia diag(0.01, 0.012, 0.02), 0.17 m arms, torque
    ratio 0.016; its weights Q = diag(100 1_6, 1_6), R = 1e-3 I_4.

    Returns (params, Q, R, initial states with (batch, ...) leaves, desired
    Trajectory)."""
    draw = lambda shape: torch.randn(
        shape, generator=generator, dtype=dtype, device=generator.device
    ).to(device)
    init_states = State(pose=se3.exp(scale * draw((batch, 6))), vel=scale * draw((batch, 6)))
    params = QuadrotorParams.create(
        mass_kg=1.0,
        inertia=torch.diag(torch.tensor([0.01, 0.012, 0.02], dtype=dtype)),
        arm_length_m=0.17,
        torque_to_thrust_ratio_m=0.016,
        g_mpss=9.81,
        device=device,
    )
    q = torch.diag(torch.tensor([100.0] * 6 + [1.0] * 6, dtype=dtype)).to(device)
    r = 1e-3 * torch.eye(4, dtype=dtype, device=device)
    desired = Trajectory(
        times=torch.arange(n, dtype=dtype, device=device) * dt_s,
        states=State(
            pose=se3.identity((n,), dtype, device),
            vel=torch.zeros((n, 6), dtype=dtype, device=device),
        ),
        controls=torch.full((n, 4), 9.81 / 4.0, dtype=dtype, device=device),
    )
    return params, q, r, init_states, desired
