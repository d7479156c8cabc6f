"""Canonical workloads: the reference demo's desired trajectory, vehicle
and weights (BASELINE config 1), the hover-to-waypoint benchmark problem,
the figure eight (BASELINE config 3), the long-horizon problem and the
aggressive tumble (`quadrotorilqr_tpu/app/workloads.py`).

The deterministic trajectories are built in float64 numpy, as the JAX
package builds them, then cast. Random draws come from an explicit
`torch.Generator`; they do not reproduce `jax.random`'s numbers for the
same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..costs.quadratic import QuadraticTrackingCost
from ..lie import se3
from ..models.quadrotor import QuadrotorParams, State
from ..parallel.batch import initial_trajectory_from_state
from ..solver.ilqr import Trajectory


def euler_xyz_to_quat(roll, pitch, yaw):
    """Extrinsic x-y-z Euler angles -> quaternion wxyz as a float64 numpy
    array (scipy's "xyz" order, the reference driver's)."""
    roll, pitch, yaw = (np.asarray(a, np.float64) for a in (roll, pitch, yaw))
    hr, hp, hy = roll / 2, pitch / 2, yaw / 2
    zero = np.zeros_like
    qx = np.stack([np.cos(hr), np.sin(hr), zero(hr), zero(hr)], -1)
    qy = np.stack([np.cos(hp), zero(hp), np.sin(hp), zero(hp)], -1)
    qz = np.stack([np.cos(hy), zero(hy), zero(hy), np.sin(hy)], -1)

    def mul(a, b):
        aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack(
            [
                aw * bw - ax * bx - ay * by - az * bz,
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
            ],
            -1,
        )

    return mul(qz, mul(qy, qx))  # extrinsic xyz == Rz @ Ry @ Rx


def _trajectory(times, quat, trans, controls, dtype, device) -> Trajectory:
    """A Trajectory with zero body velocities from float64 numpy arrays."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return Trajectory(
        times=as_t(times),
        states=State(
            pose=se3.SE3(quat=as_t(quat), trans=as_t(trans)),
            vel=torch.zeros((len(times), 6), dtype=dtype, device=device),
        ),
        controls=as_t(controls),
    )


def demo_desired_trajectory(
    dt_s=0.1, horizon_s=4.0, vel_mps=10.0, dtype=torch.float64, device=None
) -> Trajectory:
    """The reference's "climbing square" (BASELINE config 1): four legs of
    a square in xy, z climbing 0 -> 10, roll sweeping 0 -> pi, zero velocity
    and control targets; N = 40 at the default dt 0.1."""
    times = np.arange(0.0, horizon_s, dt_s)
    quarter = horizon_s / 4.0
    rows = []
    for t in times:
        if t < quarter:
            rows.append((vel_mps * t, 0.0, 0.0, 0.0))
        elif t < 2 * quarter:
            rows.append((vel_mps * quarter, vel_mps * (t - quarter), 10.0 / 3.0, np.pi / 3.0))
        elif t < 3 * quarter:
            rows.append(
                (vel_mps * (3 * quarter - t), vel_mps * quarter, 20.0 / 3.0, 2 * np.pi / 3.0)
            )
        else:
            rows.append((0.0, vel_mps * (4 * quarter - t), 10.0, np.pi))
    xyz_roll = np.asarray(rows, np.float64)
    n = len(times)
    quat = euler_xyz_to_quat(xyz_roll[:, 3], np.zeros(n), np.zeros(n))
    return _trajectory(times, quat, xyz_roll[:, :3], np.zeros((n, 4)), dtype, device)


def figure_eight(n=200, dt_s=0.02, radius=2.0, dtype=torch.float32, device=None) -> Trajectory:
    """The figure-eight (lemniscate) tracking target of BASELINE config 3,
    level attitude, hover thrust."""
    t = np.arange(n) * dt_s
    omega = 2 * np.pi / (n * dt_s)
    trans = np.stack(
        [
            radius * np.sin(omega * t),
            radius * np.sin(omega * t) * np.cos(omega * t),
            1.0 + 0.2 * np.sin(2 * omega * t),
        ],
        -1,
    )
    quat = np.zeros((n, 4))
    quat[:, 0] = 1.0
    return _trajectory(t, quat, trans, np.full((n, 4), 9.81 / 4.0), dtype, device)


def figure_eight_problem(
    rng: np.random.Generator, batch, n=200, dt_s=0.02, dtype=torch.float32, device=None
):
    """BASELINE config 3 as the JAX package's benchmark builds it
    (`benchmarks/run_all.py` config3_figure_eight): the figure eight, the
    demo weights with Q scaled per scenario by U(0.5, 2) and R per scenario,
    initial poses Exp(0.2 N(0, I_6)) at rest, a 1 kg vehicle with unit
    inertia, 0.2 m arms and torque ratio 0.016. The draws come from the
    numpy generator `rng`.

    Returns (params, cost, initial trajectories with (batch, n, ...) leaves)."""
    desired = figure_eight(n, dt_s, dtype=dtype, device=device)
    q, r = demo_weights(dtype, device)
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, size=batch), dtype=dtype, device=device)
    tau = torch.as_tensor(0.2 * rng.normal(size=(batch, 6)), dtype=dtype, device=device)
    cost = QuadraticTrackingCost(
        Q=scale[:, None, None] * q,
        R=r.expand(batch, 4, 4).clone(),
        desired_states=desired.states,
        desired_controls=desired.controls,
    )
    params = QuadrotorParams.create(
        mass_kg=1.0,
        inertia=torch.eye(3, dtype=dtype),
        arm_length_m=0.2,
        torque_to_thrust_ratio_m=0.016,
        g_mpss=9.81,
        device=device,
    )
    x0 = State(pose=se3.exp(tau), vel=torch.zeros((batch, 6), dtype=dtype, device=device))
    return params, cost, initial_trajectory_from_state(x0, desired)


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
