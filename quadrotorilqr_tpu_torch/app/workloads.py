"""Canonical workloads: the reference demo's desired trajectory, vehicle
and weights (BASELINE config 1), the hover-to-waypoint benchmark problem,
the figure eight (BASELINE config 3), the MPC hover-regulation problem
(BASELINE config 4) and the tumbling fleet the robust MPC recovers, the
long-horizon problem (with its rotor limits and terminal weight) and the
aggressive tumble (`quadrotorilqr_tpu/app/workloads.py`), and the
wider-control families' waypoint problems: the SE(3) body wrench (`benchmarks/wrench_bench.py`) and
the hexarotor (`__graft_entry__.py`), the constrained-flight problems
(the keep-out crossing and the tumbling class beside a keep-out), and the
bench workload's task on the drag quadrotor (`drag_problem`) and, through
`models.integrators.substepped(quadrotor, k)` with k in SUBSTEP_COUNTS, on
substepped integration (`bench_problem`).

The deterministic trajectories are built in float64 numpy, as the JAX
package builds them, then cast. Random draws come from an explicit
`torch.Generator`; they do not reproduce `jax.random`'s numbers for the
same seed.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..costs.quadratic import QuadraticTrackingCost
from ..lie import se3
from ..models.multirotor import MultirotorParams
from ..models.quadrotor import QuadrotorParams, State
from ..models.quadrotor_drag import DragQuadrotorParams
from ..models.se3_wrench import WrenchParams
from ..parallel.batch import initial_trajectory_from_state
from ..solver.ilqr import Trajectory
from ..solver.options import ConvergenceCriteria, ILQROptions, LineSearchParams


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


def long_horizon_limits():
    """Rotor limits (0, 1.3 x hover thrust) for `long_horizon_problem`'s
    1.3 kg vehicle: (0, 4.14) N."""
    return 0.0, 1.3 * 1.3 * 9.81 / 4.0


def terminal_weights(n, dtype=torch.float32, device=None):
    """(n,) stage weights [1, ..., 1, 20]: terminal emphasis (w_T = 20, the
    JAX package's tests/test_mpc.py:118-140)."""
    w = torch.ones(n, dtype=dtype, device=device)
    w[-1] = 20.0
    return w


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


class MpcProblem(typing.NamedTuple):
    """What `app.mpc.run_mpc` takes, and a constrained variant's limits and
    terminal weights: BASELINE config 4 (`mpc_hover_problem`) or the
    tumbling fleet (`tumble_mpc_problem`, which has neither)."""

    params: QuadrotorParams  # the controller's model
    plant: QuadrotorParams  # the plant: mass and inertia + mismatch
    q: torch.Tensor
    r: torch.Tensor
    desired: Trajectory  # unbatched, ticks + horizon + 8 stages
    x0: State  # (fleet, ...)
    options: ILQROptions
    limits: tuple | None  # (0.0, 2.9) N per rotor
    stage_weights: torch.Tensor | None  # (horizon,): [1, ..., 1, 20]


def mpc_hover_problem(
    rng: np.random.Generator, fleet, horizon=50, ticks=100, dt_s=0.01, dtype=torch.float32,
    device=None, mismatch=0.05,
) -> MpcProblem:
    """BASELINE config 4, warm-started 50-step solves at a 100 Hz control
    rate, as the JAX package's benchmark builds it
    (`benchmarks/mpc_device_loop.py:72-105`): hover regulation at the
    origin from start poses Exp(tau), tau translation 0.25 N(0, I_3) and no
    rotation, at rest; the controller's model 1 kg, unit inertia, 0.2 m
    arms, torque ratio 0.016; the plant's mass and inertia `mismatch` (5%)
    heavier; hover targets at the plant's hover thrust; the demo weights;
    3 iterations a tick, tolerance 1e-5, line search (0.5, 0.5, 8). The
    constrained variant adds rotor limits (0.0, 2.9) N (the hover thrust is
    ~2.58 N, so the upper bound binds while braking) and the terminal weight
    w_T = 20 (tests/test_mpc.py:118-140). The draws come from the numpy
    generator `rng`. On the CUDA card by default; without one it raises
    unless a device is given.

    Returns an MpcProblem."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpc_hover_problem builds on the CUDA card by default and "
                "torch.cuda.is_available() is false; pass device='cpu'"
            )
        device = "cuda"
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tau = np.zeros((fleet, 6))
    tau[:, 0:3] = 0.25 * rng.normal(size=(fleet, 3))

    def vehicle(scale):
        return QuadrotorParams.create(
            mass_kg=1.0 * scale,
            inertia=scale * torch.eye(3, dtype=dtype),
            arm_length_m=0.2,
            torque_to_thrust_ratio_m=0.016,
            g_mpss=9.81,
            device=device,
        )

    n_full = ticks + horizon + 8
    desired = Trajectory(
        times=torch.arange(n_full, dtype=dtype, device=device) * dt_s,
        states=State(
            pose=se3.identity((n_full,), dtype, device),
            vel=torch.zeros((n_full, 6), dtype=dtype, device=device),
        ),
        controls=torch.full((n_full, 4), (1.0 + mismatch) * 9.81 / 4.0, dtype=dtype, device=device),
    )
    q, r = demo_weights(dtype, device)
    return MpcProblem(
        params=vehicle(1.0),
        plant=vehicle(1.0 + mismatch),
        q=q,
        r=r,
        desired=desired,
        x0=State(pose=se3.exp(as_t(tau)), vel=torch.zeros((fleet, 6), dtype=dtype, device=device)),
        options=ILQROptions(LineSearchParams(0.5, 0.5, 8), ConvergenceCriteria(1e-5, 1e-5, 3)),
        limits=(0.0, 2.9),
        stage_weights=terminal_weights(horizon, dtype, device),
    )


def tumble_mpc_problem(
    generator: torch.Generator, fleet, ticks=6, horizon=16, dtype=torch.float32, device=None,
) -> MpcProblem:
    """The tumbling fleet the robust MPC recovers (tests/test_mpc.py:154-189
    of the JAX package): `aggressive_tumble`'s vehicle and weights (Q =
    diag(100 1_6, 1_6), R = 1e-3 I_4) with start pose and body twist drawn
    at scale 2.0 from `generator`, hover targets at the origin over 60
    stages of dt 0.1, 8 iterations a tick at tolerance 1e-8 with the
    default line search; the plant is the model, with no limits or
    weights. The exact loop's first window fails its line search on a
    share of the fleet; `app.mpc.run_mpc(solver="fddp")` recovers it.

    Returns an MpcProblem (limits and stage_weights None)."""
    params, q, r, x0, desired = aggressive_tumble(
        generator, fleet, n=max(60, ticks + horizon), dt_s=0.1, scale=2.0, dtype=dtype,
        device=device,
    )
    return MpcProblem(
        params=params,
        plant=params,
        q=q,
        r=r,
        desired=desired,
        x0=x0,
        options=ILQROptions(convergence_criteria=ConvergenceCriteria(1e-8, 1e-8, 8)),
        limits=None,
        stage_weights=None,
    )


class ConstrainedProblem(typing.NamedTuple):
    """What `solver.auglag.solve_auglag_batch` takes: the params, the cost,
    the initial trajectories ((batch, n, ...) leaves), the stage
    constraint, dt and the solve settings."""

    params: QuadrotorParams
    cost: QuadraticTrackingCost
    trajs: Trajectory
    constraints: typing.Callable
    dt_s: float
    options: ILQROptions
    al_options: typing.Any  # solver.auglag.ALOptions


def keepout_problem(batch, n=30, dtype=torch.float32, device=None, seed=0,
                    dt_s=0.1) -> ConstrainedProblem:
    """Constrained flight past a keep-out sphere (the JAX package's
    tests/test_auglag.py:41-75 and :296-310, README.md:252-265): from a
    hover at the origin toward a waypoint at [2, 0, 0] whose straight path
    crosses a sphere of radius 0.4 centred at [1, 0, 0]; a 1 kg vehicle with
    unit inertia, 0.25 m arms and torque ratio 0.02; Q = diag(60 1_6, 1_6),
    R = 0.5 I_4, hover-thrust control targets, dt 0.1; each scenario's start
    translation offset by 0.15 N(0, I_3), drawn with numpy from `seed`.
    Solved at tolerance 1e-6, 30 iterations, line search (0.5, 0.5, 20) and
    the default augmented-Lagrangian options."""
    from ..solver import constraints
    from ..solver.auglag import ALOptions

    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    params = QuadrotorParams.create(
        mass_kg=1.0, inertia=torch.eye(3, dtype=dtype), arm_length_m=0.25,
        torque_to_thrust_ratio_m=0.02, g_mpss=9.81, device=device,
    )
    desired = Trajectory(
        times=torch.arange(n, dtype=dtype, device=device) * dt_s,
        states=State(
            pose=se3.SE3(quat=as_t(np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))),
                         trans=as_t(np.tile([2.0, 0.0, 0.0], (n, 1)))),
            vel=torch.zeros((n, 6), dtype=dtype, device=device),
        ),
        controls=torch.full((n, 4), 9.81 / 4.0, dtype=dtype, device=device),
    )
    cost = QuadraticTrackingCost(
        Q=as_t(np.diag([60.0] * 6 + [1.0] * 6)), R=0.5 * torch.eye(4, dtype=dtype, device=device),
        desired_states=desired.states, desired_controls=desired.controls,
    )
    start = 0.15 * np.random.default_rng(seed).normal(size=(batch, 3))
    x0 = State(
        pose=se3.SE3(quat=as_t(np.tile([1.0, 0.0, 0.0, 0.0], (batch, 1))), trans=as_t(start)),
        vel=torch.zeros((batch, 6), dtype=dtype, device=device),
    )
    return ConstrainedProblem(
        params, cost, initial_trajectory_from_state(x0, desired),
        constraints.sphere_keepout([1.0, 0.0, 0.0], 0.4), dt_s,
        ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 30)),
        ALOptions(),
    )


def tumble_keepout_problem(batch, n=10, dtype=torch.float64, device=None, seed=3, dt_s=0.12,
                           scale=2.2) -> ConstrainedProblem:
    """Robust constrained flight (the JAX package's
    examples/08_robust_constrained.py:40-75, batched): `aggressive_tumble`'s
    starts at scale 2.2 (pose Exp(scale N(0, I_6)), body twist
    scale N(0, I_6), drawn from a torch generator seeded with `seed`), its
    vehicle and weights (Q = diag(100 1_6, 1_6), R = 1e-3 I_4) and hover
    targets at the origin, dt 0.12, beside a keep-out sphere of radius 0.15
    centred at [0.3, 0, 0]; tolerance 1e-9, 25 iterations, line search
    (0.5, 0.5, 20), 4 outer iterations. The exact inner loop's trip-0
    rollout diverges or stalls on this class; `robust=True` rescues it."""
    from ..solver import constraints
    from ..solver.auglag import ALOptions

    params, q, r, x0, desired = aggressive_tumble(
        torch.Generator().manual_seed(seed), batch, n=n, dt_s=dt_s, scale=scale, dtype=dtype,
        device=device,
    )
    cost = QuadraticTrackingCost(Q=q, R=r, desired_states=desired.states,
                                 desired_controls=desired.controls)
    return ConstrainedProblem(
        params, cost, initial_trajectory_from_state(x0, desired),
        constraints.sphere_keepout([0.3, 0.0, 0.0], 0.15), dt_s,
        ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-9, 1e-9, 25)),
        ALOptions(max_outer_iters=4),
    )


# The wider-control families' solve settings (benchmarks/wrench_bench.py:46-90):
# tolerance 1e-6, 10 iterations, line search (0.5, 0.5, 20).
FAMILY_OPTIONS = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10))


def _family_waypoint_problem(generator, params, hover, batch, n, dt_s, dtype, device):
    """Hover at the origin from start poses Exp(0.3 N(0, I_6)) at rest, with
    Q = diag(100 1_6, 1_6), R = I_u and the hover control `hover` (u,) at
    every stage. Returns (params, cost, initial trajectories)."""
    draw = lambda shape: torch.randn(
        shape, generator=generator, dtype=dtype, device=generator.device
    ).to(device)
    x0 = State(pose=se3.exp(0.3 * draw((batch, 6))),
               vel=torch.zeros((batch, 6), dtype=dtype, device=device))
    u = len(hover)
    desired = Trajectory(
        times=torch.arange(n, dtype=dtype, device=device) * dt_s,
        states=State(
            pose=se3.identity((n,), dtype, device),
            vel=torch.zeros((n, 6), dtype=dtype, device=device),
        ),
        controls=torch.as_tensor(np.tile(hover, (n, 1)), dtype=dtype, device=device),
    )
    cost = QuadraticTrackingCost(
        Q=torch.diag(torch.tensor([100.0] * 6 + [1.0] * 6, dtype=dtype)).to(device),
        R=torch.eye(u, dtype=dtype, device=device),
        desired_states=desired.states,
        desired_controls=desired.controls,
    )
    return params, cost, initial_trajectory_from_state(x0, desired)


def wrench_problem(
    generator: torch.Generator, batch=4096, n=100, dt_s=0.02, dtype=torch.float32, device=None
):
    """The SE(3) body-wrench throughput problem as
    `benchmarks/wrench_bench.py:51-86` builds it: a 1.3 kg body with inertia
    diag(0.4, 0.5, 0.6) + 0.03, g 9.81; hover wrench [0, 0, 1.3 g, 0, 0, 0];
    start poses Exp(0.3 N(0, I_6)) at rest; Q = diag(100 1_6, 1_6), R = I_6;
    solved with FAMILY_OPTIONS. The draws come from `generator` (not
    jax.random's numbers).

    Returns (params, cost, initial trajectories with (batch, n, ...) leaves)."""
    params = WrenchParams.create(
        1.3, torch.diag(torch.tensor([0.4, 0.5, 0.6], dtype=dtype)) + 0.03, 9.81, device=device
    )
    hover = np.array([0.0, 0.0, 1.3 * 9.81, 0.0, 0.0, 0.0])
    return _family_waypoint_problem(generator, params, hover, batch, n, dt_s, dtype, device)


def hexarotor_problem(
    generator: torch.Generator, batch=4096, n=100, dt_s=0.02, dtype=torch.float32, device=None,
    n_rotors=6,
):
    """The wrench problem's waypoint task on the hexarotor of
    `__graft_entry__.py:268-282`: `MultirotorParams.regular(6, mass 1.5,
    inertia diag(0.4, 0.5, 0.6) + 0.03, arm 0.3, kappa 0.02, g 9.81)`, hover
    1.5 g / 6 per rotor, R = I_6; `n_rotors` puts another count of rotors
    on the same ring (hover 1.5 g / R each, R = I_R).

    Returns (params, cost, initial trajectories with (batch, n, ...) leaves)."""
    params = MultirotorParams.regular(
        n_rotors, 1.5, torch.diag(torch.tensor([0.4, 0.5, 0.6], dtype=dtype)) + 0.03, 0.3, 0.02,
        9.81, device=device,
    )
    hover = np.full(n_rotors, 1.5 * 9.81 / n_rotors)
    return _family_waypoint_problem(generator, params, hover, batch, n, dt_s, dtype, device)


# The bench workload's solve settings (bench.py:114-123): tolerance 1e-6, 10
# iterations, line search (0.5, 0.5, 20); the substep counts its
# substepped-integration runs take (BENCH_LOCAL.md:65 ran k = 2).
BENCH_OPTIONS = FAMILY_OPTIONS
SUBSTEP_COUNTS = (2, 4)
# the drag coefficients of __graft_entry__.py:317-325 and
# tests/test_quadrotor_drag.py:36
DRAG_LIN = (0.3, 0.35, 0.5)
DRAG_ANG = (0.02, 0.02, 0.04)


def bench_problem(
    generator: torch.Generator, batch=4096, n=100, dt_s=0.02, dtype=torch.float32, device=None
):
    """The bench workload (`bench.py:94-111`): `hover_to_waypoint` at pose
    scale 0.3 with the demo weights, on the bench's rigid body (1 kg, unit
    inertia, arms 0.2 m, kappa 0.016, g 9.81); solved with BENCH_OPTIONS.
    With `model=substepped(quadrotor, k)` it is the substepped-integration
    workload.

    Returns (params, cost, initial trajectories with (batch, n, ...) leaves)."""
    x0, desired = hover_to_waypoint(generator, batch, n=n, dt_s=dt_s, dtype=dtype, pose_scale=0.3,
                                    device=device)
    q_w, r_w = demo_weights(dtype, device)
    cost = QuadraticTrackingCost(Q=q_w, R=r_w, desired_states=desired.states,
                                 desired_controls=desired.controls)
    params = QuadrotorParams.create(1.0, torch.eye(3, dtype=dtype), 0.2, 0.016, 9.81,
                                    device=device)
    return params, cost, initial_trajectory_from_state(x0, desired)


def drag_problem(
    generator: torch.Generator, batch=4096, n=100, dt_s=0.02, dtype=torch.float32, device=None,
    per_scenario=False,
):
    """The bench workload (`bench_problem`) on the drag quadrotor: the bench's
    rigid body with drag_lin DRAG_LIN and drag_ang DRAG_ANG. With
    `per_scenario` every leaf carries the batch, and each lane's
    coefficients are the shared ones scaled by factors drawn uniformly from
    [0.5, 1.5] (`generator`, after the problem's own draws).

    Returns (DragQuadrotorParams, cost, initial trajectories)."""
    quad, cost, trajs = bench_problem(generator, batch, n, dt_s, dtype, device)
    drag_lin = torch.tensor(DRAG_LIN, dtype=dtype, device=device)
    drag_ang = torch.tensor(DRAG_ANG, dtype=dtype, device=device)
    leaves = dict(mass_kg=quad.mass_kg, inertia=quad.inertia, arm_length_m=quad.arm_length_m,
                  torque_to_thrust_ratio_m=quad.torque_to_thrust_ratio_m, g_mpss=quad.g_mpss)
    if per_scenario:
        draw = lambda: torch.rand((batch, 3), generator=generator, dtype=dtype,  # noqa: E731
                                  device=generator.device).to(device)
        drag_lin = drag_lin * (0.5 + draw())
        drag_ang = drag_ang * (0.5 + draw())
        leaves = {k: v.expand((batch,) + v.shape).contiguous() for k, v in leaves.items()}
    return DragQuadrotorParams(**leaves, drag_lin=drag_lin, drag_ang=drag_ang), cost, trajs
