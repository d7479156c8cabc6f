"""The port's Lie groups, dynamics and cost against the JAX package, f64.

Inputs come from numpy and include rotations inside the small-angle Taylor
branch (|theta| < 1e-3) and rotations near pi (both sides, so Log meets
w < 0). Tolerance 1e-12 everywhere: the two sides evaluate the same
formulas in the same order up to the reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.costs import quadratic as j_qc
from quadrotorilqr_tpu.lie import se3 as j_se3
from quadrotorilqr_tpu.lie import so3 as j_so3
from quadrotorilqr_tpu.models import quadrotor as j_qm
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.costs import quadratic as p_qc
from quadrotorilqr_tpu_torch.lie import se3 as p_se3
from quadrotorilqr_tpu_torch.lie import so3 as p_so3
from quadrotorilqr_tpu_torch.models import quadrotor as p_qm
from quadrotorilqr_tpu_torch.solver.ilqr import Trajectory

from test_torch_kernels import jax_objects, np_problem, port_objects

TOL = 1e-12


def rotation_vectors(seed, regime, count=16):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(count, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    if regime == "generic":
        angle = rng.uniform(0.0, 3.0, size=count)
    elif regime == "small":
        angle = rng.uniform(1e-6, 9e-4, size=count)
    else:  # near pi, on both sides
        angle = np.pi + rng.uniform(-1e-3, 1e-3, size=count)
    return axis * angle[:, None]


def tangents(seed, regime, count=16):
    rng = np.random.default_rng(seed + 100)
    rho = rng.normal(size=(count, 3))
    return np.concatenate([rho, rotation_vectors(seed, regime, count)], -1)


def quaternions(seed, regime, count=16):
    """Unit quaternions of the regime's rotations, half of them negated so
    Log meets the w < 0 hemisphere."""
    theta = rotation_vectors(seed, regime, count)
    angle = np.linalg.norm(theta, axis=-1, keepdims=True)
    q = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * theta / angle], -1)
    q[::2] *= -1.0
    return q


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=tol)


REGIMES = ["generic", "small", "near_pi"]


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize(
    "name", ["exp", "left_jacobian", "right_jacobian", "left_jacobian_inv", "right_jacobian_inv"]
)
def test_so3_tangent_functions(regime, name):
    theta = rotation_vectors(1, regime)
    if regime == "near_pi" and name.endswith("_inv"):
        theta = 0.9 * theta  # Jl^-1 is singular at 2 pi; stay inside its domain
    close(getattr(p_so3, name)(torch.tensor(theta)), getattr(j_so3, name)(jnp.asarray(theta)))


@pytest.mark.parametrize("regime", REGIMES)
def test_so3_log_and_quaternion_algebra(regime):
    q = quaternions(2, regime)
    v = np.random.default_rng(3).normal(size=(16, 3))
    close(p_so3.log(torch.tensor(q)), j_so3.log(jnp.asarray(q)))
    close(p_so3.quat_to_matrix(torch.tensor(q)), j_so3.quat_to_matrix(jnp.asarray(q)))
    close(p_so3.quat_rotate(torch.tensor(q), torch.tensor(v)), j_so3.quat_rotate(jnp.asarray(q), jnp.asarray(v)))
    close(
        p_so3.quat_multiply(torch.tensor(q), torch.tensor(q[::-1].copy())),
        j_so3.quat_multiply(jnp.asarray(q), jnp.asarray(q[::-1].copy())),
    )


@pytest.mark.parametrize("regime", REGIMES)
def test_se3_exp_log_adjoint(regime):
    tau = tangents(4, regime)
    p_x, j_x = p_se3.exp(torch.tensor(tau)), j_se3.exp(jnp.asarray(tau))
    close(p_x.quat, j_x.quat)
    close(p_x.trans, j_x.trans)
    q = quaternions(5, regime)
    t = np.random.default_rng(6).normal(size=(16, 3))
    p_g, j_g = p_se3.SE3(torch.tensor(q), torch.tensor(t)), j_se3.SE3(jnp.asarray(q), jnp.asarray(t))
    close(p_se3.log(p_g), j_se3.log(j_g), tol=1e-11)
    close(p_se3.adjoint(p_g), j_se3.adjoint(j_g))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize(
    "name", ["left_jacobian", "right_jacobian", "left_jacobian_inv", "right_jacobian_inv"]
)
def test_se3_jacobians(regime, name):
    tau = tangents(7, regime)
    if regime == "near_pi" and name.endswith("_inv"):
        tau = 0.9 * tau
    close(getattr(p_se3, name)(torch.tensor(tau)), getattr(j_se3, name)(jnp.asarray(tau)), tol=1e-11)


@pytest.mark.parametrize("regime", REGIMES)
def test_se3_plus_and_minus_with_jacobians(regime):
    rng = np.random.default_rng(8)
    q = quaternions(9, regime)
    t = rng.normal(size=(16, 3))
    tau = 0.5 * tangents(10, regime)
    p_x, j_x = p_se3.SE3(torch.tensor(q), torch.tensor(t)), j_se3.SE3(jnp.asarray(q), jnp.asarray(t))
    p_out = p_se3.plus_jacobians(p_x, torch.tensor(tau))
    j_out = j_se3.plus_jacobians(j_x, jnp.asarray(tau))
    close(p_out[0].quat, j_out[0].quat)
    close(p_out[0].trans, j_out[0].trans)
    close(p_out[1], j_out[1])
    close(p_out[2], j_out[2], tol=1e-11)
    q2 = quaternions(11, "generic")
    t2 = rng.normal(size=(16, 3))
    p_y, j_y = p_se3.SE3(torch.tensor(q2), torch.tensor(t2)), j_se3.SE3(jnp.asarray(q2), jnp.asarray(t2))
    for p_a, j_a in zip(p_se3.minus_jacobians(p_x, p_y), j_se3.minus_jacobians(j_x, j_y)):
        close(p_a, j_a, tol=1e-10)


@pytest.fixture(scope="module")
def stage_problem():
    """A (4, 5) stage stack with random states and controls."""
    jobjs = jax_objects(np_problem(12, 4, 5, random_states=True))
    return jobjs, port_objects(jobjs)


def test_dynamics_with_jacobians(stage_problem):
    (j_params, _, j_traj), (p_params, _, p_traj) = stage_problem
    p_out = p_qm.discrete_dynamics_jacobians(p_params, p_traj.states, p_traj.controls, 0.02)
    j_out = jax.jit(j_qm.discrete_dynamics_jacobians, static_argnums=3)(
        j_params, j_traj.states, j_traj.controls, 0.02
    )
    close(p_out[0].pose.quat, j_out[0].pose.quat)
    close(p_out[0].pose.trans, j_out[0].pose.trans)
    close(p_out[0].vel, j_out[0].vel)
    close(p_out[1], j_out[1])
    close(p_out[2], j_out[2])
    close(
        p_qm.continuous_dynamics(p_params, p_traj.states, p_traj.controls),
        jax.jit(j_qm.continuous_dynamics)(j_params, j_traj.states, j_traj.controls),
    )


def test_state_minus_with_jacobians(stage_problem):
    (_, j_cost, j_traj), (_, p_cost, p_traj) = stage_problem
    p_out = p_qm.minus_jacobians(p_traj.states, p_cost.desired_states)
    j_out = jax.jit(j_qm.minus_jacobians)(j_traj.states, j_cost.desired_states)
    for p_a, j_a in zip(p_out, j_out):
        close(p_a, j_a)
    p_added = p_qm.add(p_traj.states, p_out[0])
    j_added = j_qm.add(j_traj.states, j_out[0])
    close(p_added.pose.quat, j_added.pose.quat)
    close(p_added.vel, j_added.vel)


def test_cost_diffs_and_trajectory_cost(stage_problem):
    (_, j_cost, j_traj), (_, p_cost, p_traj) = stage_problem
    p_out = p_qc.stage_cost_with_diffs(
        p_cost, p_traj.states, p_traj.controls, p_cost.desired_states, p_cost.desired_controls
    )
    j_out = jax.jit(
        lambda c, t: j_qc.stage_cost_with_diffs(
            c, t.states, t.controls, c.desired_states, c.desired_controls
        )
    )(j_cost, j_traj)
    for p_a, j_a in zip(p_out, j_out):
        np.testing.assert_allclose(
            p_a.numpy(), np.broadcast_to(np.asarray(j_a), p_a.shape), rtol=1e-12, atol=1e-12
        )
    np.testing.assert_allclose(
        p_qc.trajectory_cost(p_cost, p_traj.states, p_traj.controls).numpy(),
        np.asarray(
            jax.jit(jax.vmap(lambda t: j_qc.trajectory_cost(j_cost, t.states, t.controls)))(j_traj)
        ),
        rtol=1e-12,
    )


def test_convert_round_trip(stage_problem):
    (j_params, j_cost, j_traj), (p_params, p_cost, p_traj) = stage_problem
    back = convert.to_numpy(p_traj)
    np.testing.assert_array_equal(back.states.pose.quat, np.asarray(j_traj.states.pose.quat))
    np.testing.assert_array_equal(back.controls, np.asarray(j_traj.controls))
    np.testing.assert_array_equal(convert.to_numpy(p_cost).Q, np.asarray(j_cost.Q))
    np.testing.assert_array_equal(convert.to_numpy(p_params).inertia, np.asarray(j_params.inertia))


@pytest.mark.parametrize("per_scenario", [False, True], ids=["shared", "per_scenario"])
def test_cost_batched_flags(stage_problem, per_scenario):
    (_, j_cost, _), (_, p_cost, _) = stage_problem
    if per_scenario:
        j_cost = j_qc.QuadraticTrackingCost(
            Q=jnp.broadcast_to(j_cost.Q, (4, 12, 12)), R=j_cost.R,
            desired_states=j_cost.desired_states, desired_controls=j_cost.desired_controls,
        )
        p_cost = p_qc.QuadraticTrackingCost(
            Q=p_cost.Q.expand(4, 12, 12), R=p_cost.R,
            desired_states=p_cost.desired_states, desired_controls=p_cost.desired_controls,
        )
    p_flags = p_qc.cost_batched_flags(p_cost)
    j_flags = j_qc.cost_batched_flags(j_cost)
    assert (p_flags.Q, p_flags.R, p_flags.desired_controls) == (
        j_flags.Q, j_flags.R, j_flags.desired_controls
    )
    assert p_flags.desired_states.pose.quat == j_flags.desired_states.pose.quat


def test_demo_workload_matches_jax():
    from quadrotorilqr_tpu.app import workloads as j_wl
    from quadrotorilqr_tpu_torch.app import workloads as p_wl

    p_params, j_params = p_wl.demo_params(), j_wl.demo_params()
    for name in ("mass_kg", "inertia", "arm_length_m", "torque_to_thrust_ratio_m", "g_mpss"):
        close(getattr(p_params, name), getattr(j_params, name), tol=0)
    for p_w, j_w in zip(p_wl.demo_weights(), j_wl.demo_weights()):
        close(p_w, j_w, tol=0)
    # BASELINE config 1's desired trajectory and config 3's figure eight
    rpy = np.random.default_rng(4).uniform(-3, 3, size=(3, 5))
    np.testing.assert_array_equal(p_wl.euler_xyz_to_quat(*rpy), j_wl.euler_xyz_to_quat(*rpy))
    for p_t, j_t in (
        (p_wl.demo_desired_trajectory(), j_wl.demo_desired_trajectory()),
        (p_wl.figure_eight(dtype=torch.float64), j_wl.figure_eight(dtype=jnp.float64)),
        (p_wl.figure_eight(16, 0.05, 1.5, torch.float32), j_wl.figure_eight(16, 0.05, 1.5)),
    ):
        assert p_t.controls.dtype == torch.float32 or p_t.horizon != 16
        for p_a, j_a in ((p_t.times, j_t.times), (p_t.states.pose.quat, j_t.states.pose.quat),
                         (p_t.states.pose.trans, j_t.states.pose.trans),
                         (p_t.states.vel, j_t.states.vel), (p_t.controls, j_t.controls)):
            assert p_a.shape == j_a.shape
            close(p_a, j_a, tol=0)
    assert p_wl.demo_desired_trajectory().horizon == 40
    # config 3's problem: the figure eight, per-scenario Q in [0.5, 2] x
    # the demo Q, per-scenario R, initial poses at stage 0 only
    params, cost, trajs = p_wl.figure_eight_problem(np.random.default_rng(3), 5, n=9)
    q, r = p_wl.demo_weights(torch.float32)
    scale = cost.Q[:, 0, 0] / q[0, 0]
    assert cost.Q.shape == (5, 12, 12) and cost.R.shape == (5, 4, 4)
    assert bool(((scale >= 0.5) & (scale <= 2.0)).all())
    torch.testing.assert_close(cost.Q, scale[:, None, None] * q, rtol=1e-6, atol=0)
    assert trajs.controls.shape == (5, 9, 4) and params.arm_length_m.item() == np.float32(0.2)
    torch.testing.assert_close(trajs.states.pose.trans[:, 1:],
                               cost.desired_states.pose.trans[1:].expand(5, 8, 3))


def test_hover_workload_and_initial_trajectory_match_jax():
    from quadrotorilqr_tpu.app import workloads as j_wl
    from quadrotorilqr_tpu.parallel.batch import initial_trajectory_from_state as j_init
    from quadrotorilqr_tpu_torch.app import workloads as p_wl
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state as p_init

    def fields(t):
        s = t.states
        return (t.times, s.pose.quat, s.pose.trans, s.vel, t.controls)

    j_x0, j_des = j_wl.hover_to_waypoint(
        jax.random.PRNGKey(0), 3, n=5, dtype=jnp.float64, pose_scale=0.3
    )
    gen = torch.Generator().manual_seed(0)
    p_x0, p_des = p_wl.hover_to_waypoint(gen, 3, n=5, dtype=torch.float64, pose_scale=0.3)
    # the desired hover is deterministic; the random draws differ by design
    for p_a, j_a in zip(fields(p_des), fields(j_des)):
        close(p_a, j_a, tol=0)
    assert p_x0.pose.quat.shape == (3, 4) and p_x0.vel.shape == (3, 6)
    torch.testing.assert_close(
        p_x0.pose.quat.norm(dim=-1), torch.ones(3, dtype=torch.float64), rtol=0, atol=1e-12
    )
    # the same initial states on both sides give the same initial trajectories
    x0 = convert.state_from_numpy(jax.tree.map(np.asarray, j_x0))
    for p_a, j_a in zip(fields(p_init(x0, p_des)), fields(j_init(j_x0, j_des))):
        close(p_a, j_a, tol=0)


def test_long_horizon_workload_matches_jax():
    """long_horizon_problem's deterministic parts: params, weights, the
    desired hover, and the initial trajectories built from given states."""
    from quadrotorilqr_tpu.app import workloads as j_wl
    from quadrotorilqr_tpu_torch.app import workloads as p_wl
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state as p_init

    j_params, j_cost, j_trajs = j_wl.long_horizon_problem(3, 6, dtype=jnp.float64, dt_s=0.05)
    gen = torch.Generator().manual_seed(0)
    p_params, p_cost, p_trajs = p_wl.long_horizon_problem(gen, 3, 6, torch.float64, dt_s=0.05)
    for name in ("mass_kg", "inertia", "arm_length_m", "torque_to_thrust_ratio_m", "g_mpss"):
        close(getattr(p_params, name), getattr(j_params, name), tol=0)
    for p_a, j_a in (
        (p_cost.Q, j_cost.Q), (p_cost.R, j_cost.R), (p_cost.desired_controls, j_cost.desired_controls),
        (p_cost.desired_states.pose.quat, j_cost.desired_states.pose.quat),
        (p_cost.desired_states.pose.trans, j_cost.desired_states.pose.trans),
        (p_cost.desired_states.vel, j_cost.desired_states.vel),
    ):
        close(p_a, j_a, tol=0)
    assert p_trajs.controls.shape == (3, 6, 4) and p_trajs.states.vel.shape == (3, 6, 6)
    # the draws differ by design; from JAX's initial states the port builds
    # JAX's initial trajectories
    j_x0 = jax.tree.map(lambda a: np.asarray(a)[:, 0], j_trajs.states)
    desired = Trajectory(
        times=p_trajs.times[0], states=p_cost.desired_states, controls=p_cost.desired_controls
    )
    got = p_init(convert.state_from_numpy(j_x0), desired)
    for p_a, j_a in (
        (got.times, j_trajs.times), (got.controls, j_trajs.controls),
        (got.states.pose.quat, j_trajs.states.pose.quat),
        (got.states.pose.trans, j_trajs.states.pose.trans), (got.states.vel, j_trajs.states.vel),
    ):
        close(p_a, j_a, tol=0)
