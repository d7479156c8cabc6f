"""The port's kernel modules against the JAX kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in interpret mode, as the JAX package's own kernel tests run them. Inputs are
made with numpy from a seed and handed to both sides (the port's through
`quadrotorilqr_tpu_torch.convert`). Tolerances follow the JAX kernel tests:
backward 1e-9 (tests/test_kernel_backward.py), rollout 1e-10, whole solve
status/iterations equal, cost rtol 1e-8, controls and translations 1e-7
(tests/test_solve_fused.py). The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.costs.quadratic import QuadraticTrackingCost as JCost
from quadrotorilqr_tpu.kernels.backward import backward_pass_fused as j_backward
from quadrotorilqr_tpu.kernels.rollout import rollout_cost_fused as j_rollout
from quadrotorilqr_tpu.kernels.solve import solve_fused_whole as j_solve
from quadrotorilqr_tpu.lie.se3 import SE3 as JSE3
from quadrotorilqr_tpu.models.quadrotor import QuadrotorParams as JParams
from quadrotorilqr_tpu.models.quadrotor import State as JState
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.kernels import backward as P_backward
from quadrotorilqr_tpu_torch.kernels import rollout as P_rollout
from quadrotorilqr_tpu_torch.kernels import solve as P_solve
from quadrotorilqr_tpu_torch.solver import options as P_options

DT = 0.02

# The plain loops dispatch thousands of tiny ops, on which torch's intra-op
# threads only spin (four times the CPU time, and a longer wall time, than
# one thread): one thread runs them faster and leaves the other cores to the
# other test workers.
torch.set_num_threads(1)


def np_problem(seed, batch, n, random_states, per_scenario_params=False):
    """Hover-to-waypoint problem as numpy arrays: randomized poses and
    velocities (every stage when `random_states`, else stage 0 with the
    desired hover after it), perturbed controls, shared hover target."""
    rng = np.random.default_rng(seed)
    stages = n if random_states else 1

    def unit_quats(shape):
        q = np.concatenate([np.ones(shape + (1,)), 0.3 * rng.normal(size=shape + (3,))], -1)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    quat = np.zeros((batch, n, 4))
    quat[..., 0] = 1.0
    trans = np.zeros((batch, n, 3))
    vel = np.zeros((batch, n, 6))
    quat[:, :stages] = unit_quats((batch, stages))
    trans[:, :stages] = 0.4 * rng.normal(size=(batch, stages, 3))
    vel[:, :stages] = 0.2 * rng.normal(size=(batch, stages, 6))
    hover = np.full((n, 4), 9.81 / 4.0)
    controls = hover + 0.5 * rng.normal(size=(batch, n, 4))
    des_quat = np.zeros((n, 4))
    des_quat[:, 0] = 1.0
    params = dict(
        mass_kg=np.asarray(1.3),
        inertia=np.diag([0.4, 0.5, 0.6]) + 0.05,
        arm_length_m=np.asarray(0.2),
        torque_to_thrust_ratio_m=np.asarray(0.016),
        g_mpss=np.asarray(9.81),
    )
    if per_scenario_params:
        scale = 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
        params = dict(
            mass_kg=1.3 * scale,
            inertia=(np.diag([0.4, 0.5, 0.6]) + 0.05) * scale[:, None, None],
            arm_length_m=np.full(batch, 0.2),
            torque_to_thrust_ratio_m=np.full(batch, 0.016),
            g_mpss=np.full(batch, 9.81),
        )
    return dict(
        quat=quat, trans=trans, vel=vel, controls=controls,
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        des_quat=des_quat, des_trans=np.zeros((n, 3)), des_vel=np.zeros((n, 6)),
        des_controls=hover,
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])), R=np.eye(4),
        params=params,
    )


def jax_objects(d):
    """(params, cost, traj) of the JAX package from np_problem's arrays."""
    j = jnp.asarray
    params = JParams(**{k: j(v) for k, v in d["params"].items()})
    cost = JCost(
        Q=j(d["Q"]), R=j(d["R"]),
        desired_states=JState(
            pose=JSE3(quat=j(d["des_quat"]), trans=j(d["des_trans"])), vel=j(d["des_vel"])
        ),
        desired_controls=j(d["des_controls"]),
    )
    traj = JTraj(
        times=j(d["times"]),
        states=JState(pose=JSE3(quat=j(d["quat"]), trans=j(d["trans"])), vel=j(d["vel"])),
        controls=j(d["controls"]),
    )
    return params, cost, traj


def port_objects(jobjs, device=None):
    """The same problem as the port's objects, carried over by convert.py."""
    params, cost, traj = jax.tree.map(np.asarray, jobjs)
    return (
        convert.params_from_numpy(params, device=device),
        convert.cost_from_numpy(cost, device=device),
        convert.trajectory_from_numpy(traj, device=device),
    )


def options_pair(max_iters=6):
    """The same options for the JAX package and the port."""
    ls, cc = (0.5, 0.5, 20), (1e-8, 1e-8, max_iters)
    return (
        ILQROptions(LineSearchParams(*ls), ConvergenceCriteria(*cc)),
        P_options.ILQROptions(P_options.LineSearchParams(*ls), P_options.ConvergenceCriteria(*cc)),
    )


def assert_same_solution(port, ref, rtol_cost=1e-8, atol_traj=1e-7):
    """Port (traj, cost, iters, status) vs JAX (traj, cost, iters, status)."""
    p_traj, p_cost, p_it, p_st = convert.to_numpy(port)
    r_traj, r_cost, r_it, r_st = (jax.tree.map(np.asarray, a) for a in ref)
    np.testing.assert_array_equal(p_st, r_st)
    np.testing.assert_array_equal(p_it, r_it)
    np.testing.assert_allclose(p_cost, r_cost, rtol=rtol_cost)
    np.testing.assert_allclose(p_traj.controls, r_traj.controls, atol=atol_traj)
    np.testing.assert_allclose(p_traj.states.pose.trans, r_traj.states.pose.trans, atol=atol_traj)


@pytest.fixture(scope="module")
def random_problem():
    jobjs = jax_objects(np_problem(0, 128, 6, random_states=True))
    return jobjs, port_objects(jobjs)


@pytest.fixture(scope="module")
def jax_backward(random_problem):
    (params, cost, traj), _ = random_problem
    return j_backward(params, cost, traj, DT, interpret=True)


def test_backward_plain_matches_jax_kernel(random_problem, jax_backward):
    _, (params, cost, traj) = random_problem
    got = P_backward.backward_pass_fused(params, cost, traj, DT)
    ks, big_ks, qutk, ktquuk = (np.asarray(a) for a in jax_backward)
    np.testing.assert_allclose(got[0].numpy(), ks, atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), big_ks, atol=1e-9)
    np.testing.assert_allclose(got[2].numpy(), qutk, rtol=1e-9)
    np.testing.assert_allclose(got[3].numpy(), ktquuk, rtol=1e-9)


def test_rollout_plain_matches_jax_kernel(random_problem, jax_backward):
    (j_params, j_cost, j_traj), (params, cost, traj) = random_problem
    ks, big_ks = jax_backward[0], jax_backward[1]
    alpha = np.random.default_rng(1).uniform(0.1, 1.0, size=128)
    ref_traj, ref_cost = j_rollout(
        j_params, j_cost, j_traj, ks, big_ks, jnp.asarray(alpha), DT, interpret=True
    )
    got_traj, got_cost = P_rollout.rollout_cost_fused(
        params, cost, traj, torch.tensor(np.asarray(ks)),
        torch.tensor(np.asarray(big_ks)), torch.as_tensor(alpha), DT,
    )
    got_traj = convert.to_numpy(got_traj)
    ref_traj = jax.tree.map(np.asarray, ref_traj)
    for got, ref in (
        (got_traj.states.pose.quat, ref_traj.states.pose.quat),
        (got_traj.states.pose.trans, ref_traj.states.pose.trans),
        (got_traj.states.vel, ref_traj.states.vel),
        (got_traj.controls, ref_traj.controls),
    ):
        np.testing.assert_allclose(got, ref, atol=1e-10)
    np.testing.assert_allclose(got_cost.numpy(), np.asarray(ref_cost), rtol=1e-10)


def test_whole_solve_plain_matches_jax_kernel():
    """With the cost history and the probe counts: the history per slot at
    the cost's rtol; the JAX kernel counts the probe sweeps of its 128-lane
    tile (a sweep runs while any lane of the tile still searches), the port
    each lane's, so the tile's count is the sum over trips of the most
    probes a lane ran on that trip: at least the largest per-lane total and
    at most the sum of them, and equal to the largest total when one lane
    is the slowest searcher on every trip it runs (the count of sweeps is
    printed beside it)."""
    jobjs = jax_objects(np_problem(2, 128, 6, random_states=False))
    params, cost, traj = port_objects(jobjs)
    j_opts, p_opts = options_pair()
    ref = j_solve(*jobjs, DT, j_opts, interpret=True, return_history=True, return_probes=True)
    got = P_solve.solve_fused_whole(params, cost, traj, DT, p_opts, return_history=True,
                                    return_probes=True)
    assert_same_solution(got[:4], ref[:4])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-8)
    np.testing.assert_array_equal(got[4].numpy() == 0, np.asarray(ref[4]) == 0)
    passes, probes = got[5].numpy(), got[6].numpy()
    tile = float(np.asarray(ref[5])[0])
    print(f"JAX tile probe sweeps {tile}, port per-lane max {probes.max()}, sum {probes.sum()}")
    assert probes.max() <= tile <= probes.sum()
    # a lane runs one backward pass a trip and at least one probe an update
    iters, status = got[2].numpy(), got[3].numpy()
    assert (passes >= iters).all() and (passes <= iters + 1).all() and (probes >= iters).all()
    assert int(np.asarray(ref[5]).min()) == int(np.asarray(ref[5]).max())


def test_whole_solve_refuses_zero_probe_line_search():
    _, p_opts = options_pair()
    zero = P_options.ILQROptions(
        P_options.LineSearchParams(0.5, 0.5, 0), p_opts.convergence_criteria
    )
    params, cost, traj = port_objects(jax_objects(np_problem(3, 2, 3, True)))
    with pytest.raises(ValueError, match="max_iters must be >= 1"):
        P_solve.solve_fused_whole(params, cost, traj, DT, zero)


@pytest.mark.parametrize(
    "kwargs",
    [dict(continuation=True), dict(limits=(0.0, 5.0)), dict(return_history=True),
     dict(return_probes=True)],
    ids=["continuation", "limits", "history", "probes"],
)
def test_whole_solve_refuses_options_outside_the_slice(kwargs):
    """continuation and limits are refused, naming their ROADMAP items;
    the history and the probe counts are ported and come back after the
    solution, (B, max_iters) and two (B,) int32 counts."""
    _, p_opts = options_pair()
    params, cost, traj = port_objects(jax_objects(np_problem(3, 2, 3, True)))
    if "return_history" in kwargs or "return_probes" in kwargs:
        got = P_solve.solve_fused_whole(params, cost, traj, DT, p_opts, **kwargs)
        extra = [tuple(a.shape) for a in got[4:]]
        assert extra == ([(2, 6)] if "return_history" in kwargs else [(2,), (2,)])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P_solve.solve_fused_whole(params, cost, traj, DT, p_opts, **kwargs)
