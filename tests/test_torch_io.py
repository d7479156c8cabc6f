"""The port's reference-parity surface against the JAX package and the C++
oracle, f64 on the CPU.

Proto I/O: the port's messages serialize (deterministic=True) to the JAX
package's bytes for the same numpy inputs (trajectory, options, debug
record), and are the JAX package's message types. BASELINE config 1 (the
reference demo, N=40, rtol = atol = 1e-12, 100 iterations) end to end:
`QuadrotorILQR(device="cpu").solve(proto)` against one JAX `solve_pytree`
with `populate_debug=True` (statuses and iterations equal, cost rtol 1e-8,
controls atol 1e-7, debug costs per slot rtol 1e-8) and against the C++
oracle (controls within 1e-5, the BASELINE bar, and the same iteration
count). The trajectory helpers, `line_search`, the demo driver's helpers,
and the FDDP solvers' refusal of the debug record.
"""

import concurrent.futures
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu import io as jio
from quadrotorilqr_tpu.api import QuadrotorILQR as JQuadrotorILQR
from quadrotorilqr_tpu.app import workloads as j_wl
from quadrotorilqr_tpu.lie.se3 import SE3 as JSE3
from quadrotorilqr_tpu.models.quadrotor import State as JState
from quadrotorilqr_tpu.oracle import native
from quadrotorilqr_tpu.solver import ilqr as j_ilqr
from quadrotorilqr_tpu.solver import options as j_options
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch import io as pio
from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.app import driver
from quadrotorilqr_tpu_torch.app import workloads as p_wl
from quadrotorilqr_tpu_torch.solver import ilqr as p_ilqr
from quadrotorilqr_tpu_torch.solver import options as p_options
from quadrotorilqr_tpu_torch.tree import tree_map

from test_torch_kernels import jax_objects, np_problem, port_objects

DEMO_DT = 0.1


def np_trajectory(seed, n):
    d = np_problem(seed, 1, n, random_states=True)
    return dict(times=d["times"][0], quat=d["quat"][0], trans=d["trans"][0], vel=d["vel"][0],
                controls=d["controls"][0])


def both_trajectories(a):
    """The same numpy trajectory as JAX's and the port's Trajectory."""
    j = j_ilqr.Trajectory(
        times=jnp.asarray(a["times"]),
        states=JState(pose=JSE3(quat=jnp.asarray(a["quat"]), trans=jnp.asarray(a["trans"])),
                      vel=jnp.asarray(a["vel"])),
        controls=jnp.asarray(a["controls"]),
    )
    return j, convert.trajectory_from_numpy(jax.tree.map(np.asarray, j))


def wire(msg):
    return msg.SerializeToString(deterministic=True)


def test_trajectory_proto_matches_jax():
    j_traj, p_traj = both_trajectories(np_trajectory(0, 7))
    p_msg = pio.trajectory_to_proto(p_traj)
    assert wire(p_msg) == wire(jio.trajectory_to_proto(j_traj))
    back = pio.trajectory_from_proto(p_msg)
    assert p_ilqr.trajectory_equal(back, p_traj)
    assert back.controls.dtype == torch.float64
    j_back = jio.trajectory_from_proto(p_msg)
    np.testing.assert_array_equal(np.asarray(j_back.states.vel), back.states.vel.numpy())


def test_options_proto_matches_jax():
    args = ((0.25, 0.75, 17), (1e-9, 2e-9, 33))
    j_opts = j_options.ILQROptions(
        j_options.LineSearchParams(*args[0]), j_options.ConvergenceCriteria(*args[1]),
        populate_debug=True, quu_reg=0.5,
    )
    p_opts = p_options.ILQROptions(
        p_options.LineSearchParams(*args[0]), p_options.ConvergenceCriteria(*args[1]),
        populate_debug=True, quu_reg=0.5,
    )
    p_msg = pio.options_to_proto(p_opts)
    assert wire(p_msg) == wire(jio.options_to_proto(j_opts))
    # quu_reg has no field in the reference schema
    assert pio.options_from_proto(p_msg) == p_options.ILQROptions(
        p_options.LineSearchParams(*args[0]), p_options.ConvergenceCriteria(*args[1]),
        populate_debug=True,
    )


def test_debug_proto_matches_jax():
    """An IterDebug with invalid slots: only the valid ones cross, in
    order; None gives the empty message."""
    max_iters, n = 5, 4
    rows = [np_trajectory(s, n) for s in range(max_iters)]
    stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    j_trajs, p_trajs = both_trajectories(stacked)
    costs = np.array([3.0, 2.0, 1.5, 0.0, 0.0])
    valid = np.array([True, True, True, False, False])
    j_debug = j_ilqr.IterDebug(trajectories=j_trajs, costs=jnp.asarray(costs),
                               valid=jnp.asarray(valid))
    p_debug = p_ilqr.IterDebug(trajectories=p_trajs, costs=torch.tensor(costs),
                               valid=torch.tensor(valid))
    p_msg = pio.debug_to_proto(p_debug)
    assert wire(p_msg) == wire(jio.debug_to_proto(j_debug))
    trajs, got_costs = pio.debug_from_proto(p_msg)
    assert got_costs == [3.0, 2.0, 1.5] and len(trajs) == 3
    assert p_ilqr.trajectory_equal(trajs[2], tree_map(lambda a: a[2], p_trajs))
    assert wire(pio.debug_to_proto(None)) == wire(jio.debug_to_proto(None)) == b""


def test_cost_history_does_not_cross_the_proto_boundary():
    """A CostHistory has no trajectories: its first valid slot raises, as
    in the JAX package; with no valid slot the message is empty."""
    valid = torch.tensor([True, False])
    with pytest.raises(AttributeError):
        pio.debug_to_proto(p_ilqr.CostHistory(costs=torch.ones(2), valid=valid))
    with pytest.raises(AttributeError):
        jio.debug_to_proto(j_ilqr.CostHistory(costs=jnp.ones(2), valid=jnp.asarray(valid)))
    empty = p_ilqr.CostHistory(costs=torch.zeros(2), valid=torch.zeros(2, dtype=torch.bool))
    assert wire(pio.debug_to_proto(empty)) == b""


def test_port_messages_are_the_jax_packages_types():
    """The verbatim schema copy resolves to the JAX package's descriptors."""
    for p_mod, j_mod, name in (
        (pio.trajectory_pb2, jio.trajectory_pb2, "QuadrotorTrajectory"),
        (pio.ilqr_options_pb2, jio.ilqr_options_pb2, "ILQROptions"),
        (pio.ilqr_debug_pb2, jio.ilqr_debug_pb2, "QuadrotorILQRDebug"),
    ):
        assert getattr(p_mod, name) is getattr(j_mod, name)
        assert p_mod.DESCRIPTOR is j_mod.DESCRIPTOR


def demo_options(module, populate_debug=True):
    return module.ILQROptions(
        module.LineSearchParams(0.5, 0.5, 100), module.ConvergenceCriteria(1e-12, 1e-12, 100),
        populate_debug=populate_debug,
    )


@pytest.fixture(scope="module")
def config1():
    """BASELINE config 1 solved once by each side: the port through
    `solve(proto)` (constructed from protos), JAX through `solve_pytree`."""
    j_desired = j_wl.demo_desired_trajectory(DEMO_DT)
    jq, jr = j_wl.demo_weights()
    j_api = JQuadrotorILQR(1.0, np.eye(3), 1.0, 0.0, 9.81, jq, jr, j_desired, DEMO_DT,
                           demo_options(j_options))
    # JAX's solve compiled at XLA's backend optimization level 0 without
    # LLVM's expensive passes (IEEE float64 all the same, in less compile
    # time), in a thread beside the port's solve (XLA's compiler releases
    # the GIL)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    j_solve = pool.submit(jax.jit(j_api.solve_pytree).lower(j_desired).compile,
                          {"xla_backend_optimization_level": 0,
                           "xla_llvm_disable_expensive_passes": True})
    desired = p_wl.demo_desired_trajectory(DEMO_DT)
    q, r = p_wl.demo_weights()
    p_api = QuadrotorILQR(
        1.0, np.eye(3), 1.0, 0.0, 9.81, q, r, pio.trajectory_to_proto(desired), DEMO_DT,
        pio.options_to_proto(demo_options(p_options)), device="cpu",
    )
    results = []
    solve_pytree = p_api.solve_pytree
    p_api.solve_pytree = lambda t: results.append(solve_pytree(t)) or results[-1]
    traj_msg, debug_msg = p_api.solve(pio.trajectory_to_proto(desired))
    ref = j_solve.result()(j_desired)
    pool.shutdown()
    return traj_msg, debug_msg, results[0], ref, desired


def test_config1_solve_matches_jax(config1):
    traj_msg, debug_msg, result, ref, _ = config1
    # the port's protos parse into the JAX package's types
    j_traj = jio.trajectory_from_proto(
        jio.trajectory_pb2.QuadrotorTrajectory.FromString(traj_msg.SerializeToString())
    )
    j_trajs, j_costs = jio.debug_from_proto(
        jio.ilqr_debug_pb2.QuadrotorILQRDebug.FromString(debug_msg.SerializeToString())
    )
    assert int(result.status) == int(ref.status) == p_ilqr.STATUS_CONVERGED
    assert int(result.iterations) == int(ref.iterations) == len(j_costs)
    np.testing.assert_allclose(float(result.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(j_traj.controls), np.asarray(ref.trajectory.controls),
                               atol=1e-7)
    valid = np.asarray(ref.debug.valid)
    np.testing.assert_array_equal(result.debug.valid.numpy(), valid)
    np.testing.assert_allclose(result.debug.costs.numpy(), np.asarray(ref.debug.costs), rtol=1e-8)
    np.testing.assert_allclose(j_costs, np.asarray(ref.debug.costs)[valid], rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(j_trajs[-1].controls), np.asarray(ref.debug.trajectories.controls)[valid][-1],
        atol=1e-7,
    )


def test_config1_solve_matches_the_cpp_oracle(config1):
    traj_msg, _, result, _, desired = config1
    q, r = p_wl.demo_weights()
    x = {k: v.numpy() for k, v in (("quat", desired.states.pose.quat),
                                    ("trans", desired.states.pose.trans),
                                    ("vel", desired.states.vel), ("controls", desired.controls))}
    oracle = native.solve(
        1.0, np.eye(3), 1.0, 0.0, 9.81, q.numpy(), r.numpy(), x["quat"], x["trans"], x["vel"],
        x["controls"], x["quat"], x["trans"], x["vel"], x["controls"], DEMO_DT,
    )
    got = pio.trajectory_from_proto(traj_msg)
    assert oracle["status"] == 1 and oracle["iterations"] == int(result.iterations) == 76
    np.testing.assert_allclose(got.controls.numpy(), oracle["controls"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(result.cost), oracle["cost"], rtol=1e-8)


def test_driver_reads_the_debug_record_as_the_proto_carries_it(config1):
    _, debug_msg, result, _, _ = config1
    trajs, costs = driver.debug_iterations(result.debug)
    m_trajs, m_costs = pio.debug_from_proto(debug_msg)
    assert costs == m_costs and len(trajs) == len(m_trajs) == 76
    assert p_ilqr.trajectory_equal(trajs[10], m_trajs[10])
    args = driver.parse_args(["--plot_iters", "--device", "cpu"])
    assert args.plot_iters and not args.show_plots and args.device == "cpu"
    assert args.save_anim_path is None


def test_api_takes_protos_or_containers():
    desired = p_wl.demo_desired_trajectory(DEMO_DT)
    q, r = p_wl.demo_weights()
    args = (1.0, np.eye(3), 1.0, 0.0, 9.81, q, r)
    opts = demo_options(p_options, populate_debug=False)
    a = QuadrotorILQR(*args, pio.trajectory_to_proto(desired), DEMO_DT,
                      pio.options_to_proto(opts), device="cpu")
    b = QuadrotorILQR(*args, desired, DEMO_DT, opts, device="cpu")
    assert a.options == b.options
    assert p_ilqr.trajectory_equal(a.desired_traj, b.desired_traj)


@pytest.mark.parametrize("solver", ["fddp", "fddp-ddp"])
def test_fddp_solvers_refuse_the_debug_record(solver):
    """FDDP has no debug record (the JAX package's solve_fddp returns none)."""
    with pytest.raises(NotImplementedError, match="no debug record"):
        QuadrotorILQR(1.0, np.eye(3), 1.0, 0.0, 9.81, np.eye(12), np.eye(4),
                      p_wl.demo_desired_trajectory(DEMO_DT), DEMO_DT, demo_options(p_options),
                      device="cpu", solver=solver)


def test_trajectory_helpers_match_jax():
    j_traj, p_traj = both_trajectories(np_trajectory(3, 6))
    assert p_ilqr.format_trajectory(p_traj) == j_ilqr.format_trajectory(j_traj)
    assert p_ilqr.format_trajectory(p_traj, 8) == j_ilqr.format_trajectory(j_traj, 8)
    t, state, u = p_ilqr.trajectory_point(p_traj, 2)
    jt, jstate, ju = j_ilqr.trajectory_point(j_traj, 2)
    assert float(t) == float(jt)
    np.testing.assert_array_equal(state.pose.quat.numpy(), np.asarray(jstate.pose.quat))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    nudged = p_ilqr.Trajectory(p_traj.times, p_traj.states, p_traj.controls + 1e-9)
    assert p_ilqr.trajectory_equal(p_traj, p_traj)
    assert not p_ilqr.trajectory_equal(p_traj, nudged)
    assert p_ilqr.trajectory_equal(p_traj, nudged, atol=1e-8)
    assert not p_ilqr.trajectory_equal(p_traj, p_ilqr.Trajectory(p_traj.times[:-1], p_traj.states,
                                                                  p_traj.controls))


def test_line_search_matches_jax():
    """One backtracking search from a feasible trajectory (the full-step
    rollout of random states), per lane against JAX's single-scenario
    `line_search` (vmapped); the reduction fraction 1.0 (the whole
    predicted reduction) makes some lanes accept and others run out."""
    params, cost, traj = port_objects(jax_objects(np_problem(5, 4, 6, random_states=True)))
    dt = 0.02
    k0, big_k0, _, _ = p_ilqr.backward_pass(params, cost, traj, dt)
    traj, current = p_ilqr.rollout_cost(params, cost, traj, k0, big_k0, torch.ones(4), dt)
    ks, big_ks, qutk, ktquuk = p_ilqr.backward_pass(params, cost, traj, dt)
    ls = (0.5, 1.0, 3)
    got = p_ilqr.line_search(params, cost, traj, current, ks, big_ks, qutk, ktquuk, dt,
                             p_options.ILQROptions(p_options.LineSearchParams(*ls)))
    j_params, j_cost, _ = jax_objects(np_problem(5, 4, 6, random_states=True))
    j_opts = j_options.ILQROptions(j_options.LineSearchParams(*ls))
    t = convert.to_numpy(traj)
    j_traj, _ = both_trajectories(dict(times=t.times, quat=t.states.pose.quat,
                                       trans=t.states.pose.trans, vel=t.states.vel,
                                       controls=t.controls))
    search = jax.jit(jax.vmap(lambda t, c, k, big_k, a, b: j_ilqr.line_search(
        j_params, j_cost, t, c, k, big_k, a, b, dt, j_opts)))
    ref = search(j_traj, *(jnp.asarray(a.numpy()) for a in (current, ks, big_ks, qutk, ktquuk)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].sum()) < 4
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-10)
    np.testing.assert_allclose(got[0].controls.numpy(), np.asarray(ref[0].controls), atol=1e-10)
