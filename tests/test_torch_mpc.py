"""The port's receding-horizon MPC slice against the JAX package, f64 on the CPU.

Stage weights ((N,) and (B, N)) on the tracking cost, the box-QP gains, the
plain versions of the three kernels' box and weights variants (backward,
rollout, whole solve) and both exact batch routes with control limits, the
API's `stage_weights`, and `app.mpc.run_mpc` / `mpc_step` (BASELINE config 4's
pattern: rotor limits, terminal weight, plant mismatch), each against the JAX
package's functions on the same numpy inputs. JAX's kernel routes are stood
in for by their XLA reference, `solver.constrained.solve_box` lane by lane
(`jax.lax.map`: the lanes of `jax.vmap(solve_box)`, traced without the
batching rule of its while loops, which costs more than the solve), so no
JAX call here runs in interpret mode; that program is compiled once per
module and also serves JAX's `run_mpc`, through a host callback. Tolerances are the kernel tests': backward 1e-9, rollout 1e-10,
solves status and iterations equal, cost rtol 1e-8, controls atol 1e-7.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu import api as j_api
from quadrotorilqr_tpu.app import mpc as j_mpc
from quadrotorilqr_tpu.costs import quadratic as j_qc
from quadrotorilqr_tpu.lie.se3 import SE3 as JSE3
from quadrotorilqr_tpu.models.quadrotor import QuadrotorParams as JParams
from quadrotorilqr_tpu.models.quadrotor import State as JState
from quadrotorilqr_tpu.solver import constrained as j_con
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.app import mpc as p_mpc
from quadrotorilqr_tpu_torch.app import workloads as p_workloads
from quadrotorilqr_tpu_torch.costs import quadratic as p_qc
from quadrotorilqr_tpu_torch.kernels import backward as p_kb
from quadrotorilqr_tpu_torch.kernels import rollout as p_kr
from quadrotorilqr_tpu_torch.kernels import stream as p_kstream
from quadrotorilqr_tpu_torch.models.se3_wrench import WrenchParams
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import constrained as p_con
from quadrotorilqr_tpu_torch.solver import fddp as p_fddp

from test_torch_kernels import (
    DT,
    assert_same_solution,
    jax_objects,
    np_problem,
    options_pair,
    port_objects,
)

HOVER = 9.81 / 4.0
J_OPTS, P_OPTS = options_pair(6)
# the MPC case: a fleet of 4, horizon 8, 4 ticks at 100 Hz. The exact routes'
# solves run at its shapes and dt, so that JAX traces solve_box once for
# both (jit's trace cache).
FLEET, H, TICKS, MPC_DT = 4, 8, 4, 0.01


def as_tuple(result):
    return (result.trajectory, result.cost, result.iterations, result.status)


def _compiled(fn, *args):
    """fn compiled by XLA for args at backend optimization level 0 and
    without LLVM's expensive passes: IEEE float64 all the same, in less
    compile time than the default."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    )


def _xla(fn, *args):
    return _compiled(fn, *args)(*args)


@pytest.fixture(scope="module")
def box_problem():
    """A hover problem from perturbed starts (np_problem, at the MPC case's
    shapes) with terminal and per-scenario stage weights and shared,
    per-scenario and mixed bounds (a shared lower bound, per-scenario upper
    ones), as numpy; JAX takes every case's bounds and weights broadcast per
    scenario, so that one JAX compilation serves them all."""
    d = np_problem(11, FLEET, H, False)
    rng = np.random.default_rng(12)
    w_n = np.ones(H)
    w_n[-1] = 20.0
    lo_b = HOVER - rng.uniform(0.05, 0.25, size=(FLEET, 4))
    hi_b = HOVER + rng.uniform(0.05, 0.25, size=(FLEET, 4))
    return dict(
        d=d,
        weights=dict(shared=w_n, per_scenario=rng.uniform(0.5, 2.0, size=(FLEET, H)), mixed=w_n),
        limits=dict(shared=(1.8, 2.9), per_scenario=(lo_b, hi_b), mixed=(1.8, hi_b)),
    )


def _weighted(cost, w):
    """A cost of either package with stage weights w."""
    return dataclasses.replace(cost, stage_weights=w)


def _per_scenario(a, shape):
    return np.broadcast_to(np.asarray(a, np.float64), shape)


def _lanes_solve_box(params, cost, trajs, dt_s, options, lo, hi, weights):
    """solve_box lane by lane over (B, ...) trajectories, (B, 4) bounds and
    (B, N) weights: what jax.vmap(solve_box) computes for each lane."""
    return jax.lax.map(
        lambda a: j_con.solve_box(params, _weighted(cost, a[0]), a[1], dt_s, a[2], a[3], options),
        (weights, trajs, lo, hi),
    )


@pytest.fixture(scope="module")
def lanes_solve(box_problem):
    """JAX's solve_box on every lane of a (FLEET, H) problem at MPC_DT and
    J_OPTS, compiled once: f(params, cost, trajs, lo, hi, w) with (B, 4)
    bounds and (B, N) weights, for the exact routes' references and, through
    a host callback, for JAX's run_mpc."""
    params, cost, traj = jax_objects(box_problem["d"])
    example = (params, cost, traj, jnp.zeros((FLEET, 4)), jnp.zeros((FLEET, 4)),
               jnp.zeros((FLEET, H)))
    solve = _compiled(
        lambda p, c, t, lo, hi, w: _lanes_solve_box(p, c, t, MPC_DT, J_OPTS, lo, hi, w), *example
    )
    solve.shapes = jax.eval_shape(
        lambda p, c, t, lo, hi, w: _lanes_solve_box(p, c, t, MPC_DT, J_OPTS, lo, hi, w), *example
    )
    return solve


@pytest.fixture(scope="module")
def jax_box(box_problem, lanes_solve):
    """solve_box on every lane with per-scenario bounds and weights, by
    case: the shared case's bounds and weights broadcast to per scenario."""
    params, cost, traj = jax_objects(box_problem["d"])
    cache = {}

    def get(case):
        if case not in cache:
            w = _per_scenario(box_problem["weights"][case], (FLEET, H))
            lo, hi = (_per_scenario(b, (FLEET, 4)) for b in box_problem["limits"][case])
            cache[case] = lanes_solve(params, cost, traj, *(jnp.asarray(a) for a in (lo, hi, w)))
        return cache[case]

    return get


def _port(box_problem, case):
    """The port's (params, weighted cost, traj, limits) for a case."""
    params, cost, traj = port_objects(jax_objects(box_problem["d"]))
    w = torch.tensor(box_problem["weights"][case])
    limits = tuple(torch.as_tensor(np.asarray(b, np.float64)) for b in box_problem["limits"][case])
    return params, _weighted(cost, w), traj, limits


CASES = ["shared", "per_scenario", "mixed"]


# ---- the weighted cost and the box-QP ----


def _jax_cost_terms(cost, traj):
    """JAX's stage_cost_with_diffs, per_stage_costs and trajectory_cost."""
    xs, us = traj.states, traj.controls
    diffs = j_qc.stage_cost_with_diffs(cost, xs, us, cost.desired_states, cost.desired_controls)
    return diffs + (j_qc.per_stage_costs(cost, xs, us), j_qc.trajectory_cost(cost, xs, us))


@pytest.mark.parametrize("case", CASES)
def test_weighted_cost_matches_jax(case):
    """Stage weights (N,) or (B, N) on the cost diffs, the per-stage costs
    and the trajectory cost, at 1e-12 (JAX's reference takes the (N,)
    weights broadcast to (B, N): one compilation)."""
    d = np_problem(13, 4, 6, True)
    w = np.random.default_rng(14).uniform(0.5, 2.0, size=(4, 6) if case == "per_scenario" else 6)
    j_params, j_cost, j_traj = jax_objects(d)
    j_cost = _weighted(j_cost, jnp.asarray(w))
    _, p_cost, p_traj = port_objects((j_params, j_cost, j_traj))
    assert p_cost.stage_weights is not None  # convert.py carries the weights
    ref = _xla(_jax_cost_terms, _weighted(j_cost, jnp.asarray(_per_scenario(w, (4, 6)))), j_traj)
    got = p_qc.stage_cost_with_diffs(
        p_cost, p_traj.states, p_traj.controls, p_cost.desired_states, p_cost.desired_controls
    ) + (p_qc.per_stage_costs(p_cost, p_traj.states, p_traj.controls),
         p_qc.trajectory_cost(p_cost, p_traj.states, p_traj.controls))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(
            np.broadcast_to(g.numpy(), np.shape(r)), np.asarray(r), rtol=1e-12, atol=1e-12
        )


@pytest.mark.parametrize("binding", ["none", "some", "all"])
def test_boxqp_gains_matches_jax(binding):
    """Projected Newton on seeded SPD problems with no, some and all
    bounds binding: the same step and feedback, at 1e-12."""
    rng = np.random.default_rng(15)
    a = rng.normal(size=(32, 4, 4))
    q_uu = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4)
    q_u = 3.0 * rng.normal(size=(32, 4))
    q_ux = rng.normal(size=(32, 4, 12))
    width = {"none": 1e6, "some": 0.5, "all": 1e-3}[binding]
    lo = -width * rng.uniform(0.5, 1.0, size=(32, 4))
    hi = width * rng.uniform(0.5, 1.0, size=(32, 4))
    ref_k, ref_big_k = _xla(j_con._boxqp_gains, *(jnp.asarray(x) for x in (q_uu, q_u, q_ux, lo, hi)))
    k, big_k = p_con._boxqp_gains(*(torch.tensor(x) for x in (q_uu, q_u, q_ux, lo, hi)))
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(big_k.numpy(), np.asarray(ref_big_k), rtol=1e-12, atol=1e-12)
    on_bound = np.isclose(k.numpy(), lo, rtol=0, atol=1e-14) | np.isclose(k.numpy(), hi, rtol=0,
                                                                            atol=1e-14)
    expected = {"none": on_bound.sum() == 0, "some": 0 < on_bound.sum() < on_bound.size,
                "all": on_bound.all()}
    assert expected[binding]
    # the feedback rows of the clamped controls are zero
    assert bool((big_k.numpy()[on_bound] == 0).all())


# ---- the plain versions of the kernels' variants ----


def _jax_box_passes(params, cost, traj, lo, hi, alpha):
    """JAX backward_pass_box, then forward_sim_box on its gains and the
    weighted cost of the rollout."""
    ref = j_con.backward_pass_box(params, cost, traj, DT, lo, hi)
    ref_t = j_con.forward_sim_box(params, traj, ref[0], ref[1], alpha, DT, lo, hi)
    return ref, ref_t, j_qc.trajectory_cost(cost, ref_t.states, ref_t.controls)


@pytest.mark.parametrize("case", CASES)
def test_backward_and_rollout_box_plain_match_jax(box_problem, case):
    """kernels.backward's and kernels.rollout's plain versions with limits
    and weights against JAX backward_pass_box, forward_sim_box and the
    weighted trajectory cost, on a random trajectory (1e-9, 1e-10); JAX
    takes the shared bounds and weights broadcast per scenario (one
    compilation)."""
    d = np_problem(16, FLEET, H, True)
    j_params, j_cost, j_traj = jax_objects(d)
    w = box_problem["weights"][case]
    lo, hi = box_problem["limits"][case]
    p_params, p_cost, p_traj = port_objects((j_params, _weighted(j_cost, jnp.asarray(w)), j_traj))
    alpha = np.linspace(0.2, 1.0, FLEET)
    ref, ref_t, ref_c = _xla(
        _jax_box_passes, j_params, _weighted(j_cost, jnp.asarray(_per_scenario(w, (FLEET, H)))),
        j_traj, *(jnp.asarray(_per_scenario(b, (FLEET, 4))) for b in (lo, hi)), jnp.asarray(alpha),
    )
    got = p_kb.backward_pass_fused(p_params, p_cost, p_traj, DT, limits=(lo, hi))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9)
    got_t, got_c = p_kr.rollout_cost_fused(
        p_params, p_cost, p_traj, got[0], got[1], torch.tensor(alpha), DT, limits=(lo, hi)
    )
    np.testing.assert_allclose(got_t.controls.numpy(), np.asarray(ref_t.controls), atol=1e-10)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-10)
    lo_b, hi_b = (_per_scenario(b, (FLEET, 4))[:, None] for b in (lo, hi))
    u = got_t.controls.numpy()
    assert ((u >= lo_b) & (u <= hi_b)).all() and ((u == lo_b) | (u == hi_b)).any()


ROUTES = {
    "latency": p_batched.solve_batch_latency,
    "fused": p_batched.solve_batch_fused,
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_exact_routes_match_jax_solve_box(box_problem, jax_box, route, case):
    """solve_batch_latency (solve.cu's plain version on the CPU) and
    solve_batch_fused (the per-pass kernels' plain versions) with limits
    (shared, per scenario, or mixed: broadcast up to per scenario) and
    stage weights against JAX's solve_box on every lane, the weighted cost:
    status and iterations equal, cost rtol 1e-8, controls atol 1e-7; every
    control in its box, and the box binds."""
    params, cost, traj, limits = _port(box_problem, case)
    got = ROUTES[route](params, cost, traj, MPC_DT, P_OPTS, limits=limits)
    assert_same_solution(as_tuple(got), as_tuple(jax_box(case)))
    lo_b, hi_b = (_per_scenario(b, (FLEET, 4))[:, None] for b in box_problem["limits"][case])
    u = got.trajectory.controls.numpy()
    assert ((u >= lo_b) & (u <= hi_b)).all() and ((u == lo_b) | (u == hi_b)).any()


def test_unit_weights_equal_no_weights(box_problem):
    """Unit stage weights leave every gain and control bit for bit: the
    trajectory, status and iterations equal the unweighted solve's, and
    the cost (summed w (dx'Q dx + du'R du) rather than dx'Q dx + du'R du)
    agrees to rounding."""
    params, cost, traj, limits = _port(box_problem, "shared")
    base = p_batched.solve_batch_latency(params, _weighted(cost, None), traj, DT, P_OPTS,
                                         limits=limits)
    unit = p_batched.solve_batch_latency(params, _weighted(cost, torch.ones(H, dtype=torch.float64)),
                                         traj, DT, P_OPTS, limits=limits)
    for a, b in ((unit.status, base.status), (unit.iterations, base.iterations),
                 (unit.trajectory.controls, base.trajectory.controls),
                 (unit.trajectory.states.pose.trans, base.trajectory.states.pose.trans)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(unit.cost.numpy(), base.cost.numpy(), rtol=1e-15, atol=0)


def test_api_solve_pytree_with_stage_weights_matches_jax():
    """QuadrotorILQR(stage_weights=...) against the JAX class on one
    trajectory: the plain loop on the weighted cost."""
    d = np_problem(17, 1, H, False)
    w = np.linspace(1.0, 5.0, H)
    _, j_cost, j_traj = jax_objects(d)
    one = jax.tree.map(lambda a: a[0], j_traj)
    desired = JTraj(times=one.times, states=j_cost.desired_states, controls=j_cost.desired_controls)
    args = (1.3, np.diag([0.4, 0.5, 0.6]) + 0.05, 0.2, 0.016, 9.81, d["Q"], d["R"])
    ref = _xla(j_api.QuadrotorILQR(*args, desired, DT, J_OPTS, stage_weights=w).solve_pytree, one)
    p_desired = convert.trajectory_from_numpy(jax.tree.map(np.asarray, desired))
    api = QuadrotorILQR(*args, p_desired, DT, P_OPTS, device="cpu", stage_weights=w)
    got = api.solve_pytree(convert.trajectory_from_numpy(jax.tree.map(np.asarray, one)))
    assert_same_solution(as_tuple(got), as_tuple(ref))


# ---- the MPC loop ----


@pytest.fixture(scope="module")
def mpc_case():
    """BASELINE config 4's problem at fleet 4, H 8, 4 ticks, f64 (the port's
    workload and the same numbers for JAX), with the constrained variant's
    limits and terminal weight and the mismatched plant."""
    pb = p_workloads.mpc_hover_problem(
        np.random.default_rng(18), FLEET, horizon=H, ticks=TICKS, dtype=torch.float64,
        device="cpu",
    )
    # falling at ~2 m/s: braking in 4 ticks binds the upper bound on some
    # rotors and ticks (config 4's own start needs more ticks to bind)
    vel = np.random.default_rng(19).normal(scale=[0.5, 0.5, 0.2, 0, 0, 0], size=(FLEET, 6))
    vel[:, 2] -= 2.0
    x0 = dataclasses.replace(pb.x0, vel=torch.tensor(vel))
    return pb._replace(x0=x0)


def _jax_params(p):
    a = lambda x: jnp.asarray(x.numpy())
    return JParams(mass_kg=a(p.mass_kg), inertia=a(p.inertia), arm_length_m=a(p.arm_length_m),
                   torque_to_thrust_ratio_m=a(p.torque_to_thrust_ratio_m), g_mpss=a(p.g_mpss))


@pytest.fixture(scope="module")
def jax_mpc(mpc_case, lanes_solve):
    """JAX run_mpc on the same problem, its kernel routes stood in for by
    solve_box on every lane (the JAX package's files are not touched: the
    module's two engine names are patched for this call). The solves run
    `lanes_solve`, compiled once for this module, through a host callback."""
    pb = mpc_case

    def lanes_solve_box(params, cost, trajs, dt_s, options, interpret=False, limits=None):
        assert (dt_s, options) == (MPC_DT, J_OPTS)
        batch = trajs.controls.shape[0]
        weights = jnp.broadcast_to(cost.stage_weights, (batch, H))
        lo, hi = (jnp.broadcast_to(b, (batch, 4)) for b in limits)
        args = (params, _weighted(cost, None), trajs, lo, hi, weights)
        return jax.pure_callback(lambda *a: lanes_solve(*a), lanes_solve.shapes, *args)

    a = lambda x: jnp.asarray(x.numpy())
    state = lambda s: JState(pose=JSE3(quat=a(s.pose.quat), trans=a(s.pose.trans)), vel=a(s.vel))
    desired = JTraj(times=a(pb.desired.times), states=state(pb.desired.states),
                    controls=a(pb.desired.controls))
    x0 = state(pb.x0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mpc, "solve_batch_latency", lanes_solve_box)
        mp.setattr(j_mpc, "solve_batch_fused", lanes_solve_box)
        run = functools.partial(
            j_mpc.run_mpc.__wrapped__, n_steps=TICKS, horizon=H, dt_s=MPC_DT, options=J_OPTS,
            latency_kernel=True,
        )
        out = _xla(
            lambda *args: run(*args[:5], stage_weights=args[5], limits=args[6], plant_params=args[7]),
            _jax_params(pb.params), a(pb.q), a(pb.r), desired, x0, a(pb.stage_weights),
            tuple(jnp.full(4, b) for b in pb.limits), _jax_params(pb.plant),
        )
    return jax.tree.map(np.asarray, out)


def _run_port(pb, plant=True, **kw):
    return p_mpc.run_mpc(
        pb.params, pb.q, pb.r, pb.desired, pb.x0, TICKS, H, MPC_DT, P_OPTS,
        stage_weights=pb.stage_weights, limits=pb.limits,
        plant_params=pb.plant if plant else None, **kw,
    )


@pytest.mark.parametrize("latency", [True, False], ids=["latency", "fused"])
def test_run_mpc_matches_jax(mpc_case, jax_mpc, latency):
    """Port run_mpc (limits, terminal weight, plant mismatch) against JAX
    run_mpc tick for tick: applied controls, iterations, status, the final
    plant state; every applied control in [0, 2.9], the upper bound binding."""
    out = _run_port(mpc_case, latency_kernel=latency)
    np.testing.assert_array_equal(out["status"].numpy(), jax_mpc["status"])
    np.testing.assert_array_equal(out["iterations"].numpy(), jax_mpc["iterations"])
    np.testing.assert_allclose(out["u"].numpy(), jax_mpc["u"], atol=1e-7)
    np.testing.assert_allclose(out["cost"].numpy(), jax_mpc["cost"], rtol=1e-8)
    np.testing.assert_allclose(out["x_trans"].numpy(), jax_mpc["x_trans"], atol=1e-9)
    got_final = convert.to_numpy(out["x_final"])
    ref_final = jax_mpc["x_final"]
    np.testing.assert_allclose(got_final.pose.trans, ref_final.pose.trans, atol=1e-9)
    np.testing.assert_allclose(got_final.vel, ref_final.vel, atol=1e-8)
    u = out["u"].numpy()
    assert u.min() >= 0.0 and u.max() <= 2.9 and (u == 2.9).any()


def test_mpc_step_equals_a_tick_of_run_mpc(mpc_case):
    """The host-driven step (its plant the controller's model, as in the
    JAX package) replays run_mpc's ticks bit for bit."""
    pb = mpc_case
    out = _run_port(pb, plant=False, latency_kernel=True)
    x, warm = pb.x0, p_mpc.mpc_warm_start(pb.desired, pb.x0, H)
    for k in range(TICKS):
        x, warm, u0 = p_mpc.mpc_step(
            pb.params, pb.q, pb.r, pb.desired, x, warm, k, H, MPC_DT, P_OPTS,
            latency_kernel=True, stage_weights=pb.stage_weights, limits=pb.limits,
        )
        np.testing.assert_array_equal(u0.numpy(), out["u"][:, k].numpy())
    np.testing.assert_array_equal(x.pose.trans.numpy(), out["x_final"].pose.trans.numpy())
    np.testing.assert_array_equal(warm.controls.numpy(), out["warm_final"].controls.numpy())


# ---- what stays refused ----


def _raises(request_):
    params, cost, traj = port_objects(jax_objects(np_problem(21, 2, 4, False)))
    if request_ == "penalty":
        # the augmented-Lagrangian penalty is ported on the quadrotor's FDDP
        # loop (tests/test_torch_auglag.py), not with another family
        wrench = WrenchParams.create(1.3, torch.eye(3, dtype=torch.float64), 9.81)
        p_fddp.solve_fddp(wrench, cost, traj, DT, P_OPTS, limits=(0.0, 5.0),
                          penalty_fns=(None, None))
    elif request_ == "family":
        wrench = WrenchParams.create(1.3, torch.eye(3, dtype=torch.float64), 9.81)
        p_batched.solve_batch_fddp(wrench, cost, traj, DT, P_OPTS, limits=(0.0, 5.0))
    else:
        # the wrench's stream.cu has no box instantiation: refused on the
        # host before any launch
        wrench = WrenchParams.create(1.3, torch.eye(3, dtype=torch.float64), 9.81)
        w_cost = dataclasses.replace(cost, R=torch.eye(6, dtype=torch.float64),
                                     desired_controls=torch.zeros(4, 6, dtype=torch.float64))
        w_traj = dataclasses.replace(traj, controls=torch.zeros(2, 4, 6, dtype=torch.float64))
        p_kstream._launch(wrench, w_cost, w_traj, DT, P_OPTS, limits=(-20.0, 20.0))


@pytest.mark.parametrize(
    "request_, item",
    [
        ("penalty", "Queue 1 item 11b"),
        ("family", "Queue 1 item 11b"),
        ("stream_family_box", "Queue 1 item 11c"),
    ],
    ids=["fddp_penalty", "fddp_family", "stream_family_box"],
)
def test_unported_variants_raise(request_, item):
    """What this slice leaves refused names its ROADMAP item: the FDDP
    solvers with model families other than the quadrotor's (with the
    augmented-Lagrangian penalty too), and limits on a family's stream.cu
    (the box-QP is the quadrotor's)."""
    with pytest.raises(NotImplementedError, match=item):
        _raises(request_)


def test_run_mpc_refuses_fddp_and_short_targets(mpc_case):
    """An MPC solver other than "ilqr" and "fddp" ("fddp-ddp" is the API's
    name, not the loop's) and a desired trajectory too short for the run
    raise ValueError."""
    pb = mpc_case
    with pytest.raises(ValueError, match="unknown MPC solver"):
        _run_port(pb, solver="fddp-ddp")
    with pytest.raises(ValueError, match="needs >= "):
        p_mpc.run_mpc(pb.params, pb.q, pb.r, pb.desired, pb.x0, TICKS + 50, H, MPC_DT, P_OPTS)
