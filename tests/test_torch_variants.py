"""Control limits and stage weights on the port's robust FDDP slice and its
streamed exact loop, f64 on the CPU.

Against the JAX package: the weighted exact cost Hessian
(`exact_cxx_analytic`) at 1e-12; the plain `solve_fddp` with per-scenario
bounds and stage weights, Gauss-Newton and exact DDP, against JAX's
`solve_fddp(limits=...)` on every lane (tests/test_torch_fddp.py's bars);
`QuadrotorILQR(solver="fddp", stage_weights=...).solve_pytree` against
JAX's `solve_fddp` on the weighted cost (what the JAX class runs);
`app.mpc.run_mpc(solver="fddp")` with rotor limits and a
terminal weight on a tumbling fleet against JAX's `run_mpc`, its
`solve_batch_fddp` stood in for by the lanes of `vmap(solve_fddp)`. Without
JAX: the streamed plain versions with limits and weights bit-equal to the
whole ones, and the batch solvers' routes carrying limits and weights to
every kernel launch (stubbed wrappers, nothing solved).

The JAX references are compiled once for the module, lane by lane
(`jax.lax.map`, what `jax.vmap(solve_fddp)` computes for each lane, without
tracing the batching rule of its while loops) at XLA's backend optimization
level 0 without LLVM's expensive passes, traced one by one and compiled side
by side in threads; the Gauss-Newton program takes the problem as operands,
so that it also serves JAX's `run_mpc` through a host callback, and solves
each lane with the weights alone as well (the class's case). No JAX call
here runs in interpret mode.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.app import mpc as j_mpc
from quadrotorilqr_tpu.lie.se3 import SE3 as JSE3
from quadrotorilqr_tpu.models.quadrotor import State as JState
from quadrotorilqr_tpu.solver import batched as j_batched
from quadrotorilqr_tpu.solver import ddp as j_ddp
from quadrotorilqr_tpu.solver.fddp import solve_fddp as j_solve_fddp
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.app import mpc as p_mpc
from quadrotorilqr_tpu_torch.app import workloads as p_workloads
from quadrotorilqr_tpu_torch.kernels import fddp as p_kfddp
from quadrotorilqr_tpu_torch.kernels import solve as p_ksolve
from quadrotorilqr_tpu_torch.kernels import stream as p_kstream
from quadrotorilqr_tpu_torch.kernels import stream_fddp as p_kstream_fddp
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import ddp as p_ddp
from quadrotorilqr_tpu_torch.solver import fddp as p_fddp
from quadrotorilqr_tpu_torch.solver import options as p_options
from quadrotorilqr_tpu_torch.tree import tree_map

from test_torch_fddp import XLA_FAST, mixed_problem
from test_torch_kernels import assert_same_solution, port_objects
from test_torch_cuda import problem as np_problem
from test_torch_mpc import _jax_params
from test_torch_stream import assert_identical

# the problem and the MPC fleet share their shapes, dt and options, so that
# one compiled Gauss-Newton program serves both
B, N, DT, ITERS = 6, 8, 0.1, 6
LS, CC = (0.5, 0.5, 8), (1e-9, 1e-9, ITERS)
J_OPTS = ILQROptions(LineSearchParams(*LS), ConvergenceCriteria(*CC))
P_OPTS = p_options.ILQROptions(p_options.LineSearchParams(*LS), p_options.ConvergenceCriteria(*CC))
TICKS = 2
MPC_LIMITS = (0.0, 4.0)


def as_tuple(result):
    return (result.trajectory, result.cost, result.iterations, result.status)


@pytest.fixture(scope="module")
def problem():
    """tests/test_fddp_fused.py's mixed problem (benign and tumbling lanes,
    the hard ones at scale 1.2 as in its control-limits test) with
    per-scenario bounds, (B, 4) each, and per-scenario stage weights
    U(0.5, 2) with a terminal weight of 20: the JAX objects, the port's, and
    the bounds and weights as numpy."""
    # one XLA program (JAX's op-by-op dispatch compiles every operation it
    # meets first, which takes longer)
    jobjs = jax.jit(lambda: mixed_problem(seed=31, batch=B, n=N, hard_scale=1.2)).lower().compile(
        XLA_FAST)()
    rng = np.random.default_rng(32)
    lo = rng.uniform(0.0, 0.5, size=(B, 4))
    hi = rng.uniform(5.0, 7.0, size=(B, 4))
    w = rng.uniform(0.5, 2.0, size=(B, N))
    w[:, -1] = 20.0
    return jobjs, port_objects(jobjs), (lo, hi, w)


def _weighted(cost, w):
    return dataclasses.replace(cost, stage_weights=w)


def _lanes_fddp(ddp):
    """solve_fddp lane by lane over (B, ...) trajectories with (B, 4) bounds
    and (B, N) weights: what jax.vmap(solve_fddp) computes for each lane."""
    def run(params, cost, trajs, lo, hi, w):
        return jax.lax.map(
            lambda a: j_solve_fddp(params, _weighted(cost, a[0]), a[1], DT, J_OPTS, ddp=ddp,
                                   limits=(a[2], a[3])),
            (w, trajs, lo, hi),
        )
    return run


def _jax_cxx(cost, trajs, w):
    return jax.vmap(lambda t, wl: j_ddp.exact_cxx_analytic(_weighted(cost, wl), t))(trajs, w)


def _gauss_newton(params, cost, trajs, lo, hi, w):
    """The Gauss-Newton lanes with bounds and weights, and with the weights
    alone; the weighted exact c_xx of every lane with its weights and with
    lane 0's."""
    return _lanes_fddp(False)(params, cost, trajs, lo, hi, w), jax.lax.map(
        lambda a: j_solve_fddp(params, _weighted(cost, a[0]), a[1], DT, J_OPTS), (w, trajs)
    ), (_jax_cxx(cost, trajs, w), _jax_cxx(cost, trajs, jnp.broadcast_to(w[0], w.shape)))


def _tumble_fleet():
    """The port's tumbling MPC fleet at the problem's shapes and dt, f64."""
    return p_workloads.tumble_mpc_problem(
        torch.Generator().manual_seed(5), B, ticks=TICKS, horizon=N, dtype=torch.float64,
        device="cpu",
    )


def _jax_state(s):
    a = lambda x: jnp.asarray(x.numpy())
    return JState(pose=JSE3(quat=a(s.pose.quat), trans=a(s.pose.trans)), vel=a(s.vel))


@pytest.fixture(scope="module")
def jax_refs(problem):
    """The module's JAX programs, traced one by one and compiled side by
    side: solve_fddp on every lane with bounds and weights (Gauss-Newton,
    whose program takes the problem as operands and also solves every lane
    with the weights alone and evaluates the weighted exact c_xx, and exact
    DDP), and JAX's run_mpc with
    solver="fddp" on the tumbling fleet, its solve_batch_fddp stood in for by
    the Gauss-Newton program through a host callback. Returns their
    results."""
    (params, cost, trajs), _, bw = problem
    lo, hi, w = (jnp.asarray(a) for a in bw)
    gn_args = (params, cost, trajs, lo, hi, w)
    lowered = {"gn": jax.jit(_gauss_newton).lower(*gn_args),
               "ddp": jax.jit(_lanes_fddp(True)).lower(*gn_args)}
    shapes = jax.eval_shape(_gauss_newton, *gn_args)
    compiled = {}

    # JAX's run_mpc on the port's tumbling fleet
    pb = _tumble_fleet()

    def lanes_solve_fddp(params, cost, trajs, dt_s, options, fddp_options=None, interpret=False,
                         limits=None):
        assert (dt_s, options, fddp_options) == (DT, J_OPTS, None)
        batch = trajs.controls.shape[0]
        weights = jnp.broadcast_to(cost.stage_weights, (batch, N))
        lo_b, hi_b = (jnp.broadcast_to(b, (batch, 4)) for b in limits)
        args = (params, _weighted(cost, None), trajs, lo_b, hi_b, weights)
        return jax.pure_callback(lambda *a: compiled["gn"](*a), shapes, *args)[0]

    a = lambda x: jnp.asarray(x.numpy())
    j_desired = JTraj(times=a(pb.desired.times), states=_jax_state(pb.desired.states),
                      controls=a(pb.desired.controls))
    w_t = a(p_workloads.terminal_weights(N, torch.float64))
    run = functools.partial(j_mpc.run_mpc.__wrapped__, n_steps=TICKS, horizon=N, dt_s=DT,
                            options=J_OPTS, solver="fddp")
    mpc_args = (_jax_params(pb.params), a(pb.q), a(pb.r), j_desired, _jax_state(pb.x0), w_t,
                tuple(jnp.full(4, b) for b in MPC_LIMITS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_batched, "solve_batch_fddp", lanes_solve_fddp)
        lowered["mpc"] = jax.jit(
            lambda *args: run(*args[:5], stage_weights=args[5], limits=args[6])
        ).lower(*mpc_args)

    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

    def build(name):
        compiled[name] = lowered[name].compile(opts)

    threads = [threading.Thread(target=build, args=(k,)) for k in lowered]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {k: compiled[k](*gn_args) for k in ("gn", "ddp")}
    out["gn"], out["weights"], out["cxx"] = out["gn"]
    out["mpc"] = jax.tree.map(np.asarray, compiled["mpc"](*mpc_args))
    return out


def _port_limits(bw):
    return tuple(torch.tensor(b) for b in bw[:2]), torch.tensor(bw[2])


# ---- the weighted exact cost Hessian ----


@pytest.mark.parametrize("weights", ["shared", "per_scenario"])
def test_exact_cxx_analytic_weighted_matches_jax(problem, jax_refs, weights):
    """The exact c_xx scaled by the stage weight once its Lie correction is
    in (JAX's order), (N,) or (B, N) weights (JAX's per lane), at 1e-12."""
    _, (_, p_cost, p_trajs), (_, _, w) = problem
    w, ref = (w, jax_refs["cxx"][0]) if weights == "per_scenario" else (w[0], jax_refs["cxx"][1])
    got = p_ddp.exact_cxx_analytic(_weighted(p_cost, torch.tensor(w)), p_trajs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * float(np.abs(ref).max()))


# ---- the plain FDDP loop with limits and weights against JAX ----


@pytest.mark.parametrize("ddp", [False, True], ids=["gn", "ddp"])
def test_solve_fddp_box_weights_matches_jax(problem, jax_refs, ddp):
    """The port's batched solve_fddp with per-scenario bounds and weights
    against JAX's solve_fddp on every lane, at tests/test_torch_fddp.py's
    bars (exact DDP: controls within 1e-6, the weakly determined converged
    controls); every control in its box, and the box binds."""
    _, (params, cost, trajs), bw = problem
    limits, w = _port_limits(bw)
    got = p_fddp.solve_fddp(params, _weighted(cost, w), trajs, DT, P_OPTS, ddp=ddp,
                            limits=limits)
    ref = jax_refs["ddp" if ddp else "gn"]
    assert_same_solution(as_tuple(got), as_tuple(ref), rtol_cost=1e-8,
                         atol_traj=1e-6 if ddp else 1e-9)
    u = got.trajectory.controls.numpy()
    lo, hi = (b[:, None] for b in bw[:2])
    assert ((u >= lo) & (u <= hi)).all() and ((u == lo) | (u == hi)).any()


def test_api_fddp_solve_pytree_with_stage_weights_matches_jax(problem, jax_refs):
    """QuadrotorILQR(solver="fddp", stage_weights=...).solve_pytree on one
    trajectory (a tumble): the plain FDDP loop on the weighted cost, against
    JAX's solve_fddp on it, what the JAX class's solve_pytree runs."""
    (_, j_cost, j_trajs), _, bw = problem
    desired = convert.trajectory_from_numpy(jax.tree.map(np.asarray, JTraj(
        times=j_trajs.times[0], states=j_cost.desired_states, controls=j_cost.desired_controls)))
    api = QuadrotorILQR(1.0, np.diag([0.01, 0.012, 0.02]), 0.17, 0.016, 9.81, np.array(j_cost.Q),
                        np.array(j_cost.R), desired, DT, P_OPTS, device="cpu",
                        stage_weights=bw[2][1], solver="fddp")
    one = convert.trajectory_from_numpy(jax.tree.map(lambda a: np.asarray(a[1]), j_trajs))
    got = api.solve_pytree(one)
    ref = jax.tree.map(lambda a: a[1], jax_refs["weights"])
    assert_same_solution(as_tuple(got), as_tuple(ref), rtol_cost=1e-8, atol_traj=1e-9)


@pytest.mark.parametrize("solver", ["fddp", "fddp-ddp"])
def test_api_fddp_solve_batch_carries_stage_weights(problem, monkeypatch, solver):
    """Both FDDP solvers take stage weights; a float32 batch runs
    solve_batch_fddp(refine="auto") on the weighted cost, as the JAX class
    runs it."""
    (_, j_cost, j_trajs), _, bw = problem
    seen = {}

    def spy(params, cost, trajs, dt_s, options, ddp=False, refine=None):
        seen.update(weights=cost.stage_weights, ddp=ddp, refine=refine)
        return "routed"

    monkeypatch.setattr("quadrotorilqr_tpu_torch.api.solve_batch_fddp", spy)
    desired = convert.trajectory_from_numpy(jax.tree.map(np.asarray, JTraj(
        times=j_trajs.times[0], states=j_cost.desired_states, controls=j_cost.desired_controls)))
    api = QuadrotorILQR(1.0, np.eye(3), 0.17, 0.016, 9.81, np.eye(12), np.eye(4), desired, DT,
                        P_OPTS, dtype=torch.float32, device="cpu", stage_weights=bw[2][0],
                        solver=solver)
    trajs = convert.trajectory_from_numpy(jax.tree.map(np.asarray, j_trajs))
    assert api.solve_batch(trajs) == "routed"
    assert seen["refine"] == "auto" and seen["ddp"] == (solver == "fddp-ddp")
    np.testing.assert_array_equal(seen["weights"].numpy(), bw[2][0].astype(np.float32))


# ---- the robust MPC loop ----


def test_run_mpc_fddp_matches_jax(jax_refs):
    """run_mpc(solver="fddp") with rotor limits and the terminal weight on
    the tumbling fleet (the FDDP kernel's plain version each tick) against
    JAX's run_mpc tick for tick: statuses, iterations, applied controls,
    costs and the final plant state; every applied control in its box."""
    pb = _tumble_fleet()
    out = p_mpc.run_mpc(
        pb.params, pb.q, pb.r, pb.desired, pb.x0, TICKS, N, DT, P_OPTS,
        stage_weights=p_workloads.terminal_weights(N, torch.float64),
        limits=MPC_LIMITS, solver="fddp",
    )
    ref = jax_refs["mpc"]
    np.testing.assert_array_equal(out["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(out["iterations"].numpy(), ref["iterations"])
    np.testing.assert_allclose(out["u"].numpy(), ref["u"], atol=1e-7)
    np.testing.assert_allclose(out["cost"].numpy(), ref["cost"], rtol=1e-8)
    np.testing.assert_allclose(out["x_final"].pose.trans.numpy(), ref["x_final"].pose.trans,
                               atol=1e-9)
    u = out["u"].numpy()
    assert u.min() >= MPC_LIMITS[0] and u.max() <= MPC_LIMITS[1]
    assert np.isfinite(out["cost"].numpy()).all()


# ---- the streamed plain versions with limits and weights (no JAX) ----


@pytest.mark.parametrize("case", ["fddp_gn", "fddp_ddp", "exact"])
def test_streamed_references_with_box_weights_equal_whole(problem, case):
    """The streamed schedule (cost-only probes, one apply sweep) with
    per-scenario bounds and weights gives the whole-solve plain version's
    lanes bit for bit: a rebuilt candidate is the same clamped, weighted
    rollout."""
    _, (params, cost, trajs), bw = problem
    limits, w = _port_limits(bw)
    lanes = lambda a: a[:3]
    trajs = tree_map(lanes, trajs)
    limits = tuple(lanes(b) for b in limits)
    cost = _weighted(cost, lanes(w))
    opts = dataclasses.replace(P_OPTS, convergence_criteria=p_options.ConvergenceCriteria(
        1e-9, 1e-9, 2))
    if case == "exact":
        got = p_kstream.solve_streamed_reference(params, cost, trajs, DT, opts, limits=limits)
        ref = p_ksolve.solve_whole_reference(params, cost, trajs, DT, opts, limits)
        assert_identical(got, ref)
        assert bool((got[6] == got[2]).all())  # an apply sweep per executed trip
        return
    fo = p_fddp.FDDPOptions()
    ddp = case == "fddp_ddp"
    got = p_kstream_fddp.solve_fddp_streamed_reference(params, cost, trajs, DT, opts, fo, ddp,
                                                       limits=limits)
    ref = p_kfddp.solve_fddp_whole_reference(params, cost, trajs, DT, opts, fo, ddp,
                                             limits=limits)
    assert_identical(got, ref)
    for g, r in zip(got[4:7], ref[4:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# ---- the routes carry limits and weights to every launch ----


def _recorder(calls, name):
    def stub(params, cost, traj, dt_s, options, *args, **kwargs):
        calls.append((name, traj.controls.shape[1], kwargs.get("limits"), cost.stage_weights))
        lanes = traj.controls.shape[0]
        out = (traj, traj.controls[:, 0, 0], torch.full((lanes,), 2, dtype=torch.int32),
               torch.zeros(lanes, dtype=torch.int32))
        return out + (torch.zeros(lanes),) if kwargs.get("return_mu") else out
    return stub


@pytest.fixture
def calls(monkeypatch):
    calls = []
    for name in ("solve_fused_whole", "solve_fused_streamed", "solve_fddp_fused",
                 "solve_fddp_streamed"):
        monkeypatch.setattr(p_batched, name, _recorder(calls, name))
    return calls


def _stub_problem(n):
    params, cost, traj = np_problem("cpu", batch=2, n=n)
    return params, _weighted(cost, torch.ones(n, dtype=torch.float64)), traj


@pytest.mark.parametrize("n", [256, 257])
def test_latency_route_takes_limits_and_weights_past_256(calls, n):
    """solve_batch_latency with limits and weights: solve.cu's variants up
    to 256 stages, stream.cu's past them."""
    params, cost, traj = _stub_problem(n)
    p_batched.solve_batch_latency(params, cost, traj, DT, P_OPTS, limits=MPC_LIMITS)
    engine = "solve_fused_streamed" if n > 256 else "solve_fused_whole"
    assert [c[:3] for c in calls] == [(engine, n, MPC_LIMITS)] and calls[0][3] is not None


@pytest.mark.parametrize("n", [231, 232])
def test_fddp_routes_take_limits_and_weights_in_every_phase(calls, n):
    """solve_batch_fddp with limits and weights, single phase and
    refine="auto" (a Gauss-Newton launch, then an exact-DDP one resumed from
    it), and solve_batch_fddp_refine: every launch on the horizon's engine
    with the bounds and the weighted cost."""
    params, cost, traj = _stub_problem(n)
    opts = dataclasses.replace(P_OPTS, convergence_criteria=p_options.ConvergenceCriteria(
        1e-6, 1e-6, 12))
    p_batched.solve_batch_fddp(params, cost, traj, DT, opts, limits=MPC_LIMITS)
    p_batched.solve_batch_fddp(params, cost, traj, DT, opts, limits=MPC_LIMITS, refine="auto")
    p_batched.solve_batch_fddp_refine(params, cost, traj, DT, opts, phase1_iters=5,
                                      limits=MPC_LIMITS)
    engine = "solve_fddp_streamed" if n > 231 else "solve_fddp_fused"
    assert [c[:3] for c in calls] == [(engine, n, MPC_LIMITS)] * 4
    assert all(c[3] is not None for c in calls)
