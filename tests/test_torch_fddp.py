"""The port's robust FDDP slice against the JAX package, f64 on the CPU.

The curvature helpers (`*_t_jac`, `vfxx_analytic`, `exact_cxx_analytic`)
and `per_stage_costs` against the JAX functions at 1e-12; the port's batched
`solve_fddp` (the plain version of the FDDP kernel) against JAX's
`solve_fddp` on every lane of a mixed benign/aggressive problem, Gauss-Newton
and DDP, at the bar of tests/test_fddp_fused.py (status and iterations
equal, cost rtol 1e-8, controls atol 1e-9); the multi-phase solve by
composition (its first phase against JAX, its resume against the single
phase, its curvature schedule against JAX's `resolve_refine_auto`); the
streamed schedule's plain loop across a resume against JAX; the zero-probe
line search on the kernel wrapper; and the API's `solver="fddp"` routes. No
JAX call here runs in interpret mode.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.costs import quadratic as j_qc
from quadrotorilqr_tpu.costs.quadratic import QuadraticTrackingCost as JCost
from quadrotorilqr_tpu.lie import se3 as j_se3
from quadrotorilqr_tpu.lie import so3 as j_so3
from quadrotorilqr_tpu.models import quadrotor as j_qm
from quadrotorilqr_tpu.parallel.batch import initial_trajectory_from_state as j_initial
from quadrotorilqr_tpu.solver import ddp as j_ddp
from quadrotorilqr_tpu.solver.batched import resolve_refine_auto as j_resolve_refine_auto
from quadrotorilqr_tpu.solver.fddp import solve_fddp as j_solve_fddp
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.costs import quadratic as p_qc
from quadrotorilqr_tpu_torch.kernels import fddp as p_kfddp
from quadrotorilqr_tpu_torch.kernels import stream_fddp as p_kstream
from quadrotorilqr_tpu_torch.lie import se3 as p_se3
from quadrotorilqr_tpu_torch.lie import so3 as p_so3
from quadrotorilqr_tpu_torch.models import se3_wrench as p_wm
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import ddp as p_ddp
from quadrotorilqr_tpu_torch.solver import fddp as p_fddp
from quadrotorilqr_tpu_torch.solver import options as p_options
from quadrotorilqr_tpu_torch.tree import tree_map

from test_torch_kernels import assert_same_solution, port_objects
from test_torch_lie import close, rotation_vectors, tangents

B, N, DT, ITERS = 32, 10, 0.12, 25
LS, CC = (0.5, 0.5, 20), (1e-9, 1e-9, ITERS)
J_OPTS = ILQROptions(LineSearchParams(*LS), ConvergenceCriteria(*CC))
P_OPTS = p_options.ILQROptions(p_options.LineSearchParams(*LS), p_options.ConvergenceCriteria(*CC))


def mixed_problem(seed=0, batch=B, n=N, hard_scale=1.8):
    """tests/test_fddp_fused.py's mixed problem from numpy draws: even lanes
    benign (scale 0.4), odd lanes an aggressive tumble (scale 1.8)."""
    rng = np.random.default_rng(seed)
    f64 = jnp.float64
    params = j_qm.QuadrotorParams.create(
        1.0, jnp.asarray(np.diag([0.01, 0.012, 0.02]), f64), 0.17, 0.016, 9.81
    )
    scale = np.where(np.arange(batch) % 2 == 0, 0.4, hard_scale)[:, None]
    x0 = j_qm.State(
        pose=j_se3.exp(jnp.asarray(scale * rng.normal(size=(batch, 6)))),
        vel=jnp.asarray(scale * rng.normal(size=(batch, 6))),
    )
    hover = jnp.full((n, 4), 9.81 / 4.0, f64)
    desired = JTraj(
        times=DT * jnp.arange(n, dtype=f64),
        states=j_qm.State(pose=j_se3.identity((n,), f64), vel=jnp.zeros((n, 6), f64)),
        controls=hover,
    )
    cost = JCost(
        Q=jnp.diag(jnp.asarray([100.0] * 6 + [1.0] * 6, f64)),
        R=1e-3 * jnp.eye(4, dtype=f64),
        desired_states=desired.states,
        desired_controls=desired.controls,
    )
    return params, cost, j_initial(x0, desired)


def as_tuple(result):
    return (result.trajectory, result.cost, result.iterations, result.status)


def assert_lanes(got, ref):
    assert_same_solution(as_tuple(got), as_tuple(ref), rtol_cost=1e-8, atol_traj=1e-9)


@pytest.fixture(scope="module")
def problem():
    jobjs = mixed_problem()
    return jobjs, port_objects(jobjs)


@pytest.fixture(scope="module")
def jax_refs(problem):
    """solve_fddp on every lane of the mixed problem (XLA), by key: the
    Gauss-Newton (False) and exact-DDP (True) solves over ITERS trips and
    the Gauss-Newton solve at the multi-phase schedule's first budget
    ("first"), all three made on first use: `jax.lax.map` over the lanes,
    which computes each lane as jax.vmap(solve_fddp) does, without tracing
    the batching rule of its while loops (the larger part of the time),
    traced one by one and compiled side by side in threads at XLA's backend
    optimization level 0 without LLVM's expensive passes (IEEE float64 all
    the same, in less compile time)."""
    (params, cost, trajs), _ = problem
    first = ILQROptions(LineSearchParams(*LS), ConvergenceCriteria(
        *CC[:2], p_batched.resolve_refine_auto(ITERS, False)[0][0]))
    cache = {}

    def get(key):
        if not cache:
            cache.update(jax_lanes({
                k: functools.partial(j_solve_fddp, params, cost, dt_s=DT, options=o, ddp=d)
                for k, (o, d) in ((False, (J_OPTS, False)), (True, (J_OPTS, True)),
                                  ("first", (first, False)))
            }, trajs))
        return cache[key]

    return get


XLA_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_lanes(solves, trajs):
    """{key: solve(t) for every lane t of trajs} for a dict of solves:
    `jax.lax.map` over the lanes, each program traced in turn and compiled
    in a thread as soon as it is traced (beside the later traces), at XLA's
    backend optimization level 0 and without LLVM's expensive passes."""
    with concurrent.futures.ThreadPoolExecutor(len(solves)) as pool:
        futures = {k: pool.submit(jax.jit(lambda ts, f=f: jax.lax.map(f, ts)).lower(trajs).compile,
                                  XLA_FAST)
                   for k, f in solves.items()}
        return {k: f.result()(trajs) for k, f in futures.items()}


# ---- curvature helpers and per-stage costs ----


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
def test_so3_left_jacobian_t_jac(regime):
    theta = rotation_vectors(4, regime)
    w = np.random.default_rng(5).normal(size=(16, 3))
    close(
        p_so3.left_jacobian_t_jac(torch.tensor(theta), torch.tensor(w)),
        j_so3.left_jacobian_t_jac(jnp.asarray(theta), jnp.asarray(w)),
    )


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
@pytest.mark.parametrize("name", ["left_jacobian_t_jac", "right_jacobian_t_jac"])
def test_se3_t_jacs(regime, name):
    tau = tangents(6, regime)
    w = np.random.default_rng(7).normal(size=(16, 6))
    close(
        getattr(p_se3, name)(torch.tensor(tau), torch.tensor(w)),
        getattr(j_se3, name)(jnp.asarray(tau), jnp.asarray(w)),
    )


def test_vfxx_analytic_matches_jax():
    rng = np.random.default_rng(8)
    quat = rng.normal(size=(16, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    vel = 2.0 * rng.normal(size=(16, 6))
    v_x = rng.normal(size=(16, 12))
    inertia = np.diag([0.01, 0.012, 0.02]) + 0.001
    inv = np.linalg.inv(inertia)
    got = p_ddp.vfxx_analytic(
        0.1, *(torch.tensor(a) for a in (quat, vel)), torch.tensor(9.81, dtype=torch.float64),
        torch.tensor(inertia), torch.tensor(inv), torch.tensor(v_x),
    )
    ref = j_ddp.vfxx_analytic(0.1, *(jnp.asarray(a) for a in (quat, vel, 9.81, inertia, inv, v_x)))
    close(got, ref, tol=1e-12 * float(np.abs(np.asarray(ref)).max()))


def test_exact_cxx_and_per_stage_costs_match_jax(problem):
    (_, j_cost, j_trajs), (_, p_cost, p_trajs) = problem
    ref, ref_costs = jax.jit(lambda c, ts: (
        jax.vmap(lambda t: j_ddp.exact_cxx_analytic(c, t))(ts),
        j_qc.per_stage_costs(c, ts.states, ts.controls),
    )).lower(j_cost, j_trajs).compile(XLA_FAST)(j_cost, j_trajs)
    close(p_ddp.exact_cxx_analytic(p_cost, p_trajs), ref, tol=1e-12 * float(np.abs(ref).max()))
    ref = ref_costs
    got = p_qc.per_stage_costs(p_cost, p_trajs.states, p_trajs.controls)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


# ---- the plain FDDP loop against vmap(solve_fddp) ----


@pytest.fixture(scope="module")
def port_gn(problem):
    """The port's plain Gauss-Newton solve, shared by the route tests."""
    _, (params, cost, trajs) = problem
    return p_fddp.solve_fddp(params, cost, trajs, DT, P_OPTS)


@pytest.mark.parametrize("ddp", [False, True], ids=["gn", "ddp"])
def test_solve_fddp_matches_vmapped_jax(problem, jax_refs, port_gn, ddp):
    """Gauss-Newton at the bar of tests/test_fddp_fused.py. With ddp the
    port evaluates the same closed forms as JAX (per-stage gains agree to
    ~1e-14), but R = 1e-3 leaves the converged controls ~100x more weakly
    determined than the cost, so a lane's last step may move them by ~1e-7;
    status, iterations and cost stay equal. The JAX package holds its own
    DDP engines to 1e-4 on controls (tests/test_fddp_fused.py:382-416)."""
    _, (params, cost, trajs) = problem
    ref = jax_refs(ddp)
    got = p_fddp.solve_fddp(params, cost, trajs, DT, P_OPTS, ddp=True) if ddp else port_gn
    assert_same_solution(
        as_tuple(got), as_tuple(ref), rtol_cost=1e-8, atol_traj=1e-6 if ddp else 1e-9
    )
    # the workload exercises the robust machinery: lanes converge, others
    # burn retries, so iterations spread
    status = np.asarray(ref.status)
    assert (status == 1).sum() > B // 4
    assert int(np.max(ref.iterations)) > int(np.min(ref.iterations))


def test_fused_wrapper_runs_the_plain_loop_on_cpu(problem, port_gn):
    """On CPU tensors `solve_fddp_fused` is the plain loop: the same lanes,
    with mu, the probe sweeps (one full sweep per first probe, a part of
    one per later probe, so at least one per trip) and the trips that
    computed defects (the first and each after an accept: a retry reuses
    them; the zero-probe test below has only retries)."""
    _, (params, cost, trajs) = problem
    traj, cost_v, iters, status, mu, probes, defect_trips = p_kfddp.solve_fddp_fused(
        params, cost, trajs, DT, P_OPTS, return_mu=True, return_probes=True
    )
    for g, r in zip((cost_v, iters, status, traj.controls),
                    (port_gn.cost, port_gn.iterations, port_gn.status, port_gn.trajectory.controls)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert bool((probes >= iters.double()).all()) and bool((probes > iters.double()).any())
    assert bool((mu >= 0).all())
    assert bool(((defect_trips >= 1) & (defect_trips <= iters)).all())


def test_zero_probe_line_search_runs_on_the_fddp_wrapper(problem, monkeypatch):
    """With no line-search probes `solve_batch_fddp` still goes through the
    kernel wrapper (which on the CPU runs its plain version): every trip
    rejects, so only the mu schedule runs, and a lane keeps its trajectory
    and its cost."""
    _, (params, cost, trajs) = problem
    iters = 4
    opts = p_options.ILQROptions(
        p_options.LineSearchParams(0.5, 0.5, 0), p_options.ConvergenceCriteria(1e-9, 1e-9, iters)
    )
    wrapper = p_batched.solve_fddp_fused
    seen = []

    def spy(*args, **kwargs):
        seen.append(True)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(p_batched, "solve_fddp_fused", spy)
    got = p_batched.solve_batch_fddp(params, cost, trajs, DT, opts)
    assert seen == [True]
    assert got.status.eq(0).all() and got.iterations.eq(iters).all()
    torch.testing.assert_close(got.trajectory.controls, trajs.controls, rtol=0, atol=0)
    torch.testing.assert_close(
        got.cost, p_fddp.sequential_cost(p_qc.per_stage_costs(cost, trajs.states, trajs.controls)),
        rtol=0, atol=0,
    )
    _, _, _, _, mu, probes, defect_trips = wrapper(
        params, cost, trajs, DT, opts, return_mu=True, return_probes=True
    )
    fo = p_fddp.FDDPOptions()
    torch.testing.assert_close(mu, torch.full_like(mu, fo.reg_init * fo.reg_scale_up ** (iters - 1)))
    assert probes.eq(0).all() and defect_trips.eq(1).all()


# ---- the streamed schedule's plain version ----


def test_streamed_reference_matches_vmapped_jax_across_a_resume(problem, jax_refs, port_gn):
    """The streamed schedule's plain loop (cost-only probes, one apply
    rollout per accepted trip) in two calls, the second resumed from the
    first's mu, status and iterations: lane for lane vmap(solve_fddp) at
    this file's Gauss-Newton tolerances, and bit for bit the whole loop in
    one call (tests/test_torch_stream.py holds one streamed call to the
    whole loop, exact DDP included)."""
    _, (params, cost, trajs) = problem
    first = p_kstream.solve_fddp_streamed(
        params, cost, trajs, DT, p_batched._with_max_iters(P_OPTS, 7), return_mu=True
    )
    assert bool(first[3].eq(0).any()) and bool(first[3].ne(0).any())
    rest = p_kstream.solve_fddp_streamed(
        params, cost, first[0], DT, p_batched._with_max_iters(P_OPTS, ITERS - 7),
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2], return_probes=True,
    )
    assert_same_solution(rest[:4], as_tuple(jax_refs(False)), rtol_cost=1e-8, atol_traj=1e-9)
    for g, r in zip(rest[1:4], as_tuple(port_gn)[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(rest[0].controls, port_gn.trajectory.controls, rtol=0, atol=0)
    # an apply sweep for each accepted trip of the second call
    assert bool((rest[6] <= rest[2] - first[2]).all()) and bool((rest[6] >= 1).any())


# ---- the multi-phase solve, by composition ----


def test_refine_first_phase_matches_jax(problem, jax_refs):
    """A fresh solve at the first phase's budget (what the multi-phase solve
    runs as its first phase) equals JAX's solve_fddp at that max_iters on
    every lane."""
    (j_params, j_cost, j_trajs), (params, cost, trajs) = problem
    bounds, _ = p_batched.resolve_refine_auto(ITERS, False)
    cc = (1e-9, 1e-9, bounds[0])
    ref = jax_refs("first")
    opts = dataclasses.replace(P_OPTS, convergence_criteria=p_options.ConvergenceCriteria(*cc))
    assert_lanes(p_batched.solve_batch_fddp(params, cost, trajs, DT, opts), ref)


def test_refine_resume_equals_single_phase(problem, port_gn):
    """Two phases with one curvature equal one phase lane for lane: the
    wrapper's resume rows carry mu, status and iterations across the
    boundary, as the multi-phase solve hands them on."""
    _, (params, cost, trajs) = problem
    first = p_kfddp.solve_fddp_fused(
        params, cost, trajs, DT, p_batched._with_max_iters(P_OPTS, 7), return_mu=True
    )
    assert bool(first[3].eq(0).any()) and bool(first[3].ne(0).any())
    traj, cost_v, iters, status = p_kfddp.solve_fddp_fused(
        params, cost, first[0], DT, p_batched._with_max_iters(P_OPTS, ITERS - 7),
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
    )
    for g, r in zip((cost_v, iters, status), as_tuple(port_gn)[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(traj.controls, port_gn.trajectory.controls, rtol=0, atol=0)


@pytest.mark.parametrize("budget", [10, 25, 40])
def test_hybrid_refine_follows_the_auto_schedule(problem, budget, monkeypatch):
    """refine="auto" follows resolve_refine_auto's schedule (checked against
    JAX's): one kernel call for the Gauss-Newton phases up to the switch,
    one for the exact-DDP phases after it, the resume rows handed on with
    the lanes in place; with ddp=True the whole budget is one call."""
    _, (params, cost, trajs) = problem
    bounds, flags = j_resolve_refine_auto(budget, False)
    assert p_batched.resolve_refine_auto(budget, False) == (bounds, flags)
    assert p_batched.resolve_refine_auto(budget, True) == j_resolve_refine_auto(budget, True)
    calls = []

    def phase(params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status,
              initial_iters, return_mu, limits):
        assert limits is None
        budget_k = options.convergence_criteria.max_iters
        calls.append((budget_k, ddp, initial_status is None))
        lanes = traj.controls.shape[0]
        iters = (0 if initial_iters is None else initial_iters) + torch.full((lanes,), budget_k)
        # lane 2k finishes in the first phase; the others stay pending
        status = torch.zeros(lanes, dtype=torch.int32)
        if initial_status is None:
            status[::2] = 1
        else:
            status = initial_status
        return traj, traj.controls[:, 0, 0], iters.to(torch.int32), status, torch.zeros(lanes)

    monkeypatch.setattr(p_batched, "solve_fddp_fused", phase)
    got = p_batched.solve_batch_fddp(params, cost, trajs, DT, dataclasses.replace(
        P_OPTS, convergence_criteria=p_options.ConvergenceCriteria(1e-9, 1e-9, budget)
    ), refine="auto")
    switch = ((0,) + bounds)[flags.index(True)]
    assert flags[0] is False and flags[-1] is True and all(flags[flags.index(True):])
    assert switch == round(0.4 * budget)
    assert calls == [(switch, False, True), (budget - switch, True, False)]
    torch.testing.assert_close(got.cost, trajs.controls[:, 0, 0], rtol=0, atol=0)
    assert got.status[::2].eq(1).all() and got.status[1::2].eq(0).all()
    assert got.iterations.eq(budget).all()
    calls.clear()
    p_batched.solve_batch_fddp(params, cost, trajs, DT, dataclasses.replace(
        P_OPTS, convergence_criteria=p_options.ConvergenceCriteria(1e-9, 1e-9, budget)
    ), ddp=True, refine="auto")
    assert calls == [(budget, True, True)]


# ---- the API routes ----


def _api(dtype, solver="fddp"):
    _, j_cost, _ = mixed_problem(batch=2)
    desired = convert.trajectory_from_numpy(
        JTraj(
            times=np.arange(N) * DT,
            states=jax.tree.map(np.asarray, j_cost.desired_states),
            controls=np.asarray(j_cost.desired_controls),
        )
    )
    return QuadrotorILQR(
        1.0, np.diag([0.01, 0.012, 0.02]), 0.17, 0.016, 9.81,
        np.diag([100.0] * 6 + [1.0] * 6), 1e-3 * np.eye(4), desired, DT, P_OPTS,
        dtype=dtype, device="cpu", solver=solver,
    )


def test_api_f64_batch_route_matches_jax(problem, jax_refs):
    """The f64 `solve_batch` route is the single-phase kernel, lane for lane
    JAX's f64 route, vmap(solve_fddp)."""
    _, (_, _, trajs) = problem
    assert_lanes(_api(torch.float64).solve_batch(trajs), jax_refs(False))


@pytest.mark.parametrize("solver", ["fddp", "fddp-ddp"])
def test_api_f32_batch_route_is_refine_auto(problem, solver, monkeypatch):
    seen = {}

    def spy(params, cost, trajs, dt_s, options, **kwargs):
        seen.update(kwargs, dtype=trajs.controls.dtype)
        return "routed"

    monkeypatch.setattr("quadrotorilqr_tpu_torch.api.solve_batch_fddp", spy)
    _, (_, _, trajs) = problem
    assert _api(torch.float32, solver).solve_batch(trajs) == "routed"
    assert seen["refine"] == "auto" and seen["ddp"] == (solver == "fddp-ddp")
    assert seen["dtype"] == torch.float32


@pytest.mark.parametrize("solver", ["fddp", "fddp-ddp"])
def test_api_solve_pytree_runs_plain_fddp(problem, jax_refs, solver):
    """One trajectory through the plain FDDP loop, curvature by solver."""
    ref = jax_refs(solver == "fddp-ddp")
    _, (_, _, trajs) = problem
    api = _api(torch.float64, solver)
    lane = 1 if solver == "fddp" else 0  # a tumble, a benign start
    got = api.solve_pytree(tree_map(lambda a: a[lane], trajs))
    assert int(got.status) == int(ref.status[lane])
    assert int(got.iterations) == int(ref.iterations[lane])
    np.testing.assert_allclose(float(got.cost), float(ref.cost[lane]), rtol=1e-8)


@pytest.mark.parametrize(
    "kwargs",
    [dict(model=object()), dict(penalty_fns=(None, None), model=p_wm)],
    ids=["model", "penalty"],
)
def test_solve_fddp_refuses_options_outside_the_slice(problem, kwargs):
    """Other model families stay refused, naming their ROADMAP items, with
    the augmented-Lagrangian penalty too (limits, stage weights and the
    quadrotor's penalty are ported: tests/test_torch_variants.py,
    tests/test_torch_auglag.py)."""
    _, (params, cost, trajs) = problem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p_fddp.solve_fddp(params, cost, trajs, DT, P_OPTS, **kwargs)
