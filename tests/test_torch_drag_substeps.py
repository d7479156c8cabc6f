"""The port's drag quadrotor and substepped integration against the JAX package, f64 on the CPU.

`models/quadrotor_drag.py` (its four dynamics functions, the zero-drag
reduction to the quadrotor), `models/integrators.py` (`substepped` and
`rk4`: discrete dynamics and Jacobians), the kernels' lane operands
(`kernels/models.py` DRAG_QUADROTOR and `substepped_lane_model` against JAX
`_drag_quadrotor_prep_params` and the substepped prep at dt / k), the plain
batch solve on the drag family (shared and per-scenario coefficients) and on
`substepped(quadrotor, k)` for k = 2 and 4, the dense chained control
Jacobian the substepped kernels contract over all 12 rows, convert.py's
round trip, and the requests the kernels refuse. Inputs are made with
numpy from a seed. JAX's solver reference is its XLA `solve(model=...)`
lane by lane (`jax.lax.map`; the JAX package holds its interpret-mode
kernels equal to it lane for lane, tests/test_quadrotor_drag.py:181-211,
tests/test_integrators.py:315-369), one program per model, compiled at
XLA's backend optimization level 0 side by side in threads. Tolerances:
dynamics and Jacobians atol 1e-12; the zero-drag reduction and the lane
operands exact; the solves the bars of those two JAX tests (statuses and
iterations equal, cost rtol 1e-9, controls atol 1e-7).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.kernels import models as j_lm
from quadrotorilqr_tpu.models import integrators as j_int
from quadrotorilqr_tpu.models import quadrotor as j_qm
from quadrotorilqr_tpu.models import quadrotor_drag as j_qd
from quadrotorilqr_tpu.solver import ilqr as j_ilqr
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.kernels import backward as p_kb
from quadrotorilqr_tpu_torch.kernels import models as p_lm
from quadrotorilqr_tpu_torch.kernels import solve as p_ks
from quadrotorilqr_tpu_torch.models import integrators as p_int
from quadrotorilqr_tpu_torch.models import quadrotor as p_qm
from quadrotorilqr_tpu_torch.models import quadrotor_drag as p_qd
from quadrotorilqr_tpu_torch.models import se3_wrench as p_wm
from quadrotorilqr_tpu_torch.models.quadrotor_drag import DragQuadrotorParams
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import ilqr as p_ilqr
from quadrotorilqr_tpu_torch.tree import tree_map

from test_torch_kernels import DT
from test_torch_models import (
    J_OPTS,
    P_OPTS,
    _compiled,
    both_states,
    close,
    j_problem,
    np_params,
    p_params,
    p_problem,
)

B, N = 8, 10
SUBSTEPS = (2, 4)
DRAG_LIN, DRAG_ANG = (0.3, 0.35, 0.5), (0.02, 0.02, 0.04)


def np_drag_params(batch=None, seed=0, zero=False):
    """The quadrotor's params of `np_params` with body drag: the
    coefficients of tests/test_quadrotor_drag.py:36, or per scenario each
    scaled by a factor drawn from [0.5, 1.5]."""
    d = np_params("quadrotor", batch=batch, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lin, ang = np.asarray(DRAG_LIN), np.asarray(DRAG_ANG)
    if batch is not None:
        lin = lin * (0.5 + rng.uniform(size=(batch, 3)))
        ang = ang * (0.5 + rng.uniform(size=(batch, 3)))
    scale = 0.0 if zero else 1.0
    return dict(d, drag_lin=scale * lin, drag_ang=scale * ang)


def j_drag(d):
    return j_qd.DragQuadrotorParams(**{k: jnp.asarray(v) for k, v in d.items()})


def j_quad(d):
    return j_qm.QuadrotorParams(**{k: jnp.asarray(v) for k, v in d.items()})


def np_solve_problem(seed):
    """A hover problem of the quadrotor (u = 4): random stages around the
    hover control, Q = diag(100 1_6, 1_6), R = I_4 + 0.1."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((B, N, 1)), 0.3 * rng.normal(size=(B, N, 3))], -1)
    des_q = np.zeros((N, 4))
    des_q[:, 0] = 1.0
    hover = np.full(4, 1.3 * 9.81 / 4)
    return dict(
        quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        trans=0.4 * rng.normal(size=(B, N, 3)), vel=0.2 * rng.normal(size=(B, N, 6)),
        controls=hover + 0.5 * rng.normal(size=(B, N, 4)),
        times=np.broadcast_to(np.arange(N) * DT, (B, N)),
        des_quat=des_q, des_trans=np.zeros((N, 3)), des_vel=np.zeros((N, 6)),
        des_controls=np.tile(hover, (N, 1)),
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(4) + 0.1 * np.ones((4, 4)),
    )


PORT_MODELS = {"drag": p_qd, **{f"sub{k}": p_int.substepped(p_qm, k) for k in SUBSTEPS}}
JAX_MODELS = {"drag": j_qd, **{f"sub{k}": j_int.substepped(j_qm, k) for k in SUBSTEPS}}
WRAPPED = {"sub3_drag": (p_int.substepped(p_qd, 3), j_int.substepped(j_qd, 3)),
           "rk4": (p_int.rk4(p_qm), j_int.rk4(j_qm))}


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of the module: one solve program per model (lane
    by lane over per-lane params: shared params broadcast, so that the
    program serves both cases), one for rk4 and one for the drag dynamics,
    the substepped drag step and the lane preps, the longest to compile
    traced first, each compiled in a thread once traced."""
    _, j_x, u = both_states(7)
    u4 = jnp.asarray(u[:, :4])
    fixed = dict(
        drag=j_drag(np_drag_params(batch=5, seed=1)), quad=j_quad(np_params("quadrotor", seed=1)),
        drag_shared=j_drag(np_drag_params(seed=1)),
        x=j_x, u=u4,
        prep_shared=j_drag(np_drag_params(seed=5)), prep_per=j_drag(np_drag_params(batch=B, seed=5)),
        prep_quad=j_quad(np_params("quadrotor", batch=B, seed=5)),
    )

    def wrapped_ref(name, f):
        jm = WRAPPED[name][1]
        jp = f["drag_shared"] if name.endswith("drag") else f["quad"]
        x, u = f["x"], f["u"]
        if name == "rk4":  # one state: JAX's rk4 Jacobians trace a vmap a batch dim
            x, u = jax.tree.map(lambda a: a[0], (x, u))
        return jm.discrete_dynamics(jp, x, u, DT), jm.discrete_dynamics_jacobians(jp, x, u, DT)

    def fixed_refs(f):
        return dict(
            drag=(j_qd.continuous_dynamics(f["drag"], f["x"], f["u"]),
                  j_qd.continuous_dynamics_jacobians(f["drag"], f["x"], f["u"]),
                  j_qd.discrete_dynamics(f["drag"], f["x"], f["u"], DT),
                  j_qd.discrete_dynamics_jacobians(f["drag"], f["x"], f["u"], DT)),
            sub3_drag=wrapped_ref("sub3_drag", f),
            prep={"shared": j_lm._drag_quadrotor_prep_params(f["prep_shared"], DT, jnp.float64),
                  "per_scenario": j_lm._drag_quadrotor_prep_params(f["prep_per"], DT, jnp.float64),
                  **{f"sub{k}": j_lm.substepped_lane_model(j_lm.QUADROTOR, k).prep_params(
                      f["prep_quad"], DT, jnp.float64) for k in SUBSTEPS}},
        )

    def solve_refs(jp, cost, traj, model):
        return jax.lax.map(
            lambda a: j_ilqr.solve(a[0], cost, a[1], DT, J_OPTS, model=model), (jp, traj))

    d = np_solve_problem(11)
    cost, traj = j_problem(d)
    pds = {"drag": {False: np_drag_params(batch=B, seed=13)}}
    pds["drag"][True] = {k: np.broadcast_to(np.asarray(np_drag_params(seed=13)[k]),
                                            v.shape).copy() for k, v in pds["drag"][False].items()}
    for k in SUBSTEPS:
        quad = np_params("quadrotor", batch=B, seed=13)
        pds[f"sub{k}"] = {False: quad}
    programs = {"rk4": (functools.partial(wrapped_ref, "rk4"), (fixed,))}
    for name in ("sub4", "sub2", "drag"):
        jp = (j_drag if name == "drag" else j_quad)(pds[name][False])
        programs[name] = (functools.partial(solve_refs, model=JAX_MODELS[name]), (jp, cost, traj))
    programs["fixed"] = (fixed_refs, (fixed,))
    run = _compiled(programs)
    out = dict(run["fixed"](fixed))
    out["wrapped"] = {"rk4": run["rk4"](fixed), "sub3_drag": out.pop("sub3_drag")}
    out["solve"] = {}
    for name in JAX_MODELS:
        for shared, pd in pds[name].items():
            jp = (j_drag if name == "drag" else j_quad)(pd)
            out["solve"][name, shared] = (d, pd, run[name](jp, cost, traj))
    return out


# ---- the drag model ----


def test_drag_dynamics_and_jacobians_match_jax(jax_refs):
    """continuous and discrete dynamics and their analytic Jacobians, on
    per-scenario params."""
    pp = convert.params_from_numpy(type("P", (), np_drag_params(batch=5, seed=1)), torch.float64)
    assert isinstance(pp, DragQuadrotorParams) and pp.batched
    p_x, _, u = both_states(7)
    u4 = torch.tensor(u[:, :4])
    (j_xdot, (_, j_jx, j_ju), j_next, (_, j_djx, j_dju)) = jax_refs["drag"]
    xdot, jx, ju = p_qd.continuous_dynamics_jacobians(pp, p_x, u4)
    nxt, djx, dju = p_qd.discrete_dynamics_jacobians(pp, p_x, u4, DT)
    plain_next = p_qd.discrete_dynamics(pp, p_x, u4, DT)
    for got, r in ((p_qd.continuous_dynamics(pp, p_x, u4), j_xdot), (xdot, j_xdot), (jx, j_jx),
                   (ju, j_ju), (djx, j_djx), (dju, j_dju),
                   (plain_next.pose.quat, j_next.pose.quat), (plain_next.vel, j_next.vel),
                   (nxt.pose.trans, j_next.pose.trans)):
        close(got, r, atol=1e-12)


def test_zero_drag_reduces_to_the_quadrotor_exactly():
    """With zero coefficients the drag model is the quadrotor, bit for bit
    (dynamics, both Jacobians, the hoisted step), and its lane operands are
    the quadrotor's with zero drag columns."""
    pp = convert.params_from_numpy(type("P", (), np_drag_params(batch=5, seed=2, zero=True)),
                                   torch.float64)
    qp = pp.dragless()
    p_x, _, u = both_states(8)
    u4 = torch.tensor(u[:, :4])
    assert torch.equal(p_qd.continuous_dynamics(pp, p_x, u4), p_qm.continuous_dynamics(qp, p_x, u4))
    for a, b in zip(p_qd.discrete_dynamics_jacobians(pp, p_x, u4, DT)[1:],
                    p_qm.discrete_dynamics_jacobians(qp, p_x, u4, DT)[1:]):
        assert torch.equal(a + 0.0, b + 0.0)
    a, b = p_qd.dynamics_step(pp, DT)(p_x, u4), p_qm.dynamics_step(qp, DT)(p_x, u4)
    assert torch.equal(a.vel, b.vel) and torch.equal(a.pose.quat, b.pose.quat)
    cpu = torch.device("cpu")
    got = p_lm.DRAG_QUADROTOR.prep(pp, DT, torch.float64, cpu)
    ref = p_lm.QUADROTOR.prep(qp, DT, torch.float64, cpu)
    assert torch.equal(got[3][:, :4], ref[3]) and not bool(got[3][:, 4:].any())
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got[:-1], ref[:-1])) if i != 3)


# ---- substepped and rk4 ----


@pytest.mark.parametrize("name", list(WRAPPED))
def test_wrapped_dynamics_and_jacobians_match_jax(jax_refs, name):
    """substepped(model, k) and rk4(model): the discrete step and its
    Jacobians (the chain rule, forward-mode derivatives of the lifted RK4
    step) against JAX's, with shared params (rk4 on one state)."""
    pm, _ = WRAPPED[name]
    d = np_drag_params(seed=1) if name.endswith("drag") else np_params("quadrotor", seed=1)
    pp = convert.params_from_numpy(type("P", (), d), torch.float64)
    p_x, _, u = both_states(7)
    u4 = torch.tensor(u[:, :4])
    if name == "rk4":  # JAX's reference holds the first state
        p_x, u4 = tree_map(lambda a: a[0], p_x), u4[0]
    j_next, (j_nxt2, j_jx, j_ju) = jax_refs["wrapped"][name]
    nxt = pm.discrete_dynamics(pp, p_x, u4, DT)
    nxt2, jx, ju = pm.discrete_dynamics_jacobians(pp, p_x, u4, DT)
    for got, r in ((nxt.pose.quat, j_next.pose.quat), (nxt.pose.trans, j_next.pose.trans),
                   (nxt.vel, j_next.vel), (nxt2.vel, j_nxt2.vel), (jx, j_jx), (ju, j_ju)):
        close(got, r, atol=1e-12)
    kind = name.split("_")[0]
    assert pm.__name__ == pm.base.__name__ + ("_rk4" if kind == "rk4" else f"_sub{kind[3:]}")


def test_substepped_control_jacobian_is_dense():
    """From the second substep on the chain couples the velocity rows of j_u
    into the pose rows: rows 0:8 are nonzero, where one step's j_u is
    structurally zero (ju_lo = 8). The kernels therefore contract the chained
    j_u over all 12 rows, while the lane model keeps the per-substep j_u
    and its ju_lo."""
    pp = p_params(np_params("quadrotor", seed=3))
    p_x, _, u = both_states(9)
    u4 = torch.tensor(u[:, :4])
    one = p_qm.discrete_dynamics_jacobians(pp, p_x, u4, DT)[2]
    assert not bool(one[..., 0:8, :].any())
    for k in SUBSTEPS:
        ju = p_int.substepped(p_qm, k).discrete_dynamics_jacobians(pp, p_x, u4, DT)[2]
        assert float(ju[..., 0:8, :].abs().min(-1).values.max()) > 1e-6 * float(ju.abs().max())
        lm = p_lm.lane_model_for(pp, p_int.substepped(p_qm, k))
        assert (lm.ju_lo, lm.substeps, lm.base, lm.suffix) == (8, k, p_lm.QUADROTOR, "_sub")
    assert p_lm.lane_model_for(pp, p_int.substepped(p_qm, 1)) is p_lm.QUADROTOR


# ---- the kernels' lane operands ----


@pytest.mark.parametrize("case", ["shared", "per_scenario", "sub2", "sub4"])
def test_kernel_preps_match_jax(jax_refs, case):
    """The six lane operands of the drag quadrotor (extra = [I^-1 MA |
    drag_lin / m | drag_ang]) and of the substepped quadrotor (its prep at
    dt / k) against JAX's: the drag columns exactly, the quadrotor's
    operands at the bar of their own test (tests/test_torch_models.py: rtol
    1e-13; the two preps round I^-1 apart); JAX's shared operands are
    broadcast tiles, whose first lane is the port's one."""
    shared = case == "shared"
    if case.startswith("sub"):
        k = int(case[3:])
        pp = p_params(np_params("quadrotor", batch=B, seed=5))
        lm = p_lm.lane_model_for(pp, p_int.substepped(p_qm, k))
    else:
        pp = convert.params_from_numpy(
            type("P", (), np_drag_params(batch=None if shared else B, seed=5)), torch.float64)
        lm = p_lm.lane_model_for(pp)
        assert lm is p_lm.DRAG_QUADROTOR and lm.suffix == "_drag"
    got = lm.prep(pp, DT, torch.float64, torch.device("cpu"))
    ref = jax_refs["prep"][case]
    assert got[-1] == (not shared)
    for i, (g, r) in enumerate(zip(got[:-1], ref[:-1])):
        r = np.asarray(r)
        r = (r[..., :1] if shared else r).reshape(g.shape)
        close(g, r, rtol=1e-13, atol=1e-15)
        if i == 3 and not case.startswith("sub"):
            np.testing.assert_array_equal(g[:, 4:].numpy(), r[:, 4:])


# ---- the plain batch solve against JAX's XLA solve ----


@pytest.mark.parametrize("name,shared", [("drag", True), ("drag", False), ("sub2", False),
                                         ("sub4", False)],
                         ids=["drag-shared", "drag-per_scenario", "sub2", "sub4"])
def test_solve_matches_jax(jax_refs, name, shared):
    """The batch solver's plain loop (both exact routes on the CPU) on the
    drag family (shared and per-scenario coefficients) and on
    substepped(quadrotor, k) (per-scenario params) against JAX's
    solve(model=...), lane for lane."""
    d, pd, ref = jax_refs["solve"][name, shared]
    cost, traj = p_problem(d)
    pdata = {k: v[0] for k, v in pd.items()} if shared else pd
    pp = convert.params_from_numpy(type("P", (), pdata), torch.float64)
    model = None if name == "drag" else PORT_MODELS[name]
    got = p_batched.solve_batch_latency(pp, cost, traj, DT, P_OPTS, model=model)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    close(got.cost, ref.cost, rtol=1e-9)
    close(got.trajectory.controls, ref.trajectory.controls, atol=1e-7)
    if name == "sub2":
        fused = p_batched.solve_batch_fused(pp, cost, traj, DT, P_OPTS, model=model)
        assert torch.equal(fused.cost, got.cost)
        assert torch.equal(fused.trajectory.controls, got.trajectory.controls)


def test_drag_workload_per_scenario():
    """workloads.drag_problem: the bench workload's task on the drag
    quadrotor, every leaf per scenario with `per_scenario`, each lane's
    coefficients the shared ones scaled into [0.5, 1.5]; both exact routes
    (their plain versions on the CPU) solve it alike."""
    from quadrotorilqr_tpu_torch.app import workloads

    gen = torch.Generator().manual_seed(3)
    params, cost, trajs = workloads.drag_problem(gen, 4, 5, dtype=torch.float64,
                                                 per_scenario=True)
    assert isinstance(params, DragQuadrotorParams) and params.batched
    assert params.inertia.shape == (4, 3, 3) and params.drag_lin.shape == (4, 3)
    scale = params.drag_lin / torch.tensor(workloads.DRAG_LIN, dtype=torch.float64)
    assert bool(((scale >= 0.5) & (scale <= 1.5)).all()) and len(set(scale[:, 0].tolist())) == 4
    a = p_batched.solve_batch_latency(params, cost, trajs, 0.02, workloads.BENCH_OPTIONS)
    b = p_batched.solve_batch_fused(params, cost, trajs, 0.02, workloads.BENCH_OPTIONS)
    assert torch.equal(a.cost, b.cost) and bool((a.status == p_ilqr.STATUS_CONVERGED).all())


def test_rk4_runs_on_the_plain_loop_only():
    """rk4 has no lane model: the batch routes raise TypeError (as JAX's
    `lane_model_for`) and never fall back; `solver.ilqr.solve` takes it."""
    cost, traj = p_problem(np_solve_problem(17))
    pp = p_params(np_params("quadrotor", seed=3))
    model = p_int.rk4(p_qm)
    for route in (p_batched.solve_batch_latency, p_batched.solve_batch_fused):
        with pytest.raises(TypeError, match="no lane model"):
            route(pp, cost, traj, DT, P_OPTS, model=model)
    one = tree_map(lambda a: a[:1, :3], traj)
    short = dataclasses.replace(
        cost, desired_states=tree_map(lambda a: a[:3], cost.desired_states),
        desired_controls=cost.desired_controls[:3])
    opts = dataclasses.replace(P_OPTS, convergence_criteria=dataclasses.replace(
        P_OPTS.convergence_criteria, max_iters=2))
    res = p_ilqr.solve(pp, short, one, DT, opts, model=model)
    assert bool(torch.isfinite(res.cost).all()) and res.trajectory.controls.shape == (1, 3, 4)
    assert int(res.iterations[0]) == 2


# ---- refusals ----


@pytest.mark.parametrize("request_", ["fddp_drag", "fddp_sub", "limits", "weights", "history",
                                      "populate_debug", "penalty", "sub_wrench", "sub9"])
def test_kernels_refuse_what_they_lack(request_):
    """On the card the drag and substepped kernels take no limits, weights,
    debug record or penalty (ROADMAP Queue 1 item 11c), the FDDP solvers no
    drag or substeps (11b), and no kernel substeps the wrench or takes more
    than 8 substeps (11a): each raises NotImplementedError naming its item,
    on the host side before any launch (the card stood in for by the meta
    device where the route checks the device)."""
    cost, traj = p_problem(np_solve_problem(19))
    drag = convert.params_from_numpy(type("P", (), np_drag_params(seed=3)), torch.float64)
    quad = p_params(np_params("quadrotor", seed=3))
    sub2 = p_int.substepped(p_qm, 2)
    cpu, f64 = torch.device("cpu"), torch.float64
    item = {"fddp_drag": "11b", "fddp_sub": "11b", "sub_wrench": "11a", "sub9": "11a"}.get(
        request_, "11c")
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        if request_ == "fddp_drag":
            p_batched.solve_batch_fddp(drag, cost, traj, DT, P_OPTS)
        elif request_ == "fddp_sub":
            p_batched.solve_batch_fddp(quad, cost, traj, DT, P_OPTS, model=sub2)
        elif request_ == "limits":
            p_kb._problem_operands(drag, cost, B, N, DT, f64, cpu, (0.0, 20.0))
        elif request_ == "weights":
            w_cost = dataclasses.replace(cost, stage_weights=torch.ones(N, dtype=f64))
            p_kb._problem_operands(quad, w_cost, B, N, DT, f64, cpu, None, sub2)
        elif request_ == "history":
            p_ks._launch(drag, cost, traj, DT, P_OPTS, True, False)
        elif request_ == "populate_debug":
            meta = tree_map(lambda a: a.to("meta"), traj)
            opts = dataclasses.replace(P_OPTS, populate_debug=True)
            p_batched.solve_batch_latency(quad, cost, meta, DT, opts, model=sub2)
        elif request_ == "penalty":
            ops = p_kb._problem_operands(drag, cost, B, N, DT, f64, cpu)
            p_kb._check_penalty(ops, torch.zeros((N, B, 224), dtype=f64), B, N, f64)
        elif request_ == "sub_wrench":
            wp = p_params(np_params("wrench"))
            p_kb._problem_operands(wp, cost, B, N, DT, f64, cpu, None,
                                   p_int.substepped(p_wm, 2))
        else:
            p_kb._problem_operands(quad, cost, B, N, DT, f64, cpu, None,
                                   p_int.substepped(p_qm, 9))
    # the kernels' k rides after the variant ints, dt / k is the kernels' dt
    ops = p_kb._problem_operands(quad, cost, B, N, DT, f64, cpu, None, p_int.substepped(p_qm, 4))
    assert ops.entry("solve") == "qilqr_solve_sub" and ops.variant[2] == [0, 0, 4]
    assert ops.reals == [DT / 4] and ops.key == "_sub"


def test_convert_round_trips_drag_params():
    """JAX's DragQuadrotorParams as numpy -> the port's -> numpy, unchanged;
    `dragless` keeps the rigid body."""
    jp = jax.tree.map(np.asarray, j_drag(np_drag_params(batch=3, seed=29)))
    pp = convert.params_from_numpy(jp, torch.float64)
    assert type(pp).__name__ == "DragQuadrotorParams"
    back = convert.to_numpy(pp)
    for f in dataclasses.fields(pp):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(jp, f.name))
    assert torch.equal(pp.dragless().inertia, pp.inertia)
    assert torch.equal(p_qm.moment_arms(pp), p_qm.moment_arms(pp.dragless()))
