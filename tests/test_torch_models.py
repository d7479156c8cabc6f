"""The port's wider-control model families against the JAX package, f64 on the CPU.

The SE(3) body wrench (u = 6) and the R-rotor multirotor (u = R): their
dynamics and analytic Jacobians, the wrench's reduction to the quadrotor
(`wrench_from_rotors`) and the 4-rotor multirotor's, the kernels' lane
operands (`kernels/models.py` against JAX `_wrench_prep_params` /
`_multirotor_prep_params`), the plain backward pass and rollout at u = 6,
both exact batch routes (on the CPU their plain versions) with shared and
per-scenario params, the route point to the streamed kernel per control
width, the requests the families' kernels refuse, and convert.py's round
trips. Inputs are made with numpy from a seed. JAX's solver reference is
`solver.ilqr.solve(model=...)` lane by lane (`jax.lax.map`, one program per
family for shared and per-scenario params alike), compiled at XLA's backend
optimization level 0 without LLVM's expensive passes, the programs side by
side in threads; nothing runs in
interpret mode. Tolerances: dynamics and Jacobians rtol 1e-12; the
reductions 1e-13; the backward pass and rollout 1e-10; the solves the bar
of tests/test_multirotor.py's `_assert_same` (statuses and iterations
equal, cost rtol 1e-9, controls atol 1e-8).
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.costs.quadratic import QuadraticTrackingCost as JCost
from quadrotorilqr_tpu.kernels import models as j_lm
from quadrotorilqr_tpu.lie.se3 import SE3 as JSE3
from quadrotorilqr_tpu.models import multirotor as j_mr
from quadrotorilqr_tpu.models import quadrotor as j_qm
from quadrotorilqr_tpu.models import se3_wrench as j_wm
from quadrotorilqr_tpu.models.quadrotor import State as JState
from quadrotorilqr_tpu.solver import ilqr as j_ilqr
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.kernels import backward as p_kb
from quadrotorilqr_tpu_torch.kernels import models as p_lm
from quadrotorilqr_tpu_torch.kernels import solve as p_ks
from quadrotorilqr_tpu_torch.lie import se3 as p_se3
from quadrotorilqr_tpu_torch.models import multirotor as p_mr
from quadrotorilqr_tpu_torch.models import quadrotor as p_qm
from quadrotorilqr_tpu_torch.models import se3_wrench as p_wm
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import ilqr as p_ilqr
from quadrotorilqr_tpu_torch.solver import options as p_options
from quadrotorilqr_tpu_torch.tree import tree_map

from test_torch_kernels import DT

B, N = 6, 10
INERTIA = np.diag([0.4, 0.5, 0.6]) + 0.03
FAMILIES = ("wrench", "hexarotor")


def _compiled(programs):
    """{name: (fn, args)} -> {name: fn compiled}: traced one by one, then
    compiled by XLA side by side in threads (XLA's compiler releases the
    GIL), at backend optimization level 0 and without LLVM's expensive
    passes: IEEE float64 all the same, in less compile time."""
    lowered = {name: jax.jit(fn).lower(*args) for name, (fn, args) in programs.items()}
    flags = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        return dict(zip(lowered, pool.map(lambda lo: lo.compile(flags), lowered.values())))


def _airframe(n_rotors):
    """Positions (R, 3) and spins (R,) of a regular ring (JAX's `regular`)."""
    ang = 2.0 * np.pi * np.arange(n_rotors) / n_rotors
    pos = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), np.zeros(n_rotors)], -1)
    return pos, np.where(np.arange(n_rotors) % 2 == 0, -1.0, 1.0)


def np_params(family, batch=None, seed=0):
    """A family's params as a dict of numpy leaves: shared, or per scenario
    (every leaf with a leading `batch`; masses, inertias and yaw ratios
    drawn from `seed`)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if batch is None else 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
    full = (lambda a: np.asarray(a, np.float64)) if batch is None else (
        lambda a: np.broadcast_to(np.asarray(a, np.float64), (batch,) + np.shape(a)).copy())
    mass = np.asarray(1.3 * scale)
    inertia = INERTIA * (scale if batch is None else scale[:, None, None])
    if family == "wrench":
        return dict(mass_kg=mass, inertia=inertia, g_mpss=full(9.81))
    if family == "quadrotor":
        return dict(mass_kg=mass, inertia=inertia, arm_length_m=full(0.25),
                    torque_to_thrust_ratio_m=full(0.017), g_mpss=full(9.81))
    pos, spin = _airframe(6 if family == "hexarotor" else int(family[len("rotor"):]))
    kappa = 0.02 if batch is None else 0.01 + 0.02 * rng.uniform(size=batch)
    return dict(mass_kg=mass, inertia=inertia, rotor_positions_m=full(pos),
                rotor_spin=full(spin), torque_to_thrust_ratio_m=np.asarray(kappa),
                g_mpss=full(9.81))


def j_params(family, d):
    cls = dict(wrench=j_wm.WrenchParams, quadrotor=j_qm.QuadrotorParams).get(
        family, j_mr.MultirotorParams)
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def p_params(d):
    return convert.params_from_numpy(type("P", (), d), torch.float64)


def hover(family):
    if family == "wrench":
        return np.array([0.0, 0.0, 1.3 * 9.81, 0.0, 0.0, 0.0])
    return np.full(6, 1.3 * 9.81 / 6.0)


def np_problem(family, seed, batch=B, n=N):
    """A waypoint problem of the family: random poses, velocities and
    controls at every stage around the hover control, a hover target at
    the origin, Q = diag(100 1_6, 1_6), R = I_6 + 0.1."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((batch, n, 1)), 0.3 * rng.normal(size=(batch, n, 3))], -1)
    des_q = np.zeros((n, 4))
    des_q[:, 0] = 1.0
    return dict(
        quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        trans=0.4 * rng.normal(size=(batch, n, 3)), vel=0.2 * rng.normal(size=(batch, n, 6)),
        controls=hover(family) + 0.5 * rng.normal(size=(batch, n, 6)),
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        des_quat=des_q, des_trans=np.zeros((n, 3)), des_vel=np.zeros((n, 6)),
        des_controls=np.tile(hover(family), (n, 1)),
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(6) + 0.1 * np.ones((6, 6)),
    )


def j_problem(d):
    j = jnp.asarray
    cost = JCost(
        Q=j(d["Q"]), R=j(d["R"]),
        desired_states=JState(pose=JSE3(quat=j(d["des_quat"]), trans=j(d["des_trans"])),
                              vel=j(d["des_vel"])),
        desired_controls=j(d["des_controls"]),
    )
    traj = JTraj(times=j(d["times"]),
                 states=JState(pose=JSE3(quat=j(d["quat"]), trans=j(d["trans"])), vel=j(d["vel"])),
                 controls=j(d["controls"]))
    return cost, traj


def p_problem(d):
    cost, traj = jax.tree.map(np.asarray, j_problem(d))
    return convert.cost_from_numpy(cost), convert.trajectory_from_numpy(traj)


def states(seed, batch=5):
    """Random states and controls (numpy): poses Exp(0.6 N), velocities 0.4 N."""
    rng = np.random.default_rng(seed)
    tau = 0.6 * rng.normal(size=(batch, 6))
    return tau, 0.4 * rng.normal(size=(batch, 6)), 3.0 + 0.5 * rng.normal(size=(batch, 6))


def both_states(seed, batch=5):
    tau, vel, u = states(seed, batch)
    p_x = p_qm.State(pose=p_se3.exp(torch.tensor(tau)), vel=torch.tensor(vel))
    x = convert.to_numpy(p_x)
    j_x = JState(pose=JSE3(quat=jnp.asarray(x.pose.quat), trans=jnp.asarray(x.pose.trans)),
                 vel=jnp.asarray(x.vel))
    return p_x, j_x, u


def close(got, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# ---- dynamics and Jacobians ----


DYNAMICS_CASES = ("wrench", "hexarotor", "rotor8")


def _controls(family, u):
    return u if family != "rotor8" else np.concatenate([u, u[:, :2]], -1)


@pytest.mark.parametrize("family", DYNAMICS_CASES)
def test_dynamics_and_jacobians_match_jax(jax_refs, family):
    """continuous and discrete dynamics and their analytic Jacobians, on
    per-scenario params."""
    pp = p_params(np_params(family, batch=5, seed=1))
    p_x, _, u = both_states(2)
    pm = p_wm if family == "wrench" else p_mr
    (j_xdot, j_jx, j_ju), (j_next, j_djx, j_dju) = jax_refs["dynamics"][family]
    ut = torch.tensor(_controls(family, u))
    xdot, jx, ju = pm.continuous_dynamics_jacobians(pp, p_x, ut)
    nxt, djx, dju = pm.discrete_dynamics_jacobians(pp, p_x, ut, DT)
    for got, r in ((xdot, j_xdot), (jx, j_jx), (ju, j_ju), (djx, j_djx), (dju, j_dju),
                   (nxt.pose.quat, j_next.pose.quat), (nxt.vel, j_next.vel)):
        close(got, r, rtol=1e-12, atol=1e-14)
    close(pm.continuous_dynamics(pp, p_x, ut), j_xdot, rtol=1e-12, atol=1e-14)


def test_wrench_from_rotors_reduces_to_the_quadrotor(jax_refs):
    """The wrench model driven by a quadrotor's rotor thrusts through
    `wrench_from_rotors` is the quadrotor model; the wrench map is JAX's."""
    qp, wp = p_params(np_params("quadrotor")), p_params(np_params("wrench"))
    p_x, _, u = both_states(3)
    u4 = torch.tensor(u[:, :4])
    wrench = p_wm.wrench_from_rotors(qp, u4)
    close(wrench, jax_refs["wrench_from_rotors"], rtol=1e-13, atol=1e-13)
    close(p_wm.continuous_dynamics(wp, p_x, wrench),
          p_qm.continuous_dynamics(qp, p_x, u4).numpy(), rtol=1e-13, atol=1e-13)
    nw, _, _ = p_wm.discrete_dynamics_jacobians(wp, p_x, wrench, DT)
    nq, _, _ = p_qm.discrete_dynamics_jacobians(qp, p_x, u4, DT)
    close(nw.pose.trans, nq.pose.trans.numpy(), atol=1e-13)
    close(nw.vel, nq.vel.numpy(), atol=1e-13)


def test_four_rotor_multirotor_is_the_quadrotor():
    """`MultirotorParams.quadrotor` reproduces the quadrotor: the moment map
    column for column, the dynamics and Jacobians to 1e-13, and the kernels'
    operands bit for bit, on the quadrotor's kernels (no entry suffix)."""
    qp = p_params(np_params("quadrotor"))
    mp = p_mr.MultirotorParams.quadrotor(1.3, torch.tensor(INERTIA), 0.25, 0.017, 9.81)
    assert torch.equal(p_mr.moment_map(mp), p_qm.moment_arms(qp))
    p_x, _, u = both_states(4)
    u4 = torch.tensor(u[:, :4])
    for a, b in zip(p_mr.discrete_dynamics_jacobians(mp, p_x, u4, DT)[1:],
                    p_qm.discrete_dynamics_jacobians(qp, p_x, u4, DT)[1:]):
        close(a, b.numpy(), atol=1e-13)
    lm = p_lm.lane_model_for(mp)
    assert (lm.u_dim, lm.ju_lo, lm.suffix) == (4, 8, "")
    cpu = torch.device("cpu")
    got = lm.prep(mp, DT, torch.float64, cpu)
    ref = p_lm.QUADROTOR.prep(qp, DT, torch.float64, cpu)
    assert got[-1] == ref[-1] and all(torch.equal(a, b) for a, b in zip(got[:-1], ref[:-1]))


# ---- the kernels' lane operands ----


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_scenario"])
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_preps_match_jax(jax_refs, family, shared):
    """The six lane operands of each family against JAX's prep; JAX's shared
    operands are broadcast tiles, whose first lane is the port's one."""
    pp = p_params(np_params(family, batch=None if shared else B, seed=5))
    ref = jax_refs["prep"][f"{family}_{'shared' if shared else 'per_scenario'}"]
    lm = p_lm.lane_model_for(pp)
    assert (lm.u_dim, lm.ju_lo) == (6, 6 if family == "wrench" else 8)
    got = lm.prep(pp, DT, torch.float64, torch.device("cpu"))
    assert got[-1] == (not shared)
    for i, (g, r) in enumerate(zip(got[:-1], ref[:-1])):
        r = np.asarray(r)
        if i == 3 and family == "wrench":
            assert g is None  # the wrench reads no moment map
            continue
        close(g, (r[..., :1] if shared else r).reshape(tuple(g.shape)), rtol=1e-13, atol=1e-15)


# ---- the plain backward pass and rollout at u = 6, and both exact routes ----

J_OPTS = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 8))
P_OPTS = p_options.ILQROptions(
    p_options.LineSearchParams(0.5, 0.5, 20), p_options.ConvergenceCriteria(1e-8, 1e-8, 8)
)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of the module, from three programs compiled side
    by side: the three families' dynamics and Jacobians on per-scenario
    params, the two families' kernel preps (shared and per scenario) and
    `wrench_from_rotors`; and per family JAX's solve(model=...) lane by lane
    over per-lane params (shared ones broadcast, so that the program serves
    both params cases), and backward_pass and forward_sim (alpha 0.7) with
    model= on lane 0 with the shared params."""
    _, j_x, u = both_states(2)
    fixed = dict(
        dynamics=(tuple(j_params(f, np_params(f, batch=5, seed=1)) for f in DYNAMICS_CASES), j_x,
                  tuple(jnp.asarray(_controls(f, u)) for f in DYNAMICS_CASES)),
        prep={f"{family}_{case}": j_params(family, np_params(family, batch=batch, seed=5))
              for family in FAMILIES for case, batch in (("shared", None), ("per_scenario", B))},
        rotors=(j_params("quadrotor", np_params("quadrotor")),
                jnp.asarray(both_states(3)[2][:, :4])),
    )

    def fixed_refs(fixed):
        jp_dyn, x, us = fixed["dynamics"]
        dynamics = {}
        for f, jp, uf in zip(DYNAMICS_CASES, jp_dyn, us):
            jm = j_wm if f == "wrench" else j_mr
            dynamics[f] = (jm.continuous_dynamics_jacobians(jp, x, uf),
                           jm.discrete_dynamics_jacobians(jp, x, uf, DT))
        prep = {
            key: (j_lm._wrench_prep_params if key.startswith("wrench")
                  else j_lm._multirotor_prep_params)(jp, DT, jnp.float64)[:-1]
            for key, jp in fixed["prep"].items()
        }
        return dict(dynamics=dynamics, prep=prep,
                    wrench_from_rotors=j_wm.wrench_from_rotors(*fixed["rotors"]))

    def solve_refs(jp, cost, traj, model):
        solves = jax.lax.map(
            lambda a: j_ilqr.solve(a[0], cost, a[1], DT, J_OPTS, model=model), (jp, traj)
        )
        one, p0 = jax.tree.map(lambda a: a[0], (traj, jp))
        ks, big_ks, qutk, ktquuk = j_ilqr.backward_pass(p0, cost, one, DT, 0.0, model)
        new = j_ilqr.forward_sim(p0, one, ks, big_ks, jnp.asarray(0.7), DT, model)
        return solves, (ks, big_ks, qutk, ktquuk, new)

    programs, cases = {"fixed": (fixed_refs, (fixed,))}, {}
    for family in FAMILIES:
        model = j_wm if family == "wrench" else j_mr
        d = np_problem(family, 11)
        cost, traj = j_problem(d)
        pds = {False: np_params(family, batch=B, seed=13)}
        pds[True] = {k: np.broadcast_to(v[0], v.shape).copy() for k, v in pds[False].items()}
        jps = {k: j_params(family, v) for k, v in pds.items()}
        programs[family] = (functools.partial(solve_refs, model=model), (jps[True], cost, traj))
        cases[family] = (d, pds, jps, cost, traj)
    run = _compiled(programs)
    out = run["fixed"](fixed)
    for family, (d, pds, jps, cost, traj) in cases.items():
        for shared in (True, False):
            out[family, shared] = (d, pds[shared], run[family](jps[shared], cost, traj))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_backward_and_rollout_match_jax(jax_refs, family):
    d, pd, (_, (j_k, j_bigk, j_qutk, j_ktquuk, j_new)) = jax_refs[family, True]
    cost, traj = p_problem(d)
    one = tree_map(lambda a: a[0], traj)
    pp = p_params({k: v[0] for k, v in pd.items()})
    ks, big_ks, qutk, ktquuk = p_ilqr.backward_pass(pp, cost, one, DT)
    for g, r in ((ks, j_k), (big_ks, j_bigk), (qutk, j_qutk), (ktquuk, j_ktquuk)):
        close(g, r, rtol=1e-10, atol=1e-10)
    new = p_ilqr.forward_sim(pp, one, ks, big_ks, torch.tensor(0.7, dtype=torch.float64), DT)
    for g, r in ((new.controls, j_new.controls), (new.states.pose.quat, j_new.states.pose.quat),
                 (new.states.pose.trans, j_new.states.pose.trans), (new.states.vel, j_new.states.vel)):
        close(g, r, atol=1e-10)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_scenario"])
@pytest.mark.parametrize("family", FAMILIES)
def test_exact_routes_match_jax(jax_refs, family, shared):
    """solve_batch_latency and solve_batch_fused (their plain versions on
    the CPU) against JAX's solve, lane for lane."""
    d, pd, (ref, _) = jax_refs[family, shared]
    cost, traj = p_problem(d)
    pp = p_params({k: v[0] for k, v in pd.items()} if shared else pd)
    assert pp.batched == (not shared)
    for route in (p_batched.solve_batch_latency, p_batched.solve_batch_fused):
        got = route(pp, cost, traj, DT, P_OPTS)
        np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
        np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
        close(got.cost, ref.cost, rtol=1e-9)
        close(got.trajectory.controls, ref.trajectory.controls, atol=1e-8)


def test_plain_path_serves_any_rotor_count():
    """A 5-rotor airframe has no kernels, and the plain path solves it
    on the CPU, the two routes alike; `model=` names the family too."""
    d = np_params("rotor5")
    pp = p_params(d)
    prob = np_problem("hexarotor", 17, batch=3, n=6)
    prob["controls"], prob["R"] = prob["controls"][..., :5], np.eye(5)
    prob["des_controls"] = np.full((6, 5), 1.3 * 9.81 / 5)
    cost, traj = p_problem(prob)
    a = p_batched.solve_batch_latency(pp, cost, traj, DT, P_OPTS)
    b = p_batched.solve_batch_fused(pp, cost, traj, DT, P_OPTS, model=p_mr)
    assert p_lm.lane_model_for(pp).suffix is None
    assert bool((a.status == p_ilqr.STATUS_CONVERGED).all())
    assert torch.equal(a.cost, b.cost) and torch.equal(a.trajectory.controls, b.trajectory.controls)


# ---- routing and refusals ----


@pytest.mark.parametrize("family,u,point", [("quadrotor", 4, 256), ("wrench", 6, 199),
                                            ("hexarotor", 6, 199), ("rotor8", 8, 162)])
def test_route_point_per_control_width(monkeypatch, family, u, point):
    """JAX's max_horizon_for(u) = 256 * 112 // (48 + 16 u): the latency
    route takes stream.cu past it (the kernel wrappers stubbed)."""
    assert p_batched.stream_horizon(u) == point
    calls = []

    def stub(name):
        def run(params, cost, traj, dt_s, options, **kwargs):
            calls.append((name, traj.controls.shape[1]))
            lanes = traj.controls.shape[0]
            return traj, traj.controls[:, 0, 0], torch.zeros(lanes, dtype=torch.int32), \
                torch.zeros(lanes, dtype=torch.int32)
        return run

    monkeypatch.setattr(p_batched, "solve_fused_whole", stub("whole"))
    monkeypatch.setattr(p_batched, "solve_fused_streamed", stub("streamed"))
    pp = p_params(np_params(family))
    for n in (point, point + 1):
        prob = np_problem("wrench", 19, batch=1, n=n)
        prob["controls"], prob["R"] = prob["controls"][..., :u], np.eye(u)
        prob["des_controls"] = prob["des_controls"][:, :u]
        cost, traj = p_problem(prob)
        p_batched.solve_batch_latency(pp, cost, traj, DT, P_OPTS)
    assert calls == [("whole", point), ("streamed", point + 1)]


@pytest.mark.parametrize(
    "request_", ["limits", "weights", "history", "rotors5", "populate_debug", "fddp"]
)
def test_family_kernels_refuse_what_they_lack(request_):
    """On the card the wrench's and multirotors' kernels take no limits,
    weights or debug record, and a 5-rotor airframe has no kernels: each
    raises NotImplementedError naming its ROADMAP item (the host side of the
    launch, before any kernel; the card is stood in for by the meta
    device). The FDDP solvers refuse the families everywhere."""
    fam = "rotor5" if request_ == "rotors5" else "wrench"
    pp = p_params(np_params(fam))
    prob = np_problem("wrench", 23, batch=2, n=4)
    if fam == "rotor5":
        prob["controls"], prob["R"] = prob["controls"][..., :5], np.eye(5)
        prob["des_controls"] = prob["des_controls"][:, :5]
    cost, traj = p_problem(prob)
    cpu, f64 = torch.device("cpu"), torch.float64
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        if request_ == "limits":
            p_kb._problem_operands(pp, cost, 2, 4, DT, f64, cpu, (0.0, 20.0))
        elif request_ == "weights":
            w_cost = dataclasses.replace(cost, stage_weights=torch.ones(4, dtype=f64))
            p_kb._problem_operands(pp, w_cost, 2, 4, DT, f64, cpu, None)
        elif request_ == "history":
            p_ks._launch(pp, cost, traj, DT, P_OPTS, True, False)
        elif request_ == "rotors5":
            p_kb._problem_operands(pp, cost, 2, 4, DT, f64, cpu)
        elif request_ == "populate_debug":
            meta = tree_map(lambda a: a.to("meta"), traj)
            opts = dataclasses.replace(P_OPTS, populate_debug=True)
            p_batched.solve_batch_latency(pp, cost, meta, DT, opts)
        else:
            p_batched.solve_batch_fddp(pp, cost, traj, DT, P_OPTS)
    # the 4-rotor multirotor is the quadrotor, with its variants
    quad = p_mr.MultirotorParams.quadrotor(1.3, torch.tensor(INERTIA), 0.25, 0.017)
    q_prob = np_problem("wrench", 23, batch=2, n=4)
    q_prob["R"], q_prob["des_controls"] = np.eye(4), q_prob["des_controls"][:, :4]
    q_cost, _ = p_problem(q_prob)
    ops = p_kb._problem_operands(quad, q_cost, 2, 4, DT, f64, cpu, (0.0, 5.0))
    assert ops.entry("backward") == "qilqr_backward" and ops.variant[1][0] != 0


@pytest.mark.parametrize("family", ["wrench", "hexarotor", "quadrotor"])
def test_convert_round_trips(family):
    """JAX params as numpy -> the port's family dataclass -> numpy, unchanged."""
    d = np_params(family, batch=3, seed=29)
    jp = jax.tree.map(np.asarray, j_params(family, d))
    pp = convert.params_from_numpy(jp, torch.float64)
    assert type(pp).__name__ == type(jp).__name__
    back = convert.to_numpy(pp)
    for f in dataclasses.fields(pp):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(jp, f.name))
