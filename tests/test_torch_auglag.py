"""Constrained flight on the port (`solver/constraints.py`, `solver/auglag.py`,
the penalty in the plain backward passes), float64 on the CPU.

Against the JAX package: every constraint constructor's value and Lie-tangent
Jacobians (`_constraint_diffs`) on seeded random stages; the PHR
quadratics and the plain penalty backward pass (`_backward_pass_aug`), with
and without stage weights; `solve_auglag_batch` (its plain versions here)
against `vmap(solve_auglag)` on the keep-out crossing with the sphere
binding on most lanes, at the bars of JAX's own kernel-route test
(tests/test_auglag.py:316-337); `solve_auglag` on one lane; and
`robust=True` (the FDDP inner loop) on two lanes. Without JAX: inactive
constraints reproduce the unconstrained solve, the wrench solves its
keep-out, the penalty rows' layout, and the kernels' refusals.

The JAX references are one constraint program for all the constructors and
three solve programs (lane by lane with `jax.lax.map`, what
`jax.vmap(solve_auglag)` computes for each lane), traced one by one and
compiled side by side in threads at XLA's backend optimization level 0.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.costs.quadratic import QuadraticTrackingCost as JCost
from quadrotorilqr_tpu.lie import se3 as j_se3
from quadrotorilqr_tpu.models import quadrotor as j_qm
from quadrotorilqr_tpu.parallel.batch import initial_trajectory_from_state as j_initial
from quadrotorilqr_tpu.solver import auglag as j_al
from quadrotorilqr_tpu.solver import constraints as JC
from quadrotorilqr_tpu.solver.ilqr import Trajectory as JTraj
from quadrotorilqr_tpu.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.app import workloads as p_workloads
from quadrotorilqr_tpu_torch.kernels import backward as p_kb
from quadrotorilqr_tpu_torch.models import quadrotor as p_qm
from quadrotorilqr_tpu_torch.models import se3_wrench as p_wm
from quadrotorilqr_tpu_torch.solver import auglag as p_al
from quadrotorilqr_tpu_torch.solver import constraints as PC
from quadrotorilqr_tpu_torch.solver import ilqr as p_ilqr
from quadrotorilqr_tpu_torch.solver import options as p_options
from quadrotorilqr_tpu_torch.tree import tree_map

torch.set_num_threads(1)  # the plain loops' tiny ops gain nothing from threads

XLA_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
B, N, DT = 6, 12, 0.1
LS, CC = (0.5, 0.5, 20), (1e-8, 1e-8, 20)
J_OPTS = ILQROptions(LineSearchParams(*LS), ConvergenceCriteria(*CC))
P_OPTS = p_options.ILQROptions(p_options.LineSearchParams(*LS), p_options.ConvergenceCriteria(*CC))
AL = dict(constraint_tol=1e-8, max_outer_iters=12)
# At 12 stages of dt 0.1 the crossing climbs while it accelerates toward the
# waypoint: a sphere on that path binds on most lanes
SPHERE = ([0.7, 0.0, 0.4], 0.25)
ROBUST_LANES = 2

# Every constructor once, in one stacked constraint (with `_mixed` last): (name,
# the constructor's call on the JAX or the port's module, its rows)
CONSTRUCTORS = (
    ("sphere_keepout", lambda m: m.sphere_keepout([0.3, -0.1, 0.2], 0.5), 1),
    ("ball_keepin", lambda m: m.ball_keepin([0.1, 0.2, -0.3], 1.5), 1),
    ("halfspace", lambda m: m.halfspace([0.2, -0.3, 0.9], -0.4), 1),
    ("speed_limit", lambda m: m.speed_limit(0.8), 1),
    ("speed_limit_angular", lambda m: m.speed_limit(0.6, angular=True), 1),
    ("tilt_limit", lambda m: m.tilt_limit(0.4), 1),
    ("cylinder_keepout", lambda m: m.cylinder_keepout([0.4, -0.2], 0.3), 1),
    ("altitude_band", lambda m: m.altitude_band(-0.2, 0.3), 2),
    ("control_box", lambda m: m.control_box(1.0, [3.0, 3.5, 2.5, 4.0]), 8),
)


def _mixed(x, u, k):
    """A user constraint coupling state and control (forward speed times
    the first rotor's thrust), so that the penalty's cross term pcxu is
    nonzero: every constructor reads the state or the control alone."""
    return x.vel[..., 0:1] * u[..., 0:1] - 0.5


def _combined(module):
    return module.combine(*(make(module) for _, make, _ in CONSTRUCTORS), _mixed)


def _backward_constraint(module):
    """The backward passes' constraint: a keep-out and `_mixed`."""
    return module.combine(module.sphere_keepout([0.3, -0.1, 0.2], 0.5), _mixed)


def port_objects(jobjs):
    """A JAX (params, cost, trajectory) as the port's objects."""
    params, cost, traj = jax.tree.map(np.asarray, jobjs)
    return (convert.params_from_numpy(params), convert.cost_from_numpy(cost),
            convert.trajectory_from_numpy(traj))


def _rows(name):
    start = 0
    for other, _, rows in CONSTRUCTORS:
        if other == name:
            return slice(start, start + rows)
        start += rows
    raise KeyError(name)


def _jax_crossing(batch, n, seed=0):
    """tests/test_auglag.py's crossing problem in float64, each lane's start
    translation offset by 0.15 N(0, I_3) from numpy (`keepout_problem`'s
    draws)."""
    f64 = jnp.float64
    params = j_qm.QuadrotorParams.create(
        mass_kg=1.0, inertia=jnp.eye(3, dtype=f64), arm_length_m=0.25,
        torque_to_thrust_ratio_m=0.02, g_mpss=9.81,
    )
    desired = JTraj(
        times=jnp.arange(n, dtype=f64) * DT,
        states=j_qm.State(
            pose=j_se3.SE3(quat=jnp.tile(jnp.asarray([1.0, 0, 0, 0], f64), (n, 1)),
                           trans=jnp.tile(jnp.asarray([2.0, 0, 0], f64), (n, 1))),
            vel=jnp.zeros((n, 6), f64),
        ),
        controls=jnp.full((n, 4), 9.81 / 4.0, f64),
    )
    cost = JCost(
        Q=jnp.asarray(np.diag([60.0] * 6 + [1.0] * 6), f64), R=0.5 * jnp.eye(4, dtype=f64),
        desired_states=desired.states, desired_controls=desired.controls,
    )
    start = 0.15 * np.random.default_rng(seed).normal(size=(batch, 3))
    x0 = j_qm.State(
        pose=j_se3.SE3(quat=jnp.tile(jnp.asarray([1.0, 0, 0, 0], f64), (batch, 1)),
                       trans=jnp.asarray(start)),
        vel=jnp.zeros((batch, 6), f64),
    )
    return params, cost, j_initial(x0, desired)


def _random_stages(seed, batch, n):
    """Seeded random (B, N, ...) trajectories (poses, twists, controls) on
    the crossing problem for the constraint and backward-pass checks, with
    multipliers (for every constructor, and for `_backward_constraint`), mu and
    stage weights."""
    rng = np.random.default_rng(seed)
    tau, vel = 0.6 * rng.normal(size=(batch, n, 6)), 0.8 * rng.normal(size=(batch, n, 6))
    controls = 2.45 + rng.normal(size=(batch, n, 4))

    def build():
        params, cost, trajs = _jax_crossing(batch, n, seed)
        states = j_qm.State(pose=j_se3.exp(jnp.asarray(tau)), vel=jnp.asarray(vel))
        return params, cost, JTraj(times=trajs.times, states=states,
                                   controls=jnp.asarray(controls))

    def multipliers(n_c):
        return np.where(rng.uniform(size=(batch, n, n_c)) < 0.5,
                        rng.uniform(0, 3, (batch, n, n_c)), 0.0)

    lam = (multipliers(sum(rows for _, _, rows in CONSTRUCTORS) + 1), multipliers(2))
    mu = rng.uniform(5.0, 50.0, size=batch)
    w = rng.uniform(0.5, 2.0, size=(batch, n))
    return _jitted(build), lam, mu, w


def _jitted(build):
    """build()'s JAX objects from one compiled program (op-by-op dispatch
    compiles every operation it meets first, which takes longer)."""
    return jax.jit(build).lower().compile(XLA_FAST)()


def _pen_quads(g, gx, gu, lam, mu):
    """The JAX module's PHR quadratics (solver/auglag.py:577-603)."""
    z = jnp.maximum(lam + mu * g, 0.0)
    w = mu * (z > 0).astype(g.dtype)
    return (
        jnp.einsum("ncx,nc->nx", gx, z),
        jnp.einsum("ncu,nc->nu", gu, z),
        jnp.einsum("ncx,nc,ncy->nxy", gx, w, gx),
        jnp.einsum("ncu,nc,ncv->nuv", gu, w, gu),
        jnp.einsum("ncx,nc,ncu->nxu", gx, w, gu),
    )


def _diffs_and_backward(params, cost, trajs, lam, lam_b, mu, w):
    """Every lane's constraint diffs (every constructor) and PHR quadratics,
    and its penalty backward pass (`_backward_constraint`) without and with
    stage weights."""
    con, con_b = _combined(JC), _backward_constraint(JC)

    def lane(t, lam_l, lam_bl, mu_l, w_l):
        g, gx, gu = j_al._constraint_diffs(con, j_qm, t.states, t.controls, N)
        back = [
            j_al._backward_pass_aug(params, c, t, DT, con_b, lam_bl, mu_l, 1e-6, j_qm)
            for c in (cost, dataclasses.replace(cost, stage_weights=w_l))
        ]
        return (g, gx, gu), _pen_quads(g, gx, gu, lam_l, mu_l), back

    return jax.vmap(lane)(trajs, lam, lam_b, mu, w)


def _lanes(robust):
    def run(params, cost, trajs):
        sphere = JC.sphere_keepout(*SPHERE)
        return jax.lax.map(
            lambda t: j_al.solve_auglag(params, cost, sphere, t, DT, J_OPTS,
                                        j_al.ALOptions(**AL), robust=robust),
            trajs,
        )
    return run


@pytest.fixture(scope="module")
def problems():
    """(JAX objects, the port's) of the crossing problem and of the random
    stages, with the random multipliers, penalties and weights."""
    crossing = _jitted(lambda: _jax_crossing(B, N))
    rand, lam, mu, w = _random_stages(5, 3, N)
    return (crossing, port_objects(crossing)), (rand, port_objects(rand), lam, mu, w)


@pytest.fixture(scope="module")
def jax_refs(problems):
    """The module's JAX programs, traced one by one, each compiled in a
    thread as soon as it is traced (beside the later traces); returns their
    results as numpy."""
    (crossing, _), (rand, _, lam, mu, w) = problems
    robust_lanes = jax.tree.map(lambda a: a[:ROBUST_LANES], crossing[2])
    work = {
        "diffs": (_diffs_and_backward,
                  (*rand, *(jnp.asarray(a) for a in lam), jnp.asarray(mu), jnp.asarray(w))),
        "batch": (_lanes(False), crossing),
        "robust": (_lanes(True), (*crossing[:2], robust_lanes)),
    }
    with concurrent.futures.ThreadPoolExecutor(len(work)) as pool:
        futures = {k: pool.submit(jax.jit(fn).lower(*args).compile, XLA_FAST)
                   for k, (fn, args) in work.items()}
        compiled = {k: f.result() for k, f in futures.items()}
    return {k: jax.tree.map(np.asarray, compiled[k](*work[k][1])) for k in work}


def _np(a):
    return a.detach().cpu().numpy()


@pytest.mark.parametrize("name", [b[0] for b in CONSTRUCTORS])
def test_constraint_constructor_matches_jax(problems, jax_refs, name):
    """Each constructor's value and its Lie-tangent Jacobians (d/dtau g(x (+)
    tau, u + du) at 0, by torch.func.jacfwd) against JAX's jacfwd, on
    seeded random stages, to 1e-12."""
    _, (_, (_, _, trajs), *_) = problems
    got = p_al.constraint_diffs(_combined(PC), p_qm, trajs.states, trajs.controls)
    ref = jax_refs["diffs"][0]
    rows = _rows(name)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g)[:, :, rows], r[:, :, rows], rtol=0, atol=1e-12)
    values = p_al.eval_constraints(_combined(PC), trajs.states, trajs.controls)
    np.testing.assert_allclose(_np(values)[:, :, rows], ref[0][:, :, rows], rtol=0, atol=1e-12)


def test_penalty_quadratics_match_jax(problems, jax_refs):
    """The PHR quadratics (pcx, pcu, pcxx, pcuu, pcxu) from the same
    values, Jacobians and multipliers, with some constraints active and
    some not."""
    _, (_, _, lam, mu, _) = problems
    g, gx, gu = (torch.as_tensor(a.copy()) for a in jax_refs["diffs"][0])
    lam_t, mu_t = torch.as_tensor(lam[0]), torch.as_tensor(mu)
    active = float(((lam_t + mu_t[:, None, None] * g) > 0).double().mean())
    assert 0.2 < active < 0.9, active
    got = p_al.penalty_quads(g, gx, gu, lam_t, mu_t)
    for a, r in zip(got, jax_refs["diffs"][1]):
        np.testing.assert_allclose(_np(a), r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("weights", [False, True], ids=["unweighted", "weighted"])
def test_penalty_backward_pass_matches_jax(problems, jax_refs, weights):
    """The plain penalty backward pass (`backward_pass_fused(penalty=...)`
    on CPU tensors: `ilqr.backward_pass(penalty=...)`) against JAX's
    `_backward_pass_aug`, with and without per-scenario stage weights (the
    penalty is never weighted)."""
    _, (_, (params, cost, trajs), lam, mu, w) = problems
    if weights:
        cost = dataclasses.replace(cost, stage_weights=torch.as_tensor(w))
    g, gx, gu = p_al.constraint_diffs(_backward_constraint(PC), p_qm, trajs.states,
                                      trajs.controls)
    pen = p_al.penalty_quads(g, gx, gu, torch.as_tensor(lam[1]), torch.as_tensor(mu))
    got = p_kb.backward_pass_fused(params, cost, trajs, DT, 1e-6, penalty=pen)
    ref = jax_refs["diffs"][2][int(weights)]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_np(a), r, rtol=1e-10, atol=1e-10 * np.abs(r).max())
    # the cross term matters: without it the gains differ
    pen0 = pen[:4] + (torch.zeros_like(pen[4]),)
    off = p_kb.backward_pass_fused(params, cost, trajs, DT, 1e-6, penalty=pen0)
    assert np.abs(_np(off[1]) - ref[1]).max() > 1e-6


def _assert_matches(got, ref, lanes=slice(None), controls_atol=1e-6):
    """tests/test_auglag.py:316-337's bars."""
    np.testing.assert_array_equal(_np(got.status), ref.status[lanes])
    np.testing.assert_array_equal(_np(got.outer_iterations), ref.outer_iterations[lanes])
    np.testing.assert_array_equal(_np(got.iterations), ref.iterations[lanes])
    np.testing.assert_allclose(_np(got.cost), ref.cost[lanes], rtol=1e-8)
    np.testing.assert_allclose(_np(got.max_violation), ref.max_violation[lanes], atol=1e-8)
    np.testing.assert_allclose(_np(got.trajectory.controls), ref.trajectory.controls[lanes],
                               atol=controls_atol)


def test_keepout_problem_matches_jax_crossing():
    """`app.workloads.keepout_problem` in float64 is the JAX package's
    crossing problem with the same numpy draws."""
    ours = p_workloads.keepout_problem(B, N, torch.float64, "cpu", seed=0)
    ref = port_objects(_jitted(lambda: _jax_crossing(B, N)))
    for a, r in zip((ours.params, ours.cost, ours.trajs), ref):
        leaves = []
        tree_map(lambda x, y: leaves.append((x, y)), a, r)
        for x, y in leaves:
            np.testing.assert_array_equal(_np(x), _np(y))
    assert ours.dt_s == DT and ours.al_options == p_al.ALOptions()


def test_solve_auglag_batch_matches_vmapped_jax(problems, jax_refs):
    """The exact inner loop lane for lane: status, outer and inner
    iterations equal, cost to 1e-8, violation to 1e-8, controls to 1e-6;
    the constraint binds (multipliers > 0, the trajectory on the sphere's
    surface) on most lanes."""
    (_, (params, cost, trajs)), _ = problems
    ref = jax_refs["batch"]
    got = p_al.solve_auglag_batch(params, cost, PC.sphere_keepout(*SPHERE), trajs, DT, P_OPTS,
                                  p_al.ALOptions(**AL))
    _assert_matches(got, ref)
    np.testing.assert_allclose(_np(got.multipliers), ref.multipliers, rtol=1e-6, atol=1e-6)
    binding = ref.multipliers.max(axis=(1, 2)) > 0
    assert binding.sum() >= B // 2 and (ref.outer_iterations[binding] > 1).all()
    assert ref.max_violation.max() < AL["constraint_tol"]


def test_solve_auglag_one_lane_matches_jax(problems, jax_refs):
    """`solve_auglag` on one (N, ...) scenario, a lane where the sphere
    binds, against JAX's solve of that lane."""
    (_, (params, cost, trajs)), _ = problems
    ref = jax_refs["batch"]
    # the binding lane with the fewest inner trips
    binding = ref.multipliers.max(axis=(1, 2)) > 0
    lane = int(np.argmin(np.where(binding, ref.iterations, np.iinfo(np.int32).max)))
    got = p_al.solve_auglag(params, cost, PC.sphere_keepout(*SPHERE),
                            tree_map(lambda a: a[lane], trajs), DT, P_OPTS, p_al.ALOptions(**AL))
    assert got.trajectory.controls.shape == (N, 4) and got.multipliers.shape == (N, 1)
    _assert_matches(got, ref, lanes=lane)


def test_robust_auglag_matches_jax(problems, jax_refs):
    """`robust=True`, the plain FDDP inner loop on the augmented problem,
    on two lanes against JAX's `solve_auglag(robust=True)`: status and
    iterations equal, cost to 1e-8."""
    (_, (params, cost, trajs)), _ = problems
    ref = jax_refs["robust"]
    lanes = tree_map(lambda a: a[:ROBUST_LANES], trajs)
    got = p_al.solve_auglag_batch(params, cost, PC.sphere_keepout(*SPHERE), lanes, DT, P_OPTS,
                                  p_al.ALOptions(**AL), robust=True)
    _assert_matches(got, ref, controls_atol=1e-6)
    assert ref.max_violation.max() < AL["constraint_tol"]
    assert (ref.multipliers.max(axis=(1, 2)) > 0).any()


def test_inactive_constraints_reproduce_the_unconstrained_solve(problems):
    """A keep-out far from every path never activates: one outer
    iteration, converged, and the unconstrained solve bit for bit (the
    penalty adds exact zeros)."""
    (_, (params, cost, trajs)), _ = problems
    far = PC.combine(PC.sphere_keepout([50.0, 50.0, 50.0], 1.0), PC.altitude_band(-100, 100))
    got = p_al.solve_auglag_batch(params, cost, far, trajs, DT, P_OPTS, p_al.ALOptions(**AL))
    ref = p_ilqr.solve(params, cost, trajs, DT, P_OPTS)
    assert (_np(got.outer_iterations) == 1).all() and (_np(got.status) == 1).all()
    np.testing.assert_array_equal(_np(got.iterations), _np(ref.iterations))
    np.testing.assert_array_equal(_np(got.cost), _np(ref.cost))
    np.testing.assert_array_equal(_np(got.trajectory.controls), _np(ref.trajectory.controls))
    assert (_np(got.multipliers) == 0).all() and (_np(got.max_violation) == 0).all()


def test_solve_auglag_is_model_generic_wrench(problems):
    """The SE(3) body wrench (u = 6) solves the keep-out of the JAX
    package's test_model_generic_wrench (radius 0.4 at [1, 0, 0], which its
    straight path crosses) to tolerance."""
    (_, (_, cost, trajs)), _ = problems
    center, radius = [1.0, 0.0, 0.0], 0.4
    wparams = p_wm.WrenchParams.create(1.0, torch.eye(3, dtype=torch.float64), 9.81)
    grav = torch.tensor([0, 0, 9.81, 0, 0, 0], dtype=torch.float64).expand(N, 6)
    wcost = dataclasses.replace(cost, R=0.5 * torch.eye(6, dtype=torch.float64),
                                desired_controls=grav)
    wtraj = dataclasses.replace(tree_map(lambda a: a[0], trajs), controls=grav.clone())
    res = p_al.solve_auglag(wparams, wcost, PC.sphere_keepout(center, radius), wtraj, DT,
                            P_OPTS, p_al.ALOptions(**AL))
    assert int(res.status) == 1 and int(res.outer_iterations) > 1
    assert float(res.max_violation) <= AL["constraint_tol"]
    assert float(res.multipliers.max()) > 0
    d = (res.trajectory.states.pose.trans - torch.tensor(center, dtype=torch.float64)).norm(dim=-1)
    assert float(d.min()) >= radius - 1e-3


def test_penalty_rows_layout(problems):
    """The kernel's (N, B, 224) penalty rows: stage n of scenario b is
    pcx | pcu | pcxx | pcuu | pcxu, each matrix row-major."""
    _, (_, (_, _, trajs), lam, mu, _) = problems
    g, gx, gu = p_al.constraint_diffs(_combined(PC), p_qm, trajs.states, trajs.controls)
    pen = p_al.penalty_quads(g, gx, gu, torch.as_tensor(lam[0]), torch.as_tensor(mu))
    rows = p_kb.penalty_rows(pen, torch.float64, torch.device("cpu"))
    assert rows.shape == (N, 3, p_kb.penalty_width(4)) == (N, 3, 224)
    b, n = 2, 7
    want = torch.cat([a[b, n].flatten() for a in pen])
    assert torch.equal(rows[n, b], want)


@pytest.mark.parametrize("request_", ["limits", "family"])
def test_penalty_variant_refusals(problems, request_):
    """backward.cu's penalty variant is the quadrotor's without limits: the
    launch refuses limits and the other families on the host, naming
    ROADMAP item 11c, before any kernel runs."""
    _, (_, (params, cost, trajs), *_) = problems
    batch = trajs.controls.shape[0]
    limits = None
    if request_ == "limits":
        limits = (0.0, 5.0)
    else:
        params = p_wm.WrenchParams.create(1.0, torch.eye(3, dtype=torch.float64), 9.81)
        cost = dataclasses.replace(cost, R=torch.eye(6, dtype=torch.float64),
                                   desired_controls=torch.zeros(N, 6, dtype=torch.float64))
        trajs = dataclasses.replace(trajs, controls=torch.zeros(batch, N, 6, dtype=torch.float64))
    ops = p_kb._problem_operands(params, cost, batch, N, DT, torch.float64,
                                 torch.device("cpu"), limits)
    pen = torch.zeros((N, batch, 224), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11c"):
        p_kb._launch(ops, trajs, 0.0, None, pen)
