"""The port's slice end to end against the JAX package, f64 on the CPU.

The port's `solver.batched.solve_batch_latency` / `solve_batch_fused` (on CPU
tensors the kernel wrappers run their plain versions) against JAX's XLA
`solve` lane by lane (`jax.lax.map`; the JAX package holds its engines in
interpret mode equal to it lane for lane, with the debug record too:
tests/test_solve_fused.py:18, :115, :174, tests/test_solve_latency.py:219),
one program compiled at XLA's backend optimization level 0 for every case,
at B=8 and N=8, with shared and per-scenario params, `solve_batch_latency`
with the debug record (its CostHistory: the costs and valid slots of JAX's
IterDebug); the port's `QuadrotorILQR` against the JAX class,
with `populate_debug` on every route (the IterDebug buffers, or a
CostHistory's costs and valid slots, against the JAX class's IterDebug);
and the port's import hygiene, also without protobuf. Tolerances as
tests/test_solve_fused.py: status and iterations equal, cost rtol 1e-8,
controls and translations 1e-7; debug costs rtol 1e-8, valid slots equal.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotorilqr_tpu.api import QuadrotorILQR as JQuadrotorILQR
from quadrotorilqr_tpu.solver import ilqr as j_ilqr
from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.kernels import stream as p_stream
from quadrotorilqr_tpu_torch.solver import batched as p_batched
from quadrotorilqr_tpu_torch.solver import options as p_options

from test_torch_kernels import (
    DT,
    assert_same_solution,
    jax_objects,
    np_problem,
    options_pair,
    port_objects,
)

B, N = 8, 8


def as_tuple(result):
    return (result.trajectory, result.cost, result.iterations, result.status)


def debug_opts():
    """options_pair with populate_debug, for the JAX package and the port."""
    return tuple(dataclasses.replace(o, populate_debug=True) for o in options_pair())


def assert_same_debug(port, ref):
    """A port debug record (IterDebug or CostHistory) against a JAX one
    whose buffers it carries: valid slots equal, costs rtol 1e-8, and an
    IterDebug's snapshots (controls, translations) within 1e-7."""
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(port.costs.numpy(), np.asarray(ref.costs), rtol=1e-8)
    if hasattr(port, "trajectories"):
        for got, want in ((port.trajectories.controls, ref.trajectories.controls),
                          (port.trajectories.states.pose.trans, ref.trajectories.states.pose.trans)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


XLA_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def xla_solve():
    """JAX's XLA `solve` with the debug record over (params, cost, traj),
    lane by lane over per-lane params (shared ones broadcast, so that one
    program serves every case of this module), compiled once."""
    jobjs = jax_objects(np_problem(20, B, N, False, True))
    j_opts = debug_opts()[0]

    def lanes(params, cost, traj):
        return jax.lax.map(lambda a: j_ilqr.solve(a[0], cost, a[1], DT, j_opts), (params, traj))

    compiled = jax.jit(lanes).lower(*jobjs).compile(XLA_FAST)

    def solve(params, cost, traj):
        if jnp.ndim(params.mass_kg) == 0:
            params = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), params)
        return compiled(params, cost, traj)

    return solve


@pytest.mark.parametrize("per_scenario_params", [False, True], ids=["shared", "per_scenario"])
def test_solve_batch_latency_matches_jax(xla_solve, per_scenario_params):
    """With the debug record: the port records the whole-solve kernel's cost
    history (a CostHistory, from the kernel's plain version), the costs and
    valid slots of JAX's IterDebug."""
    jobjs = jax_objects(np_problem(20, B, N, False, per_scenario_params))
    _, p_opts = debug_opts()
    ref = xla_solve(*jobjs)
    got = p_batched.solve_batch_latency(*port_objects(jobjs), DT, p_opts)
    assert_same_solution(as_tuple(got), as_tuple(ref))
    assert type(got.debug).__name__ == "CostHistory"
    assert_same_debug(got.debug, ref.debug)
    assert int(got.debug.valid.sum()) == int(got.iterations.sum()) > B


def test_solve_batch_fused_matches_jax(xla_solve):
    jobjs = jax_objects(np_problem(21, B, N, False))
    _, p_opts = options_pair()
    ref = xla_solve(*jobjs)
    got = p_batched.solve_batch_fused(*port_objects(jobjs), DT, p_opts)
    assert_same_solution(as_tuple(got), as_tuple(ref))


def test_zero_probe_line_search_routes_to_the_batch_loop():
    params, cost, traj = port_objects(jax_objects(np_problem(22, 3, 4, False)))
    _, p_opts = options_pair(max_iters=3)
    zero = p_options.ILQROptions(
        p_options.LineSearchParams(0.5, 0.5, 0), p_opts.convergence_criteria
    )
    got = p_batched.solve_batch_latency(params, cost, traj, DT, zero)
    ref = p_batched.solve_batch_fused(params, cost, traj, DT, zero)
    for g, r in zip(as_tuple(got)[1:], as_tuple(ref)[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # every later trip's line search fails at once; trip 0 still steps
    assert (got.status == 2).all() and (got.iterations == 2).all()


def _api_pair(seed):
    d = np_problem(seed, B, N, False)
    p = d["params"]
    desired = dict(
        times=np.arange(N) * DT, quat=d["des_quat"], trans=d["des_trans"], vel=d["des_vel"],
        controls=d["des_controls"],
    )
    jobjs = jax_objects(d)
    j_desired = jax.tree.map(lambda a: a[0], jobjs[2])  # shape template for the desired
    j_desired = type(j_desired)(
        times=desired["times"],
        states=type(j_desired.states)(
            pose=type(j_desired.states.pose)(quat=desired["quat"], trans=desired["trans"]),
            vel=desired["vel"],
        ),
        controls=desired["controls"],
    )
    j_opts, p_opts = debug_opts()
    args = (p["mass_kg"], p["inertia"], p["arm_length_m"], p["torque_to_thrust_ratio_m"],
            p["g_mpss"], d["Q"], d["R"])
    j_api = JQuadrotorILQR(*args, jax.tree.map(jax.numpy.asarray, j_desired), DT, j_opts)
    p_api = QuadrotorILQR(
        *args, convert.trajectory_from_numpy(j_desired), DT, p_opts, device="cpu"
    )
    return j_api, p_api, jobjs[2]


@pytest.fixture(scope="module")
def api_pair(xla_solve):
    """The two classes on one problem, and the reference of the port's
    batch routes: the JAX class's float64 batch solve as its `solve_batch`
    runs it (JAX's `solve` on each lane, with the class's params, cost and
    options; `xla_solve`)."""
    j_api, p_api, j_trajs = _api_pair(23)
    return p_api, j_trajs, xla_solve(j_api.params, j_api.cost, j_trajs), j_api


@pytest.mark.parametrize(
    "route", [dict(), dict(latency=True), dict(fused=False)], ids=["fused", "latency", "plain"]
)
def test_api_solve_batch_matches_jax(api_pair, route):
    """Every route with `populate_debug` against the JAX class's float64
    batch (single solves lane by lane, an IterDebug): the batch loops carry
    the IterDebug buffers, the whole-solve route its costs and valid slots."""
    p_api, j_trajs, ref, _ = api_pair
    got = p_api.solve_batch(
        convert.trajectory_from_numpy(jax.tree.map(np.asarray, j_trajs)), **route
    )
    assert_same_solution(as_tuple(got), as_tuple(ref))
    expected = "CostHistory" if route.get("latency") else "IterDebug"
    assert type(got.debug).__name__ == expected
    assert_same_debug(got.debug, ref.debug)


def test_streamed_reference_matches_jax(api_pair):
    """The streamed schedule's plain version (cost-only probes, one apply
    rollout at the alpha each lane last tried) on the fixture's inputs
    against JAX's float64 batch route."""
    p_api, j_trajs, ref, _ = api_pair
    trajs = convert.trajectory_from_numpy(jax.tree.map(np.asarray, j_trajs))
    got = p_stream.solve_streamed_reference(p_api.params, p_api.cost, trajs, DT, p_api.options)
    assert_same_solution(got[:4], as_tuple(ref))


def test_api_solve_pytree_matches_jax(api_pair):
    p_api, j_trajs, _, j_api = api_pair
    one = jax.tree.map(lambda a: a[0], j_trajs)
    # the JAX class's solve_pytree, compiled at XLA's backend optimization
    # level 0 (IEEE float64 all the same, in less compile time)
    ref = jax.jit(j_api.solve_pytree).lower(one).compile(XLA_FAST)(one)
    got = p_api.solve_pytree(convert.trajectory_from_numpy(jax.tree.map(np.asarray, one)))
    assert_same_solution(as_tuple(got), as_tuple(ref))
    assert_same_debug(got.debug, ref.debug)


@pytest.mark.parametrize(
    "kwargs", [dict(solver="ddp"), dict(stage_weights=np.ones(N))], ids=["ddp", "weights"]
)
def test_api_refuses_options_outside_the_slice(api_pair, kwargs):
    """solver="ddp" is refused, naming its ROADMAP item; stage weights are
    ported: the class carries them on its cost with every solver, the FDDP
    ones included (tests/test_torch_variants.py solves with them)."""
    p_api = api_pair[0]
    args = (1.0, np.eye(3), 0.2, 0.016, 9.81, np.eye(12), np.eye(4), p_api.desired_traj, DT,
            p_api.options)
    if "stage_weights" in kwargs:
        # the FDDP solvers have no debug record: the same options without it
        no_debug = dataclasses.replace(p_api.options, populate_debug=False)
        for solver in ("ilqr", "fddp", "fddp-ddp"):
            opts = args[:-1] + ((no_debug,) if solver != "ilqr" else args[-1:])
            api = QuadrotorILQR(*opts, device="cpu", solver=solver, **kwargs)
            torch.testing.assert_close(api.cost.stage_weights, torch.ones(N, dtype=torch.float64))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QuadrotorILQR(*args, device="cpu", **kwargs)


def test_api_defaults_to_cuda_and_refuses_without_it(api_pair, monkeypatch):
    """No device means the CUDA card; without one the solver refuses to
    start instead of carrying on on the CPU."""
    p_api = api_pair[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuadrotorILQR(
            1.0, np.eye(3), 0.2, 0.016, 9.81, np.eye(12), np.eye(4), p_api.desired_traj,
            DT, p_api.options,
        )


def test_port_imports_no_jax():
    """No module of the port imports JAX or the JAX package. With protobuf
    hidden first, everything outside `io/` imports, `solve_pytree` and
    `solve_batch` run (with the debug record), and only the proto surface
    raises ImportError; then, with protobuf back, `io/` imports too."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['google.protobuf'] = None\n"
        "import torch, quadrotorilqr_tpu_torch as p\n"
        "io = p.__name__ + '.io'\n"
        "modules = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in modules:\n"
        "    if not name.startswith(io):\n"
        "        importlib.import_module(name)\n"
        "from quadrotorilqr_tpu_torch.api import QuadrotorILQR\n"
        "from quadrotorilqr_tpu_torch.app import workloads as w\n"
        "from quadrotorilqr_tpu_torch.lie import se3\n"
        "from quadrotorilqr_tpu_torch.models.quadrotor import State\n"
        "from quadrotorilqr_tpu_torch.solver.options import ILQROptions, ConvergenceCriteria\n"
        "d = w.demo_desired_trajectory(1.0)\n"
        "q, r = w.demo_weights()\n"
        "opts = ILQROptions(convergence_criteria=ConvergenceCriteria(max_iters=2), "
        "populate_debug=True)\n"
        "api = QuadrotorILQR(1.0, torch.eye(3), 1.0, 0.0, 9.81, q, r, d, 1.0, opts, device='cpu')\n"
        "assert int(api.solve_pytree(d).debug.valid.sum()) == 2\n"
        "x0 = State(se3.exp(0.1 * torch.ones(3, 6, dtype=torch.float64)), "
        "torch.zeros(3, 6, dtype=torch.float64))\n"
        "batch = w.initial_trajectory_from_state(x0, d)\n"
        "assert api.solve_batch(batch, latency=True).debug.costs.shape == (3, 2)\n"
        "try:\n"
        "    api.solve(d)\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('solve ran without protobuf')\n"
        "assert io not in sys.modules\n"
        "del sys.modules['google.protobuf']\n"
        "for name in modules:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'quadrotorilqr_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
