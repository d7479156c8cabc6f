"""The port's long-horizon path on the CPU: the streamed schedule's plain
versions and the horizon routing. No JAX here.

The streamed plain versions (`solve_streamed_reference`,
`solve_fddp_streamed_reference`) against the whole-solve plain versions on
the same inputs, exactly (rollouts are deterministic, so rebuilding a
candidate at its alpha gives the same bits), including a starved line
search whose lanes fail; their per-lane counts; the batch solvers' routing
at the JAX package's switch points (256 stages exact, 231 FDDP), with the
kernel wrappers replaced by recording stubs so that nothing is solved. The
JAX package's own tests pin its streamed kernels to its whole-solve ones;
tests/test_torch_slice.py and tests/test_torch_fddp.py hold these plain
versions against JAX's solvers.
"""

import dataclasses

import pytest
import torch

from quadrotorilqr_tpu_torch.api import QuadrotorILQR
from quadrotorilqr_tpu_torch.app import workloads
from quadrotorilqr_tpu_torch.kernels import fddp as kf
from quadrotorilqr_tpu_torch.kernels import solve as ks
from quadrotorilqr_tpu_torch.kernels import stream as kst
from quadrotorilqr_tpu_torch.kernels import stream_fddp as ksf
from quadrotorilqr_tpu_torch.solver import batched
from quadrotorilqr_tpu_torch.solver.fddp import FDDPOptions
from quadrotorilqr_tpu_torch.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)

from test_torch_cuda import DT, problem

OPTIONS = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 6))
# demand twice the predicted reduction with one probe: trip 0 still steps,
# trip 1's search fails (tests/test_solve_stream.py:181-200)
STARVED = ILQROptions(LineSearchParams(0.5, 2.0, 1), ConvergenceCriteria(1e-12, 1e-12, 4))


def assert_identical(got, ref):
    """(Trajectory, cost, iterations, status, ...) tuples, bit for bit."""
    for g, r in zip(got[:4], ref[:4]):
        if hasattr(g, "controls"):
            for a, b in ((g.controls, r.controls), (g.states.pose.quat, r.states.pose.quat),
                         (g.states.pose.trans, r.states.pose.trans), (g.states.vel, r.states.vel)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("options", [OPTIONS, STARVED], ids=["default", "starved"])
def test_streamed_reference_equals_whole(options):
    """Cost-only probes and one apply rollout at the last tried alpha give
    the whole-solve loop's lanes; with the starved search some lanes end at
    LINE_SEARCH_FAILED on the candidate of the alpha they last tried."""
    params, cost, traj = problem("cpu", batch=8, n=5)
    got = kst.solve_fused_streamed(params, cost, traj, DT, options, return_probes=True)
    ref = ks.solve_fused_whole(params, cost, traj, DT, options)
    assert_identical(got, ref)
    passes, probes, applies = got[4:]
    # a probe and an apply sweep per executed trip (the first trip's probe is
    # its forced step); a backward pass also on a pre-converged lane's last trip
    assert bool((applies == got[2]).all()) and bool((probes >= applies).all())
    assert bool((passes >= got[2]).all()) and bool((passes <= got[2] + 1).all())
    if options is STARVED:
        assert bool((got[3] == 2).any())
        assert bool((probes == applies).all())


def test_streamed_refuses_zero_probe_line_search():
    params, cost, traj = problem("cpu", batch=2, n=3)
    zero = ILQROptions(LineSearchParams(0.5, 0.5, 0), OPTIONS.convergence_criteria)
    with pytest.raises(ValueError, match="max_iters must be >= 1"):
        kst.solve_fused_streamed(params, cost, traj, DT, zero)


def test_streamed_fddp_reference_with_no_probes():
    """No line-search probes: every trip rejects, so the streamed schedule
    applies nothing and equals the whole loop (only the mu schedule runs)."""
    params, cost, traj = problem("cpu", batch=4, n=4)
    opts = ILQROptions(LineSearchParams(0.5, 0.5, 0), ConvergenceCriteria(1e-8, 1e-8, 3))
    got = ksf.solve_fddp_streamed(params, cost, traj, DT, opts, return_mu=True, return_probes=True)
    ref = kf.solve_fddp_fused(params, cost, traj, DT, opts, return_mu=True, return_probes=True)
    assert_identical(got, ref)
    for g, r in zip(got[4:7], ref[4:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert bool((got[7] == 0).all())


# ---- horizon routing ----


def _recorder(calls, name):
    def stub(params, cost, traj, dt_s, options, *args, **kwargs):
        calls.append((name, traj.controls.shape[1], kwargs))
        lanes = traj.controls.shape[0]
        iters = torch.full((lanes,), int(options.convergence_criteria.max_iters), dtype=torch.int32)
        if kwargs.get("initial_iters") is not None:
            iters = iters + kwargs["initial_iters"]
        out = (traj, traj.controls[:, 0, 0], iters, torch.zeros(lanes, dtype=torch.int32))
        return out + (torch.full((lanes,), 0.5),) if kwargs.get("return_mu") else out
    return stub


@pytest.fixture
def calls(monkeypatch):
    calls = []
    for name in ("solve_fused_whole", "solve_fused_streamed", "solve_fddp_fused",
                 "solve_fddp_streamed"):
        monkeypatch.setattr(batched, name, _recorder(calls, name))
    return calls


@pytest.mark.parametrize("n", [256, 257])
def test_latency_route_streams_past_256_stages(calls, n):
    params, cost, traj = problem("cpu", batch=2, n=n)
    batched.solve_batch_latency(params, cost, traj, DT, OPTIONS)
    engine = "solve_fused_streamed" if n > 256 else "solve_fused_whole"
    assert [c[:2] for c in calls] == [(engine, n)]


def test_latency_route_sends_zero_probes_to_the_batch_loop(calls, monkeypatch):
    params, cost, traj = problem("cpu", batch=2, n=257)
    seen = []
    monkeypatch.setattr(batched, "solve_batch_fused", lambda *a, **k: seen.append(True))
    zero = ILQROptions(LineSearchParams(0.5, 0.5, 0), OPTIONS.convergence_criteria)
    batched.solve_batch_latency(params, cost, traj, DT, zero)
    assert seen == [True] and calls == []


@pytest.mark.parametrize("n", [231, 232])
def test_fddp_route_streams_past_231_stages(calls, n):
    params, cost, traj = problem("cpu", batch=2, n=n)
    batched.solve_batch_fddp(params, cost, traj, DT, OPTIONS)
    engine = "solve_fddp_streamed" if n > 231 else "solve_fddp_fused"
    assert [c[:2] for c in calls] == [(engine, n)]


@pytest.mark.parametrize("n", [231, 232])
def test_fddp_refine_runs_every_launch_on_one_engine(calls, n):
    """refine="auto" over 12 trips: a Gauss-Newton launch, then an exact-DDP
    launch resumed from its rows, both on the engine of the horizon."""
    params, cost, traj = problem("cpu", batch=2, n=n)
    opts = dataclasses.replace(OPTIONS, convergence_criteria=ConvergenceCriteria(1e-6, 1e-6, 12))
    got = batched.solve_batch_fddp(params, cost, traj, DT, opts, refine="auto")
    engine = "solve_fddp_streamed" if n > 231 else "solve_fddp_fused"
    assert [(c[0], c[1], c[2]["ddp"]) for c in calls] == [(engine, n, False), (engine, n, True)]
    first, second = calls[0][2], calls[1][2]
    assert first["initial_mu"] is None and first["initial_iters"] is None
    torch.testing.assert_close(second["initial_mu"], torch.full((2,), 0.5))
    assert bool((second["initial_iters"] == 5).all()) and bool((got.iterations == 12).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_api_fddp_streams_past_231_stages(calls, dtype):
    """QuadrotorILQR(solver="fddp"): float64 is one streamed launch, float32
    the refine="auto" schedule's two."""
    g = torch.Generator().manual_seed(0)
    _, cost, traj = workloads.long_horizon_problem(g, 2, 232, dtype)
    desired = dataclasses.replace(
        traj, times=traj.times[0], states=cost.desired_states, controls=cost.desired_controls
    )
    opts = dataclasses.replace(OPTIONS, convergence_criteria=ConvergenceCriteria(1e-6, 1e-6, 12))
    api = QuadrotorILQR(
        1.3, torch.eye(3), 0.2, 0.016, 9.81, cost.Q, cost.R, desired, DT, opts, dtype=dtype,
        device="cpu", solver="fddp",
    )
    api.solve_batch(traj)
    assert [c[:2] for c in calls] == [("solve_fddp_streamed", 232)] * (
        1 if dtype == torch.float64 else 2
    )


@pytest.mark.parametrize("ddp", [False, True], ids=["gn", "ddp"])
def test_streamed_fddp_wrapper_equals_whole_and_counts_apply_sweeps(ddp):
    """On CPU tensors the wrapper is the plain loop with the streamed
    schedule: the whole loop's lanes, with Gauss-Newton or exact-DDP
    curvature, and one apply sweep per accepted trip, none for a rejected
    one."""
    params, cost, traj = problem("cpu", batch=4, n=4)
    opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 6))
    out = ksf.solve_fddp_streamed(params, cost, traj, DT, opts, FDDPOptions(), ddp=ddp,
                                  return_mu=True, return_probes=True)
    whole = kf.solve_fddp_fused(params, cost, traj, DT, opts, FDDPOptions(), ddp=ddp,
                                return_mu=True, return_probes=True)
    assert_identical(out, whole)
    for g, r in zip(out[4:7], whole[4:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    applies = out[7]
    # every defect trip after the first follows an accept, whose apply sweep
    # rebuilt the trajectory
    assert bool((applies >= out[6] - 1).all()) and bool((applies <= out[2]).all())
    assert bool((applies > 0).all()) and bool((applies < out[2]).any())
