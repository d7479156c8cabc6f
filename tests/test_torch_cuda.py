"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Float64, B=300 (the last block of 32 threads is ragged) and N=12, with
per-scenario params so the B-strided operand groups are exercised.
Tolerances as chip_smoke.py: backward k, K atol 1e-9 and QuTk, kTQuuk rtol
1e-9; rollout trajectory atol 1e-10 and cost rtol 1e-10; whole solve and
FDDP solve status and iterations equal, cost rtol 1e-8, controls atol 1e-7;
phases resumed from the kernel's own rows bit-equal to one launch. The
streamed kernels also against their whole-solve twins on the card: status
and iterations equal, cost rtol 1e-12, controls atol 1e-10; the per-pass
kernels with lanes masked out (the computed lanes bit-equal to a full
launch), handing their gains over without a copy, and their route
(`solve_batch_fused`) against `solve.cu` at the whole solve's bars; and
every team kernel (csrc/team.cuh) at the edges of its design: B of 1, 37
and 300, horizons of 1, 2 and 40 stages, shared and per-scenario operand
groups. The debug record: `solve.cu`'s recorded launch (cost history,
backward passes and probe sweeps) against its plain version, bit-equal to
the launch without history, and `populate_debug` on the per-pass and
whole-solve routes against the plain loop's.

This file imports no JAX, so the card machine runs it without the JAX
package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quadrotorilqr_tpu_torch import convert
from quadrotorilqr_tpu_torch.kernels import backward as kb
from quadrotorilqr_tpu_torch.kernels import fddp as kf
from quadrotorilqr_tpu_torch.kernels import rollout as kr
from quadrotorilqr_tpu_torch.kernels import solve as ks
from quadrotorilqr_tpu_torch.kernels import stream as kst
from quadrotorilqr_tpu_torch.kernels import stream_fddp as ksf
from quadrotorilqr_tpu_torch.kernels import _build
from quadrotorilqr_tpu_torch.solver.batched import (
    _with_max_iters,
    solve_batch_fddp,
    solve_batch_fddp_refine,
    solve_batch_fused,
    solve_batch_latency,
)
from quadrotorilqr_tpu_torch.solver.ilqr import SolveResult
from quadrotorilqr_tpu_torch.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)

DT = 0.02

# The plain loops dispatch thousands of tiny ops, on which torch's intra-op
# threads only spin (four times the CPU time, and a longer wall time, than
# one thread): one thread runs them faster and leaves the other cores to the
# other test workers.
torch.set_num_threads(1)
B, N = 300, 12


def problem(device, batch=B, n=N, seed=0):
    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((batch, n, 1)), 0.3 * rng.normal(size=(batch, n, 3))], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    des_q = np.zeros((n, 4))
    des_q[:, 0] = 1.0
    scale = 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
    params = SimpleNamespace(
        mass_kg=1.3 * scale,
        inertia=(np.diag([0.4, 0.5, 0.6]) + 0.05) * scale[:, None, None],
        arm_length_m=np.full(batch, 0.2),
        torque_to_thrust_ratio_m=np.full(batch, 0.016),
        g_mpss=np.full(batch, 9.81),
    )
    cost = SimpleNamespace(
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(4),
        desired_states=SimpleNamespace(
            pose=SimpleNamespace(quat=des_q, trans=np.zeros((n, 3))), vel=np.zeros((n, 6))
        ),
        desired_controls=np.full((n, 4), 9.81 / 4),
    )
    traj = SimpleNamespace(
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        states=SimpleNamespace(
            pose=SimpleNamespace(quat=q, trans=0.4 * rng.normal(size=(batch, n, 3))),
            vel=0.2 * rng.normal(size=(batch, n, 6)),
        ),
        controls=9.81 / 4 + 0.5 * rng.normal(size=(batch, n, 4)),
    )
    return (
        convert.params_from_numpy(params, device=device),
        convert.cost_from_numpy(cost, device=device),
        convert.trajectory_from_numpy(traj, device=device),
    )


OPTIONS = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 6))
FDDP_OPTIONS = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 10))


@pytest.fixture(scope="module")
def card_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return problem("cuda")


@pytest.mark.parametrize(
    "wrapper", ["backward", "rollout", "solve", "fddp", "stream", "stream_fddp"]
)
def test_wrappers_raise_off_cpu_and_cuda(wrapper):
    """No fallback: a tensor that is neither on the CPU nor on a CUDA card
    reaches no plain version."""
    params, cost, traj = problem("meta", batch=2, n=3)
    calls = {
        "backward": lambda: kb.backward_pass_fused(params, cost, traj, DT),
        "rollout": lambda: kr.rollout_cost_fused(
            params, cost, traj, traj.controls, traj.controls[..., None].expand(2, 3, 4, 12),
            traj.controls[:, 0, 0], DT,
        ),
        "solve": lambda: ks.solve_fused_whole(params, cost, traj, DT, OPTIONS),
        "fddp": lambda: kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS),
        "stream": lambda: kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS),
        "stream_fddp": lambda: ksf.solve_fddp_streamed(params, cost, traj, DT, FDDP_OPTIONS),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[wrapper]()


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_backward_matches_plain(card_problem):
    params, cost, traj = card_problem
    got = kb.backward_pass_fused(params, cost, traj, DT)
    ref = kb.backward_pass_reference(params, cost, traj, DT)
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-9)
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=1e-9, atol=0)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_rollout_matches_plain(card_problem):
    params, cost, traj = card_problem
    k, big_k, _, _ = kb.backward_pass_reference(params, cost, traj, DT)
    alpha = torch.linspace(0.1, 1.0, B, dtype=torch.float64, device="cuda")
    got_traj, got_cost = kr.rollout_cost_fused(params, cost, traj, k, big_k, alpha, DT)
    ref_traj, ref_cost = kr.rollout_cost_reference(params, cost, traj, k, big_k, alpha, DT)
    for g, r in (
        (got_traj.states.pose.quat, ref_traj.states.pose.quat),
        (got_traj.states.pose.trans, ref_traj.states.pose.trans),
        (got_traj.states.vel, ref_traj.states.vel),
        (got_traj.controls, ref_traj.controls),
    ):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-10)
    torch.testing.assert_close(got_cost, ref_cost, rtol=1e-10, atol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def per_pass_outputs(kernel, params, cost, traj, active=None):
    """The per-pass kernel's outputs as a list of tensors: backward's k, K,
    QuTk, kTQuuk; rollout's trajectory leaves and cost, at per-lane alphas
    on the plain gains."""
    if kernel == "backward":
        return list(kb.backward_pass_fused(params, cost, traj, DT, active=active))
    k, big_k, _, _ = kb.backward_pass_reference(params, cost, traj, DT)
    alpha = torch.linspace(0.1, 1.0, traj.controls.shape[0], dtype=torch.float64, device="cuda")
    t, c = kr.rollout_cost_fused(params, cost, traj, k, big_k, alpha, DT, active=active)
    return [t.states.pose.quat, t.states.pose.trans, t.states.vel, t.controls, c]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["backward", "rollout"])
def test_cuda_per_pass_active_lanes_bit_equal(card_problem, kernel):
    """A launch with lanes masked out computes the others bit for bit as a
    launch over every lane (each team leaves or runs whole)."""
    params, cost, traj = card_problem
    active = torch.arange(B, device="cuda") % 3 != 1
    full = per_pass_outputs(kernel, params, cost, traj)
    part = per_pass_outputs(kernel, params, cost, traj, active)
    for f, p in zip(full, part):
        torch.testing.assert_close(p[active], f[active], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_gains_hand_over_without_copy(card_problem, monkeypatch):
    """backward_pass_fused's ks and Ks are views of one (N, B, 52) buffer,
    which rollout_cost_fused hands to its kernel as it is; gains from
    elsewhere (the plain backward pass) are packed into the layout once,
    with the same result."""
    params, cost, traj = card_problem
    ks, big_ks, _, _ = kb.backward_pass_fused(params, cost, traj, DT)
    assert big_ks.data_ptr() == ks.data_ptr() + 4 * ks.element_size()
    real, seen = _build.launch, []

    def spy(entry, dtype, ptrs, ints, reals, device):
        if entry == "qilqr_rollout":
            seen.append(ptrs[12 + 4])  # after the Problem block and q t v u
        return real(entry, dtype, ptrs, ints, reals, device)

    monkeypatch.setattr(_build, "launch", spy)
    alpha = torch.linspace(0.1, 1.0, B, dtype=torch.float64, device="cuda")
    got = kr.rollout_cost_fused(params, cost, traj, ks, big_ks, alpha, DT)
    packed = kr.rollout_cost_fused(params, cost, traj, ks.clone(), big_ks.clone(), alpha, DT)
    assert seen[0] == ks.data_ptr() and seen[1] != ks.data_ptr()
    torch.testing.assert_close(packed[1], got[1], rtol=0, atol=0)
    torch.testing.assert_close(packed[0].controls, got[0].controls, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["shared", "per_scenario"])
@pytest.mark.parametrize("n", [1, 2, 40])
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("kernel", ["backward", "rollout"])
def test_cuda_per_pass_team_edges(card, kernel, batch, n, groups):
    """The per-pass kernels at B not a multiple of the teams a block holds
    and at horizons shorter and longer than the operand ring, against their
    plain versions at the bars of test_cuda_backward_matches_plain and
    test_cuda_rollout_matches_plain."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    got = per_pass_outputs(kernel, params, cost, traj)
    if kernel == "backward":
        ref = list(kb.backward_pass_reference(params, cost, traj, DT))
        bars = [(0, 1e-9)] * 2 + [(1e-9, 0)] * 2
    else:
        k, big_k, _, _ = kb.backward_pass_reference(params, cost, traj, DT)
        alpha = torch.linspace(0.1, 1.0, batch, dtype=torch.float64, device="cuda")
        t, c = kr.rollout_cost_reference(params, cost, traj, k, big_k, alpha, DT)
        ref = [t.states.pose.quat, t.states.pose.trans, t.states.vel, t.controls, c]
        bars = [(0, 1e-10)] * 4 + [(1e-10, 0)]
    for g, r, (rtol, atol) in zip(got, ref, bars):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_per_pass_route_matches_whole_solve(card_problem):
    """The per-pass route (`solve_batch_fused`: one backward and one rollout
    launch at a time, the loop on the host) against `solve.cu` through
    `solve_batch_latency`, at the whole solve's bars against plain: status
    and iterations equal, cost rtol 1e-8, controls atol 1e-7. The two run
    the same reverse and rollout sweeps; the trip logic's sums may round
    apart, so lanes need not be bit-equal (the count is printed)."""
    params, cost, traj = card_problem
    got = solve_batch_fused(params, cost, traj, DT, OPTIONS)
    ref = solve_batch_latency(params, cost, traj, DT, OPTIONS)
    assert_same_lanes(got, ref)
    bits = (
        (got.status == ref.status) & (got.iterations == ref.iterations) & (got.cost == ref.cost)
        & (got.trajectory.controls == ref.trajectory.controls).flatten(1).all(1)
    )
    print(f"per-pass route bit-equal to solve.cu on {int(bits.sum())} of {B} lanes")


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_whole_solve_matches_plain(card_problem):
    params, cost, traj = card_problem
    got = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS)
    ref = ks.solve_whole_reference(params, cost, traj, DT, OPTIONS)
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=0)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-8, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)


def assert_same_lanes(got, ref):
    torch.testing.assert_close(got.status, ref.status, rtol=0, atol=0)
    torch.testing.assert_close(got.iterations, ref.iterations, rtol=0, atol=0)
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-8, atol=0)
    torch.testing.assert_close(got.trajectory.controls, ref.trajectory.controls, rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_fddp_matches_plain(card_problem):
    params, cost, traj = card_problem
    got = kf.solve_fddp_fused(
        params, cost, traj, DT, FDDP_OPTIONS, return_mu=True, return_probes=True
    )
    ref = kf.solve_fddp_whole_reference(params, cost, traj, DT, FDDP_OPTIONS, kf.fddp.FDDPOptions())
    for g, r in zip(got[2:4] + got[6:], ref[2:4] + ref[6:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    for g, r in zip((got[1], got[4], got[5]), (ref[1], ref[4], ref[5])):
        torch.testing.assert_close(g, r, rtol=1e-8, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_fddp_ddp_matches_plain(card_problem):
    """Exact curvature, at the bar the JAX package holds its own DDP engines
    to (tests/test_fddp_fused.py:382-416): ~1e-16 differences in the closed
    forms can send a lane near an accept or budget edge down another retry
    path, so statuses agree on >= 98% and iterations on >= 95% of lanes,
    lanes that agree and converge match cost to 1e-8 and controls to 1e-4,
    and every lane's cost to 2e-4."""
    params, cost, traj = card_problem
    got = kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS, ddp=True)
    ref = kf.solve_fddp_whole_reference(
        params, cost, traj, DT, FDDP_OPTIONS, kf.fddp.FDDPOptions(), True
    )
    same = (got[3] == ref[3]) & (got[2] == ref[2])
    assert (got[3] == ref[3]).double().mean() >= 0.98 and same.double().mean() >= 0.95
    strict = same & (ref[3] == 1)
    rel = (got[1] - ref[1]).abs() / ref[1].abs()
    assert rel[strict].max() <= 1e-8 and rel.max() < 2e-4
    du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
    assert du[strict].max() <= 1e-4


def assert_bit_equal(got, ref):
    for g, r in zip(
        (got.status, got.iterations, got.cost, got.trajectory.controls),
        (ref.status, ref.iterations, ref.cost, ref.trajectory.controls),
    ):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_fddp_two_phases_equal_one(card_problem):
    """Resume rows: a launch of 3 trips, then one of the rest from its mu,
    status and iterations, gives the bits of one 10-trip launch."""
    params, cost, traj = card_problem
    one = solve_batch_fddp(params, cost, traj, DT, FDDP_OPTIONS)
    first = kf.solve_fddp_fused(params, cost, traj, DT, _with_max_iters(FDDP_OPTIONS, 3), return_mu=True)
    assert bool((first[3] == 0).any())
    rest = kf.solve_fddp_fused(
        params, cost, first[0], DT, _with_max_iters(FDDP_OPTIONS, 7),
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
    )
    assert_bit_equal(SolveResult(*rest), one)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_fddp_hybrid_refine_equals_phase_by_phase(card_problem):
    """The hybrid schedule runs as two launches (Gauss-Newton up to the
    switch, exact DDP after it); launching each of its five phases on its
    own, resumed from the last, gives the same bits."""
    params, cost, traj = card_problem
    bounds, flags = (2, 4, 6, 8), (False, False, True, True, True)
    got = solve_batch_fddp_refine(params, cost, traj, DT, FDDP_OPTIONS, phase1_iters=bounds, ddp=flags)
    edges = (0,) + bounds + (10,)
    out = (traj, None, None, None, None)
    for lo, hi, flag in zip(edges, edges[1:], flags):
        out = kf.solve_fddp_fused(
            params, cost, out[0], DT, _with_max_iters(FDDP_OPTIONS, hi - lo), ddp=flag,
            initial_mu=out[4], initial_status=out[3], initial_iters=out[2], return_mu=True,
        )
    assert_bit_equal(got, SolveResult(*out[:4]))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_fddp_zero_probes_matches_plain(card_problem):
    """No line-search probes: every trip rejects and the mu schedule runs,
    on the kernel as in the plain loop."""
    params, cost, traj = card_problem
    opts = ILQROptions(LineSearchParams(0.5, 0.5, 0), ConvergenceCriteria(1e-8, 1e-8, 5))
    got = kf.solve_fddp_fused(params, cost, traj, DT, opts, return_mu=True, return_probes=True)
    ref = kf.solve_fddp_whole_reference(params, cost, traj, DT, opts, kf.fddp.FDDPOptions())
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(got[0].controls, traj.controls, rtol=0, atol=0)


def assert_twins(got, ref):
    """A streamed kernel against its whole-solve twin on the same inputs."""
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=0)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("starved", [False, True], ids=["default", "starved"])
def test_cuda_stream_matches_plain_and_whole(card_problem, starved):
    """stream.cu against its plain version and solve.cu; the starved line
    search (one probe, twice the predicted reduction) ends lanes at
    LINE_SEARCH_FAILED on the candidate of the alpha they last tried."""
    params, cost, traj = card_problem
    opts = OPTIONS
    if starved:
        opts = ILQROptions(LineSearchParams(0.5, 2.0, 1), ConvergenceCriteria(1e-12, 1e-12, 4))
    got = kst.solve_fused_streamed(params, cost, traj, DT, opts, return_probes=True)
    ref = kst.solve_streamed_reference(params, cost, traj, DT, opts)
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-8, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)
    assert_twins(got, ks.solve_fused_whole(params, cost, traj, DT, opts))
    assert bool((got[3] == 2).any()) == starved


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_stream_fddp_matches_plain_and_whole(card_problem):
    params, cost, traj = card_problem
    got = ksf.solve_fddp_streamed(
        params, cost, traj, DT, FDDP_OPTIONS, return_mu=True, return_probes=True
    )
    ref = ksf.solve_fddp_streamed_reference(params, cost, traj, DT, FDDP_OPTIONS, kf.fddp.FDDPOptions())
    for g, r in zip(got[2:4] + got[6:], ref[2:4] + ref[6:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    for g, r in zip((got[1], got[4], got[5]), (ref[1], ref[4], ref[5])):
        torch.testing.assert_close(g, r, rtol=1e-8, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)
    assert_twins(got, kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_stream_fddp_two_phases_equal_one(card_problem):
    """Resume rows on the streamed kernel: 3 trips, then 7 from their mu,
    status and iterations, give the bits of one 10-trip launch."""
    params, cost, traj = card_problem
    one = ksf.solve_fddp_streamed(params, cost, traj, DT, FDDP_OPTIONS)
    first = ksf.solve_fddp_streamed(
        params, cost, traj, DT, _with_max_iters(FDDP_OPTIONS, 3), ddp=False, return_mu=True
    )
    assert bool((first[3] == 0).any())
    rest = ksf.solve_fddp_streamed(
        params, cost, first[0], DT, _with_max_iters(FDDP_OPTIONS, 7),
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
    )
    assert_bit_equal(SolveResult(*rest), SolveResult(*one))


# ---- the team design (csrc/team.cuh) at its edges ----
# B not a multiple of the teams a block holds (1, 37, 300), horizons shorter
# than the operand ring (N = 1, 2) and longer (40), and the cost operand
# groups shared (B-stride 0) or per scenario (B-stride 1); each kernel held
# against its plain version at the bars above. The whole-solve kernels and
# their streamed twins share each plain result (`plain`): the streamed plain
# loops give the whole ones' bits (tests/test_torch_stream.py).


@pytest.fixture(scope="module")
def plain():
    """The plain results of the edge cases, computed once per case:
    plain(key, fn) returns fn() the first time `key` is asked for."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


def edge_problem(batch, n, per_scenario):
    """problem() on the card; with `per_scenario` every scenario gets its
    own Q, R and desired trajectory."""
    params, cost, traj = problem("cuda", batch=batch, n=n, seed=batch + n)
    if not per_scenario:
        return params, cost, traj
    rng = np.random.default_rng(batch)
    des_q = np.concatenate([np.ones((batch, n, 1)), 0.05 * rng.normal(size=(batch, n, 3))], -1)
    des_q /= np.linalg.norm(des_q, axis=-1, keepdims=True)
    w = 1.0 + 0.3 * rng.uniform(size=(batch, 12))
    per = SimpleNamespace(
        Q=np.stack([np.diag(np.concatenate([100.0 * wi[:6], wi[6:]])) for wi in w]),
        R=np.eye(4) * (1.0 + 0.1 * rng.uniform(size=(batch, 1, 1))),
        desired_states=SimpleNamespace(
            pose=SimpleNamespace(quat=des_q, trans=0.05 * rng.normal(size=(batch, n, 3))),
            vel=np.zeros((batch, n, 6)),
        ),
        desired_controls=np.full((batch, n, 4), 9.81 / 4),
    )
    return params, convert.cost_from_numpy(per, device="cuda"), traj


def assert_lanes(got, ref, rtol=1e-8):
    """Status, iterations and the per-lane counts equal; cost within rtol,
    controls within 1e-7."""
    for g, r in zip(got[2:4] + got[4:], ref[2:4] + ref[4:]):
        if g.is_floating_point():
            torch.testing.assert_close(g, r, rtol=rtol, atol=0)
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=rtol, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["shared", "per_scenario"])
@pytest.mark.parametrize("n", [1, 2, 40])
@pytest.mark.parametrize("batch", [1, 37, 300])
def test_cuda_stream_team_edges(card, plain, batch, n, groups):
    """stream.cu against its plain version, lane for lane, with its
    backward-pass, probe and apply counts."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    got = kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS, return_probes=True)
    ref = plain(("exact", batch, n, groups),
                lambda: kst.solve_streamed_reference(params, cost, traj, DT, OPTIONS))
    assert_lanes(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["shared", "per_scenario"])
@pytest.mark.parametrize("n", [1, 2, 40])
@pytest.mark.parametrize("batch", [1, 37, 300])
def test_cuda_solve_team_edges(card, plain, batch, n, groups):
    """solve.cu against its plain version, lane for lane, and bit-equal to
    stream.cu: the candidate stored by each probe is the trajectory
    stream.cu's apply sweep writes."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    got = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS)
    ref = plain(("exact", batch, n, groups),
                lambda: kst.solve_streamed_reference(params, cost, traj, DT, OPTIONS))
    assert_lanes(got, ref[:4])
    assert_bit_equal(SolveResult(*got),
                     SolveResult(*kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gauss_newton", "ddp", "zero_probes"])
@pytest.mark.parametrize("groups", ["shared", "per_scenario"])
@pytest.mark.parametrize("batch,n", [(1, 2), (37, 40), (300, 2), (300, 40)])
def test_cuda_stream_fddp_team_edges(card, plain, batch, n, groups, case):
    """stream_fddp.cu against its plain version: Gauss-Newton lane for lane
    with its probe, defect-trip and apply counts; exact DDP at the DDP
    engines' bar (test_cuda_fddp_ddp_matches_plain); no line-search probes
    (every trip rejects, the mu schedule runs) with its counts equal and the
    cost within 1e-12. At N=2 the line-searched cases run one trip: once
    a 2-stage lane has taken its full step its predicted change dJ is
    ~1e-15, so whether the next Goldstein probe is accepted depends on the
    last bits of the cost sums, which differ between any two engines: there
    fddp.cu, and the per-thread streamed kernel this design replaced, agree
    with plain on about half of 300 lanes too."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    opts, ddp = fddp_edge_options(n, case)
    got = ksf.solve_fddp_streamed(
        params, cost, traj, DT, opts, ddp=ddp, return_mu=True, return_probes=True
    )
    ref = plain(("fddp", batch, n, groups, case), lambda: ksf.solve_fddp_streamed_reference(
        params, cost, traj, DT, opts, kf.fddp.FDDPOptions(), ddp))
    assert_fddp_edge(got, ref, traj, case)


def fddp_edge_options(n, case):
    """(options, ddp) of an FDDP edge case. At N=2 the line-searched cases
    run one trip (test_cuda_stream_fddp_team_edges)."""
    if case == "zero_probes":
        return ILQROptions(LineSearchParams(0.5, 0.5, 0), ConvergenceCriteria(1e-8, 1e-8, 5)), False
    return (FDDP_OPTIONS if n > 2 else _with_max_iters(FDDP_OPTIONS, 1)), case == "ddp"


def assert_fddp_edge(got, ref, traj, case):
    """An FDDP kernel's result against the plain loop's at the bar of its
    case; the counts compared are those both results carry."""
    if case == "gauss_newton":
        assert_lanes(got, ref)
    elif case == "zero_probes":
        assert_lanes(got, ref, rtol=1e-12)
        torch.testing.assert_close(got[0].controls, traj.controls, rtol=0, atol=0)
    else:
        same = (got[3] == ref[3]) & (got[2] == ref[2])
        assert (got[3] == ref[3]).double().mean() >= 0.98 and same.double().mean() >= 0.95
        strict = same & (ref[3] == 1)
        rel = (got[1] - ref[1]).abs() / ref[1].abs()
        assert rel.max() < 2e-4
        if strict.any():
            du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
            assert rel[strict].max() <= 1e-8 and du[strict].max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gauss_newton", "ddp", "zero_probes", "resumed"])
@pytest.mark.parametrize("groups", ["shared", "per_scenario"])
@pytest.mark.parametrize("batch,n", [(1, 2), (37, 40), (300, 2), (300, 40)])
def test_cuda_fddp_team_edges(card, plain, batch, n, groups, case):
    """fddp.cu against its plain version at the bars of
    test_cuda_stream_fddp_team_edges, with its probe and defect-trip counts,
    and against stream_fddp.cu at the twin bar (status and iterations equal,
    cost rtol 1e-12, controls atol 1e-10): the two run one reverse sweep,
    line search and gap sweep. `resumed`: a launch of 3 trips, then one of
    the other 7 from its mu, status and iterations, gives the bits of one
    launch of 10."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    if case == "resumed":
        one = kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS)
        first = kf.solve_fddp_fused(
            params, cost, traj, DT, _with_max_iters(FDDP_OPTIONS, 3), return_mu=True
        )
        rest = kf.solve_fddp_fused(
            params, cost, first[0], DT, _with_max_iters(FDDP_OPTIONS, 7),
            initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
        )
        assert_bit_equal(SolveResult(*rest), SolveResult(*one))
        return
    opts, ddp = fddp_edge_options(n, case)
    got = kf.solve_fddp_fused(
        params, cost, traj, DT, opts, ddp=ddp, return_mu=True, return_probes=True
    )
    ref = plain(("fddp", batch, n, groups, case), lambda: ksf.solve_fddp_streamed_reference(
        params, cost, traj, DT, opts, kf.fddp.FDDPOptions(), ddp))
    assert_fddp_edge(got, ref[:7], traj, case)
    assert_twins(got, ksf.solve_fddp_streamed(params, cost, traj, DT, opts, ddp=ddp))


# ---- the debug record on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,groups", [(37, 40, "shared"), (300, 40, "per_scenario")])
def test_cuda_solve_history_and_probes_match_plain(card, plain, batch, n, groups):
    """solve.cu's recorded launch (`return_history`, `return_probes`)
    against its plain version: the solution lane for lane, the history's
    zero slots equal and its costs at the cost's rtol (1e-8), the backward
    passes and probe sweeps equal, and the counts equal to stream.cu's."""
    params, cost, traj = edge_problem(batch, n, groups == "per_scenario")
    got = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS, return_history=True,
                               return_probes=True)
    ref = plain(("whole", batch, n, groups),
                lambda: ks.solve_whole_reference(params, cost, traj, DT, OPTIONS))
    assert_lanes(got[:4], ref[:4])
    assert got[4].shape == (batch, int(OPTIONS.convergence_criteria.max_iters))
    torch.testing.assert_close(got[4] == 0, ref[4] == 0, rtol=0, atol=0)
    torch.testing.assert_close(got[4], ref[4], rtol=1e-8, atol=0)
    for g, r in zip(got[5:], ref[5:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    streamed = kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS, return_probes=True)
    for g, r in zip(got[5:], streamed[4:6]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_solve_history_launch_bit_equal(card_problem):
    """The recorded launch leaves the bits of the launch without history,
    and each lane's last valid history slot is its final cost."""
    params, cost, traj = card_problem
    plain_launch = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS)
    got = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS, return_history=True,
                               return_probes=True)
    assert_bit_equal(SolveResult(*got[:4]), SolveResult(*plain_launch))
    for g, r in ((got[0].states.pose.quat, plain_launch[0].states.pose.quat),
                 (got[0].states.pose.trans, plain_launch[0].states.pose.trans),
                 (got[0].states.vel, plain_launch[0].states.vel)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    iters = got[2].long()
    lanes = torch.nonzero(iters > 0).flatten()
    last = got[4][lanes, iters[lanes] - 1]
    torch.testing.assert_close(last, got[1][lanes], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_debug_routes_match_plain(card_problem):
    """`populate_debug` on the per-pass route (`backward.cu`, `rollout.cu`:
    the IterDebug) against the plain loop's IterDebug (valid slots equal,
    costs rtol 1e-8, snapshots' controls atol 1e-7), and on the whole-solve
    route (`solve.cu`: a CostHistory) against the same buffers."""
    from quadrotorilqr_tpu_torch.solver import ilqr

    params, cost, traj = card_problem
    opts = ILQROptions(OPTIONS.line_search_params, OPTIONS.convergence_criteria,
                       populate_debug=True)
    got = solve_batch_fused(params, cost, traj, DT, opts)
    latency = solve_batch_latency(params, cost, traj, DT, opts)
    ref = ilqr.solve(params, cost, traj, DT, opts)
    assert_same_lanes(got, ref)
    assert type(got.debug).__name__ == "IterDebug"
    assert type(latency.debug).__name__ == "CostHistory"
    for debug in (got.debug, latency.debug):
        torch.testing.assert_close(debug.valid, ref.debug.valid, rtol=0, atol=0)
        torch.testing.assert_close(debug.costs, ref.debug.costs, rtol=1e-8, atol=0)
    torch.testing.assert_close(got.debug.trajectories.controls, ref.debug.trajectories.controls,
                               rtol=0, atol=1e-7)
    assert int(ref.debug.valid.sum()) == int(ref.iterations.sum())
