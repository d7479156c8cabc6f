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
whole-solve routes against the plain loop's. The box and weights variants
(control limits and stage weights) of backward.cu, rollout.cu and solve.cu
at float64, B=300, N=40 against their plain versions, their per-pass route
against solve.cu, unit weights against none, and BASELINE config 4 through
`app.mpc.run_mpc`: both routes in float64, and the quality checks of its
constrained variant in float32 at fleet 128. The model families (the SE(3)
wrench, u = 6, and the 6- and 8-rotor multirotors): each family's
instantiation of backward.cu, rollout.cu, solve.cu and stream.cu against
its plain version at the bars above, stream.cu and the per-pass route
bit-equal to solve.cu, the team edges, a 4-rotor multirotor bit-equal to the
quadrotor, and the requests their kernels refuse. The box and weights
variants of fddp.cu, stream_fddp.cu (with and without exact DDP) and
stream.cu at float64, B=300, N=12 against their plain versions (exact DDP
at the DDP engines' bar), the streamed kernels bit-equal to their
whole-solve twins, also at 256 stages for stream.cu.

This file imports no JAX, so the card machine runs it without the JAX
package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
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
from quadrotorilqr_tpu_torch.models.multirotor import MultirotorParams
from quadrotorilqr_tpu_torch.solver import constrained
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


# ---- the box and weights variants and the MPC loop (BASELINE config 4) ----

VARIANT_CASES = ["shared", "per_scenario", "wide"]


@pytest.fixture(scope="module")
def variant_problem():
    """float64, B=300, N=40 (problem()) with each case's limits and stage
    weights: shared bounds (0, 2.9) with (N,) weights [1, ..., 1, 20],
    per-scenario (B, 4) bounds with (B, N) weights, and wide bounds with
    unit weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, cost, traj = problem("cuda", batch=B, n=40, seed=40)
    rng = np.random.default_rng(41)
    on = dict(dtype=torch.float64, device="cuda")
    w_n = torch.ones(40, **on)
    w_n[-1] = 20.0
    hover = 9.81 / 4
    cases = {
        "shared": ((0.0, 2.9), w_n),
        "per_scenario": (
            (torch.as_tensor(hover - rng.uniform(0.2, 0.6, size=(B, 4)), **on),
             torch.as_tensor(hover + rng.uniform(0.2, 0.6, size=(B, 4)), **on)),
            torch.as_tensor(rng.uniform(0.5, 2.0, size=(B, 40)), **on),
        ),
        "wide": ((-1e6, 1e6), torch.ones(40, **on)),
    }
    return params, cost, traj, cases


def variant_case(variant_problem, case):
    params, cost, traj, cases = variant_problem
    limits, weights = cases[case]
    return params, dataclasses.replace(cost, stage_weights=weights), traj, limits


def assert_in_box(u, limits):
    lo, hi = constrained.prep_limits(limits, u.shape[0], u.dtype, u.device, u.shape[-1])
    lo, hi = (b[:, None] if b.ndim == 2 else b for b in (lo, hi))
    assert bool(((u >= lo) & (u <= hi)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANT_CASES)
@pytest.mark.parametrize("kernel", ["backward", "rollout", "solve"])
def test_cuda_variants_match_plain(variant_problem, kernel, case):
    """The box and weights instantiations of backward.cu, rollout.cu and
    solve.cu against their plain versions (solver/constrained.py's box-QP
    and clamped rollout, the weighted cost), at the bars of the kernels
    without them; every produced control inside its box."""
    params, cost, traj, limits = variant_case(variant_problem, case)
    if kernel == "backward":
        got = kb.backward_pass_fused(params, cost, traj, DT, limits=limits)
        ref = kb.backward_pass_reference(params, cost, traj, DT, 0.0, limits)
        for g, r in zip(got[:2], ref[:2]):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-9)
        for g, r in zip(got[2:], ref[2:]):
            torch.testing.assert_close(g, r, rtol=1e-9, atol=0)
    elif kernel == "rollout":
        k, big_k, _, _ = kb.backward_pass_reference(params, cost, traj, DT, 0.0, limits)
        alpha = torch.linspace(0.1, 1.0, B, dtype=torch.float64, device="cuda")
        got_t, got_c = kr.rollout_cost_fused(params, cost, traj, k, big_k, alpha, DT, limits=limits)
        ref_t, ref_c = kr.rollout_cost_reference(params, cost, traj, k, big_k, alpha, DT, limits)
        torch.testing.assert_close(got_t.controls, ref_t.controls, rtol=0, atol=1e-10)
        torch.testing.assert_close(got_t.states.pose.trans, ref_t.states.pose.trans, rtol=0,
                                   atol=1e-10)
        torch.testing.assert_close(got_c, ref_c, rtol=1e-10, atol=0)
        assert_in_box(got_t.controls, limits)
    else:
        got = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS, limits=limits)
        ref = ks.solve_whole_reference(params, cost, traj, DT, OPTIONS, limits)
        assert_same_lanes(SolveResult(*got), SolveResult(*ref[:4]))
        assert_in_box(got[0].controls, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANT_CASES)
def test_cuda_variant_per_pass_route_matches_whole_solve(variant_problem, case):
    """The per-pass route with limits and weights against solve.cu's
    variant, and solve.cu's recorded variant bit-equal to its launch
    without the record."""
    params, cost, traj, limits = variant_case(variant_problem, case)
    whole = solve_batch_latency(params, cost, traj, DT, OPTIONS, limits=limits)
    assert_same_lanes(solve_batch_fused(params, cost, traj, DT, OPTIONS, limits=limits), whole)
    rec = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS, limits=limits,
                               return_history=True, return_probes=True)
    assert_bit_equal(SolveResult(*rec[:4]), whole)


@pytest.mark.cuda
def test_cuda_unit_weights_and_unconstrained_instantiations(variant_problem):
    """Unit weights leave solve.cu's trajectory, status and iterations
    bit-equal to no weights (the cost sums w (dx'Q dx + du'R du), so it
    agrees to rounding); without limits or weights solve.cu runs the
    instantiation without variants, bit-equal to stream.cu's."""
    params, cost, traj, _ = variant_problem
    unit = dataclasses.replace(cost, stage_weights=torch.ones(40, dtype=torch.float64,
                                                              device="cuda"))
    base = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS)
    got = ks.solve_fused_whole(params, unit, traj, DT, OPTIONS)
    for g, r in ((got[2], base[2]), (got[3], base[3]), (got[0].controls, base[0].controls),
                 (got[0].states.pose.trans, base[0].states.pose.trans)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[1], base[1], rtol=1e-14, atol=0)
    streamed = kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS)
    assert_bit_equal(SolveResult(*base), SolveResult(*streamed))


def mpc_problem(fleet, dtype, ticks):
    from quadrotorilqr_tpu_torch.app import workloads

    return workloads.mpc_hover_problem(np.random.default_rng(4), fleet, 50, ticks, 0.01, dtype,
                                       "cuda")


def run_mpc(pb, ticks, latency, limits=True, weights=True):
    from quadrotorilqr_tpu_torch.app import mpc

    return mpc.run_mpc(
        pb.params, pb.q, pb.r, pb.desired, pb.x0, ticks, 50, 0.01, pb.options,
        latency_kernel=latency, stage_weights=pb.stage_weights if weights else None,
        limits=pb.limits if limits else None, plant_params=pb.plant,
    )


@pytest.mark.cuda
def test_cuda_run_mpc_routes_agree_f64(card):
    """run_mpc with limits and terminal weights on solve.cu and on the
    per-pass kernels, float64, fleet 37, 10 ticks: every tick's status and
    iterations equal, costs rtol 1e-8, applied controls atol 1e-7."""
    pb = mpc_problem(37, torch.float64, 10)
    whole, loop = run_mpc(pb, 10, True), run_mpc(pb, 10, False)
    for key in ("status", "iterations"):
        torch.testing.assert_close(loop[key], whole[key], rtol=0, atol=0)
    torch.testing.assert_close(loop["cost"], whole["cost"], rtol=1e-8, atol=0)
    torch.testing.assert_close(loop["u"], whole["u"], rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_cuda_config4_constrained_quality(card):
    """chip_smoke.py's config 4 checks on solve.cu at fleet 128, float32,
    100 ticks: every applied control in [0, 2.9], the upper bound binding on
    some tick, the mean final position error below 0.8x the initial one,
    and with the terminal weight below 1.5x the run without it."""
    pb = mpc_problem(128, torch.float32, 100)
    out = run_mpc(pb, 100, True)
    base = run_mpc(pb, 100, True, weights=False)
    u = out["u"]
    hi = torch.tensor(2.9, dtype=torch.float32, device="cuda")
    assert float(u.min()) >= 0.0 and bool((u <= hi).all()) and bool((u == hi).any())
    err = lambda o: float(o["x_final"].pose.trans.norm(dim=-1).mean())
    assert err(out) < 0.8 * float(pb.x0.pose.trans.norm(dim=-1).mean())
    assert err(out) < 1.5 * err(base)


# ---- the box and weights variants of fddp.cu, stream_fddp.cu and stream.cu ----

ROBUST_VARIANT_CASES = ["box", "weights", "both"]


@pytest.fixture(scope="module")
def robust_variants():
    """problem() (float64, B=300, N=12, per-scenario params) with
    per-scenario (B, 4) bounds around the hover thrust and (B, N) stage
    weights U(0.5, 2) with a terminal 20, by case: the bounds, the weights,
    or both; and the plain FDDP loop's results by (case, ddp), computed once
    (the streamed plain loop gives the whole one's bits,
    tests/test_torch_variants.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, cost, traj = problem("cuda", seed=50)
    rng = np.random.default_rng(51)
    on = dict(dtype=torch.float64, device="cuda")
    hover = 9.81 * 1.3 / 4
    bounds = (torch.as_tensor(hover - rng.uniform(0.3, 0.8, size=(B, 4)), **on),
              torch.as_tensor(hover + rng.uniform(0.3, 0.8, size=(B, 4)), **on))
    w = rng.uniform(0.5, 2.0, size=(B, N))
    w[:, -1] = 20.0
    w = torch.as_tensor(w, **on)
    cases = {"box": (bounds, None), "weights": (None, w), "both": (bounds, w)}
    plain = {}

    def get(case, ddp):
        limits, weights = cases[case]
        c = dataclasses.replace(cost, stage_weights=weights)
        if (case, ddp) not in plain:
            plain[(case, ddp)] = kf.solve_fddp_whole_reference(
                params, c, traj, DT, FDDP_OPTIONS, kf.fddp.FDDPOptions(), ddp, limits=limits)
        return params, c, traj, limits, plain[(case, ddp)]

    return get


def tie_lanes(got, ref):
    """(same, tie): (B,) bool each. `same`: status and iterations equal. A
    `tie` differs in them with its final cost equal to 1e-12: with a box
    (and with exact DDP) a lane can reach a step whose predicted change is
    at the rounding of its cost, and whether the line search takes it is
    the rounding's call, in the plain loop as in the kernels; the lane ends
    on the same solution, its status, iterations, mu and counts told
    differently."""
    same = (got[3] == ref[3]) & (got[2] == ref[2])
    tie = ~same & ((got[1] - ref[1]).abs() <= 1e-12 * ref[1].abs())
    return same, tie


def assert_ddp_bar(got, ref):
    """test_cuda_fddp_ddp_matches_plain's bar (the JAX package's own between
    its DDP engines), a tie (`tie_lanes`) counted as agreeing."""
    same, tie = tie_lanes(got, ref)
    agree = same | tie
    assert ((got[3] == ref[3]) | tie).double().mean() >= 0.98 and agree.double().mean() >= 0.95
    strict = same & (ref[3] == 1)
    rel = (got[1] - ref[1]).abs() / ref[1].abs()
    assert rel.max() < 2e-4
    if bool(strict.any()):
        du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
        assert rel[strict].max() <= 1e-8 and du[strict].max() <= 1e-4


def assert_variant_lanes(got, ref, rtol=1e-8, atol=1e-6):
    """Every lane the same as plain (status and iterations) or a tie
    (`tie_lanes`); cost within rtol and controls within atol on every lane.
    With a box a converging lane's last steps can be rounding-sized, so
    the controls along directions its cost barely sees settle ~1e-7 apart
    between two engines whose costs agree to the rounding; without the
    variants the kernels hold 1e-7."""
    same, tie = tie_lanes(got, ref)
    assert bool((same | tie).all())
    torch.testing.assert_close(got[1], ref[1], rtol=rtol, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=atol)


def assert_fddp_twins(got, ref, ddp):
    """stream_fddp.cu against fddp.cu: bit-equal in Gauss-Newton; with exact
    DDP (whose closed forms the two team sizes evaluate in different
    orders) every lane the same or a tie, cost rtol 1e-12."""
    if not ddp:
        assert_bit_equal(SolveResult(*got[:4]), SolveResult(*ref[:4]))
        return
    assert_variant_lanes(got[:4], ref[:4], rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("ddp", [False, True], ids=["gauss_newton", "ddp"])
@pytest.mark.parametrize("case", ROBUST_VARIANT_CASES)
@pytest.mark.parametrize("kernel", ["fddp", "stream_fddp"])
def test_cuda_fddp_variants_match_plain(robust_variants, kernel, case, ddp):
    """The box and weights instantiations of fddp.cu and stream_fddp.cu
    (with and without kDdp) against the plain FDDP loop with the same
    bounds and weights: Gauss-Newton lane for lane (`assert_variant_lanes`:
    a lane whose bookkeeping differs must end on the same cost to 1e-12),
    exact DDP at the DDP engines' bar; every control in its box;
    stream_fddp.cu against fddp.cu (`assert_fddp_twins`)."""
    params, cost, traj, limits, ref = robust_variants(case, ddp)
    solve = kf.solve_fddp_fused if kernel == "fddp" else ksf.solve_fddp_streamed
    got = solve(params, cost, traj, DT, FDDP_OPTIONS, ddp=ddp, limits=limits, return_mu=True,
                return_probes=True)
    if ddp:
        assert_ddp_bar(got, ref)
    else:
        assert_variant_lanes(got, ref)
    if limits is not None:
        assert_in_box(got[0].controls, limits)
    if kernel == "stream_fddp":
        whole = kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS, ddp=ddp, limits=limits)
        assert_fddp_twins(got, whole, ddp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROBUST_VARIANT_CASES)
def test_cuda_stream_variants_match_plain_and_solve(robust_variants, case):
    """stream.cu's box and weights instantiations against the streamed plain
    loop (status, iterations and every count equal, cost rtol 1e-8, controls
    atol 1e-7) and bit-equal to solve.cu's."""
    params, cost, traj, limits, _ = robust_variants(case, False)
    got = kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS, limits=limits,
                                   return_probes=True)
    ref = kst.solve_streamed_reference(params, cost, traj, DT, OPTIONS, limits=limits)
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-8, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=1e-7)
    if limits is not None:
        assert_in_box(got[0].controls, limits)
    whole = ks.solve_fused_whole(params, cost, traj, DT, OPTIONS, limits=limits)
    assert_bit_equal(SolveResult(*got[:4]), SolveResult(*whole))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["stream_solve_n256", "fddp_twins_n40"])
def test_cuda_box_weights_twins_bit_equal(card, pair):
    """chip_smoke's twins with limits and weights: stream.cu bit-equal to
    solve.cu at 256 stages (the route point), and stream_fddp.cu against
    fddp.cu at 40 (`assert_fddp_twins`), Gauss-Newton and exact DDP."""
    n = 256 if pair == "stream_solve_n256" else 40
    params, cost, traj = problem("cuda", batch=37, n=n, seed=52)
    w = torch.ones(n, dtype=torch.float64, device="cuda")
    w[-1] = 20.0
    cost = dataclasses.replace(cost, stage_weights=w)
    limits = (0.0, 4.0)
    if pair == "stream_solve_n256":
        got = kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS, limits=limits)
        assert_bit_equal(SolveResult(*got),
                         SolveResult(*ks.solve_fused_whole(params, cost, traj, DT, OPTIONS,
                                                           limits=limits)))
        return
    for ddp in (False, True):
        got = ksf.solve_fddp_streamed(params, cost, traj, DT, FDDP_OPTIONS, ddp=ddp, limits=limits)
        ref = kf.solve_fddp_fused(params, cost, traj, DT, FDDP_OPTIONS, ddp=ddp, limits=limits)
        assert_fddp_twins(got, ref, ddp)


# ---- the wider-control model families: the wrench (u = 6) and the 6- and
# 8-rotor multirotors on backward.cu, rollout.cu, solve.cu and stream.cu ----

# the C entries' suffixes of the families other than the quadrotor
FAMILY_SUFFIXES = [sfx for sfx in _build.FAMILIES if sfx]


def family_problem(device, suffix, batch=B, n=N, seed=3, shared=False):
    """A problem of the family of a kernel suffix: random stages around the
    family's hover control, per-scenario params (masses, inertias, and the
    rotors' yaw ratios) or shared ones, an R with off-diagonal terms."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((batch, n, 1)), 0.3 * rng.normal(size=(batch, n, 3))], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    des_q = np.zeros((n, 4))
    des_q[:, 0] = 1.0
    scale = 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
    p = dict(inertia=(np.diag([0.4, 0.5, 0.6]) + 0.03) * scale[:, None, None],
             g_mpss=np.full(batch, 9.81))
    if suffix == "_wrench":
        u, hover = 6, np.array([0.0, 0.0, 1.3 * 9.81, 0.0, 0.0, 0.0])
        p["mass_kg"] = 1.3 * scale
    else:
        u = int(suffix[len("_rotor"):])
        hover = np.full(u, 1.5 * 9.81 / u)
        ang = 2.0 * np.pi * np.arange(u) / u
        ring = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), np.zeros(u)], -1)
        p.update(mass_kg=1.5 * scale, rotor_positions_m=np.broadcast_to(ring, (batch, u, 3)),
                 rotor_spin=np.broadcast_to(np.where(np.arange(u) % 2 == 0, -1.0, 1.0), (batch, u)),
                 torque_to_thrust_ratio_m=0.01 + 0.02 * rng.uniform(size=batch))
    if shared:
        p = {k: np.asarray(v)[0] for k, v in p.items()}
    cost = SimpleNamespace(
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(u) + 0.1 * np.ones((u, u)),
        desired_states=SimpleNamespace(
            pose=SimpleNamespace(quat=des_q, trans=np.zeros((n, 3))), vel=np.zeros((n, 6))
        ),
        desired_controls=np.tile(hover, (n, 1)),
    )
    traj = SimpleNamespace(
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        states=SimpleNamespace(
            pose=SimpleNamespace(quat=q, trans=0.4 * rng.normal(size=(batch, n, 3))),
            vel=0.2 * rng.normal(size=(batch, n, 6)),
        ),
        controls=hover + 0.5 * rng.normal(size=(batch, n, u)),
    )
    return (
        convert.params_from_numpy(SimpleNamespace(**p), device=device),
        convert.cost_from_numpy(cost, device=device),
        convert.trajectory_from_numpy(traj, device=device),
    )


def assert_lanes(got, ref, rtol=1e-8, atol=1e-7):
    """Status and iterations equal, cost within rtol, controls within atol."""
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=0)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=rtol, atol=0)
    torch.testing.assert_close(got[0].controls, ref[0].controls, rtol=0, atol=atol)


def bit_equal(got, ref):
    """Status, iterations, cost and every trajectory leaf identical."""
    t = lambda r: (r.trajectory, r.cost, r.iterations, r.status) if hasattr(r, "cost") else r[:4]
    (gt, *g), (rt, *r) = t(got), t(ref)
    leaves = lambda x: (x.controls, x.states.pose.quat, x.states.pose.trans, x.states.vel)
    return all(torch.equal(a, b) for a, b in zip(list(g) + list(leaves(gt)),
                                                  list(r) + list(leaves(rt))))


@pytest.mark.cuda
@pytest.mark.parametrize("suffix", FAMILY_SUFFIXES)
def test_cuda_family_kernels_match_plain(card, suffix):
    """Each family's backward.cu, rollout.cu, solve.cu and stream.cu
    instantiation against its plain version, float64 lane for lane, with
    per-scenario params; the launches run the family's C entries."""
    params, cost, traj = family_problem("cuda", suffix)
    before = {w: w.launches[suffix] for w in (kb.backward_pass_fused,
              kr.rollout_cost_fused, ks.solve_fused_whole, kst.solve_fused_streamed)}
    got = kb.backward_pass_fused(params, cost, traj, DT)
    ref = kb.backward_pass_reference(params, cost, traj, DT)
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-9)
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, rtol=1e-9, atol=0)
    alpha = torch.linspace(0.1, 1.0, B, dtype=torch.float64, device="cuda")
    g_t, g_c = kr.rollout_cost_fused(params, cost, traj, ref[0], ref[1], alpha, DT)
    r_t, r_c = kr.rollout_cost_reference(params, cost, traj, ref[0], ref[1], alpha, DT)
    for g, r in ((g_t.states.pose.quat, r_t.states.pose.quat),
                 (g_t.states.pose.trans, r_t.states.pose.trans), (g_t.states.vel, r_t.states.vel),
                 (g_t.controls, r_t.controls)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-10)
    torch.testing.assert_close(g_c, r_c, rtol=1e-10, atol=0)
    assert_lanes(ks.solve_fused_whole(params, cost, traj, DT, OPTIONS),
                 ks.solve_whole_reference(params, cost, traj, DT, OPTIONS))
    assert_lanes(kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS),
                 kst.solve_streamed_reference(params, cost, traj, DT, OPTIONS))
    assert all(w.launches[suffix] > n for w, n in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("suffix", FAMILY_SUFFIXES)
def test_cuda_family_routes_bit_equal(card, suffix):
    """stream.cu equals solve.cu bit for bit, and so does the per-pass route
    (solve_batch_fused), as for the quadrotor; also on a starved line search
    that fails lanes."""
    params, cost, traj = family_problem("cuda", suffix, n=40)
    starved = ILQROptions(LineSearchParams(0.5, 2.0, 1), ConvergenceCriteria(1e-12, 1e-12, 4))
    for opts in (OPTIONS, starved):
        whole = ks.solve_fused_whole(params, cost, traj, DT, opts)
        assert bit_equal(kst.solve_fused_streamed(params, cost, traj, DT, opts), whole)
        assert bit_equal(solve_batch_fused(params, cost, traj, DT, opts), whole)
    assert bool((whole[3] == 2).any())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(1, 1), (37, 2), (33, 40)])
@pytest.mark.parametrize("suffix", FAMILY_SUFFIXES)
def test_cuda_family_team_edges(card, suffix, batch, n):
    """solve.cu and stream.cu of each family at the team design's edges
    (one scenario, a ragged last block, one- and two-stage horizons), with
    shared params (B-stride 0), against the plain loop."""
    params, cost, traj = family_problem("cuda", suffix, batch=batch, n=n, shared=True)
    ref = ks.solve_whole_reference(params, cost, traj, DT, OPTIONS)
    assert_lanes(ks.solve_fused_whole(params, cost, traj, DT, OPTIONS), ref)
    assert_lanes(kst.solve_fused_streamed(params, cost, traj, DT, OPTIONS), ref)


@pytest.mark.cuda
def test_cuda_four_rotor_multirotor_is_the_quadrotor(card_problem):
    """A multirotor of the reference airframe runs the quadrotor's kernels
    and gives its results bit for bit on both exact routes."""
    params, cost, traj = card_problem
    arm = float(params.arm_length_m[0])
    ring = torch.tensor([[-arm, 0, 0], [0, -arm, 0], [arm, 0, 0], [0, arm, 0]],
                        dtype=torch.float64, device="cuda")
    spin = torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=torch.float64, device="cuda")
    multi = MultirotorParams(
        mass_kg=params.mass_kg, inertia=params.inertia,
        rotor_positions_m=ring.expand(B, 4, 3).contiguous(), rotor_spin=spin.expand(B, 4).contiguous(),
        torque_to_thrust_ratio_m=params.torque_to_thrust_ratio_m, g_mpss=params.g_mpss,
    )
    for route in (solve_batch_latency, solve_batch_fused):
        assert bit_equal(route(multi, cost, traj, DT, OPTIONS), route(params, cost, traj, DT, OPTIONS))


@pytest.mark.cuda
@pytest.mark.parametrize("request_", ["limits", "weights", "populate_debug", "rotors5", "fddp"])
def test_cuda_family_refusals(card, request_):
    """On the card a family without the instantiation raises, naming its
    ROADMAP item: never the plain loop or the quadrotor kernel."""
    suffix = "_rotor5" if request_ == "rotors5" else "_wrench"
    params, cost, traj = family_problem("cuda", suffix, batch=4, n=5)
    calls = {
        "limits": lambda: solve_batch_latency(params, cost, traj, DT, OPTIONS, limits=(0.0, 20.0)),
        "weights": lambda: solve_batch_fused(
            params, dataclasses.replace(cost, stage_weights=torch.ones(5, dtype=torch.float64,
                                                                       device="cuda")),
            traj, DT, OPTIONS),
        "populate_debug": lambda: solve_batch_latency(
            params, cost, traj, DT, dataclasses.replace(OPTIONS, populate_debug=True)),
        "rotors5": lambda: solve_batch_latency(params, cost, traj, DT, OPTIONS),
        "fddp": lambda: solve_batch_fddp(params, cost, traj, DT, FDDP_OPTIONS),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        calls[request_]()
