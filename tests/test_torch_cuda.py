"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Float64, B=300 (the last block of 32 threads is ragged) and N=12, with
per-scenario params so the B-strided operand groups are exercised.
Tolerances as chip_smoke.py: backward k, K atol 1e-9 and QuTk, kTQuuk rtol
1e-9; rollout trajectory atol 1e-10 and cost rtol 1e-10; whole solve status
and iterations equal, cost rtol 1e-8, controls atol 1e-7.

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
from quadrotorilqr_tpu_torch.kernels import rollout as kr
from quadrotorilqr_tpu_torch.kernels import solve as ks
from quadrotorilqr_tpu_torch.solver.options import (
    ConvergenceCriteria,
    ILQROptions,
    LineSearchParams,
)

DT = 0.02
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


@pytest.fixture(scope="module")
def card_problem():
    return problem("cuda")


@pytest.mark.parametrize("wrapper", ["backward", "rollout", "solve"])
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
