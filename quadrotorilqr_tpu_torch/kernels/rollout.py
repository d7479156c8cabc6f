"""Closed-loop rollout with the tracking cost: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/rollout.py:343`
(`rollout_cost_fused` over the Pallas `_rollout_kernel`):

    u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n),  x_{n+1} = f(x_n, u_n)

with a per-scenario alpha, and the new trajectory's cost summed in the same
sweep. `rollout_cost_fused` launches `csrc/rollout.cu` (one team of lanes
of a warp per scenario, `csrc/team.cuh`) for CUDA tensors and takes
`rollout_cost_reference` only for CPU tensors. The kernel reads the gains
as the backward kernel writes them, one (N, B, 52) k|K buffer: gains that
`backward_pass_fused` returned pass as that buffer, without a copy.

`per_pass_kernels` gives the batch solver's per-pass route its backward
pass and rollout, with the operands that do not change over a solve
prepared once.
"""

from __future__ import annotations

import torch

from ..models.quadrotor import CONTROL_DIM
from ..solver import ilqr
from . import _build
from . import backward as kb
from .backward import (
    _active_lanes,
    _check_cuda,
    _on,
    _problem_operands,
    _traj_from_lanes,
    _traj_lanes,
    backward_pass_fused,
    gains_buffer,
)


def rollout_cost_reference(params, cost, traj, ks, big_ks, alpha, dt_s):
    """Plain PyTorch version: `solver.ilqr.forward_sim` and the new
    trajectory's cost, summed stage by stage in the kernel's order."""
    return ilqr.rollout_cost(params, cost, traj, ks, big_ks, alpha, dt_s)


def rollout_cost_fused(params, cost, traj, ks, big_ks, alpha, dt_s, active=None):
    """Batched rollout: traj leaves (B, N, ...), ks (B, N, 4),
    Ks (B, N, 4, 12), alpha (B,). `active` (B,) bool marks the lanes whose
    outputs the caller reads (None: all).
    Returns (Trajectory with (B, N, ...) leaves, cost (B,))."""
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        return rollout_cost_reference(params, cost, traj, ks, big_ks, alpha, dt_s)
    _check_cuda(device)
    dtype = controls.dtype
    batch, n = controls.shape[0], controls.shape[1]
    if ks.shape != (batch, n, CONTROL_DIM) or big_ks.shape != (batch, n, CONTROL_DIM, 12):
        raise ValueError(f"gains of shapes {tuple(ks.shape)}, {tuple(big_ks.shape)}")
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    return _launch(ops, traj, gains_buffer(ks, big_ks, dtype, device), alpha, active)


def _launch(ops, traj, gains, alpha, active):
    """The kernel on CUDA tensors, with the Problem operands `ops` packed
    by `_problem_operands` and the gains as one (N, B, 52) buffer."""
    controls = traj.controls
    dtype, device = controls.dtype, controls.device
    batch, n = controls.shape[0], controls.shape[1]
    if alpha.shape != (batch,):
        raise ValueError(f"alpha must be ({batch},), got {tuple(alpha.shape)}")
    kw = dict(dtype=dtype, device=device)
    out = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    cost_out = torch.empty((batch,), **kw)
    ops = ops.extend(
        [
            *_traj_lanes(traj, dtype, device),
            gains,
            _on(alpha, dtype, device).contiguous(),
            _active_lanes(active, batch, device),
            *out,
            cost_out,
        ]
    )
    _build.launch("qilqr_rollout", dtype, ops.ptrs, ops.ints, ops.reals, device)
    rollout_cost_fused.launches += 1
    return _traj_from_lanes(traj.times, *out), cost_out


rollout_cost_fused.launches = 0


def per_pass_kernels(params, cost, traj, dt_s, quu_reg):
    """(backward(t, active), rollout(t, ks, Ks, alpha, active), traj) for
    `solver.ilqr.solve_loop` on the per-pass kernels.

    On a CUDA batch the Problem operands are packed once for every launch of
    the solve, and `traj` comes back with its leaves as views of the
    kernels' (N, d, B) layout, which every launch's outputs and the loop's
    per-lane selects keep: no launch re-lays the trajectory or re-packs the
    gains `backward` hands to `rollout`. On the CPU the two are the public
    wrappers (their plain versions) and `traj` is unchanged."""
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        return (
            lambda t, act: backward_pass_fused(params, cost, t, dt_s, quu_reg, act),
            lambda t, ks, big_ks, alpha, act: rollout_cost_fused(
                params, cost, t, ks, big_ks, alpha, dt_s, act
            ),
            traj,
        )
    _check_cuda(device)
    dtype = controls.dtype
    batch, n = controls.shape[0], controls.shape[1]
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)

    def backward(t, act):
        return kb._launch(ops, t, quu_reg, act)

    def rollout(t, ks, big_ks, alpha, act):
        return _launch(ops, t, gains_buffer(ks, big_ks, dtype, device), alpha, act)

    return backward, rollout, _traj_from_lanes(traj.times, *_traj_lanes(traj, dtype, device))
