"""Closed-loop rollout with the tracking cost: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/rollout.py:343`
(`rollout_cost_fused` over the Pallas `_rollout_kernel`):

    u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n),  x_{n+1} = f(x_n, u_n)

with a per-scenario alpha, and the new trajectory's cost summed in the same
sweep. `rollout_cost_fused` launches `csrc/rollout.cu` (one team of lanes
of a warp per scenario, `csrc/team.cuh`) for CUDA tensors and takes
`rollout_cost_reference` only for CPU tensors. The kernel reads the gains
as the backward kernel writes them, one (N, B, P) k|K buffer: gains that
`backward_pass_fused` returned pass as that buffer, without a copy. The
model family (its dynamics step and control width) comes from the params
type or `model=`, as for the backward pass.

With control limits (`limits=(lo, hi)`) the kernel clamps each control
into [lo, hi] (JAX `use_box`); with stage weights on the cost it sums
w_n (dx'Q dx + du'R du) (JAX `use_weights`); the plain version then clamps
and weighs alike (`solver.ilqr.forward_sim` with limits, the weighted
`costs.quadratic.trajectory_cost`).

`per_pass_kernels` gives the batch solver's per-pass route its backward
pass and rollout, with the operands that do not change over a solve
prepared once.
"""

from __future__ import annotations

import collections

import torch

from ..solver import constrained, ilqr
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
    count_launch,
    gains_buffer,
)


def rollout_cost_reference(params, cost, traj, ks, big_ks, alpha, dt_s, limits=None,
                           model=None):
    """Plain PyTorch version: `solver.ilqr.forward_sim` (clamped with
    limits) on the params' model family (or `model`) and the new
    trajectory's cost, summed stage by stage in the kernel's order."""
    box = None
    if limits is not None:
        controls = traj.controls
        box = constrained.prep_limits(
            limits, controls.shape[0], controls.dtype, controls.device, controls.shape[-1]
        )
    return ilqr.rollout_cost(params, cost, traj, ks, big_ks, alpha, dt_s, box, model)


def rollout_cost_fused(params, cost, traj, ks, big_ks, alpha, dt_s, active=None, limits=None,
                       model=None):
    """Batched rollout: traj leaves (B, N, ...), ks (B, N, u),
    Ks (B, N, u, 12), alpha (B,). `active` (B,) bool marks the lanes whose
    outputs the caller reads (None: all). `limits=(lo, hi)` clamps the
    controls; stage weights come with the cost.
    Returns (Trajectory with (B, N, ...) leaves, cost (B,))."""
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        return rollout_cost_reference(params, cost, traj, ks, big_ks, alpha, dt_s, limits, model)
    _check_cuda(device)
    dtype = controls.dtype
    batch, n = controls.shape[0], controls.shape[1]
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device, limits, model)
    u = ops.lm.u_dim
    if ks.shape != (batch, n, u) or big_ks.shape != (batch, n, u, 12):
        raise ValueError(f"gains of shapes {tuple(ks.shape)}, {tuple(big_ks.shape)}")
    return _launch(ops, traj, gains_buffer(ks, big_ks, dtype, device, ops.lm.gains_pitch()),
                   alpha, active)


def _launch(ops, traj, gains, alpha, active):
    """The kernel on CUDA tensors, with the Problem operands `ops` packed
    by `_problem_operands` and the gains as one (N, B, P) buffer."""
    controls = traj.controls
    dtype, device = controls.dtype, controls.device
    batch, n = controls.shape[0], controls.shape[1]
    if alpha.shape != (batch,):
        raise ValueError(f"alpha must be ({batch},), got {tuple(alpha.shape)}")
    kw = dict(dtype=dtype, device=device)
    u = ops.lm.u_dim
    out = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, u)]
    cost_out = torch.empty((batch,), **kw)
    ops = ops.extend(
        [
            *_traj_lanes(traj, dtype, device, u),
            gains,
            _on(alpha, dtype, device).contiguous(),
            _active_lanes(active, batch, device),
            *out,
            cost_out,
        ]
    )
    _build.launch(ops.entry("rollout"), dtype, ops.ptrs, ops.ints, ops.reals, device)
    count_launch(rollout_cost_fused, ops.key)
    return _traj_from_lanes(traj.times, *out), cost_out


rollout_cost_fused.launches = collections.Counter()


def per_pass_kernels(params, cost, traj, dt_s, quu_reg, limits=None, model=None):
    """(backward(t, active[, penalty]), rollout(t, ks, Ks, alpha, active),
    traj) for `solver.ilqr.solve_loop` on the per-pass kernels of the
    params' model family (or `model`; the box and weights variants with
    limits and stage weights; with `penalty=(pcx, pcu, pcxx, pcuu, pcxu)`
    the backward pass's penalty variant, `solver.auglag`).

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
            lambda t, act, penalty=None: backward_pass_fused(
                params, cost, t, dt_s, quu_reg, act, limits, model, penalty
            ),
            lambda t, ks, big_ks, alpha, act: rollout_cost_fused(
                params, cost, t, ks, big_ks, alpha, dt_s, act, limits, model
            ),
            traj,
        )
    _check_cuda(device)
    dtype = controls.dtype
    batch, n = controls.shape[0], controls.shape[1]
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device, limits, model)
    pitch = ops.lm.gains_pitch()

    def backward(t, act, penalty=None):
        pen = None if penalty is None else kb.penalty_rows(penalty, dtype, device)
        return kb._launch(ops, t, quu_reg, act, pen)

    def rollout(t, ks, big_ks, alpha, act):
        return _launch(ops, t, gains_buffer(ks, big_ks, dtype, device, pitch), alpha, act)

    lanes = _traj_lanes(traj, dtype, device, ops.lm.u_dim)
    return backward, rollout, _traj_from_lanes(traj.times, *lanes)
