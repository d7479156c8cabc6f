"""Closed-loop rollout with the tracking cost: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/rollout.py:343`
(`rollout_cost_fused` over the Pallas `_rollout_kernel`):

    u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n),  x_{n+1} = f(x_n, u_n)

with a per-scenario alpha, and the new trajectory's cost summed in the same
sweep. `rollout_cost_fused` launches `csrc/rollout.cu` for CUDA tensors and
takes `rollout_cost_reference` only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.quadrotor import CONTROL_DIM
from ..solver import ilqr
from . import _build
from .backward import (
    _active_lanes,
    _check_cuda,
    _on,
    _problem_operands,
    _to_lanes,
    _traj_from_lanes,
    _traj_lanes,
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
    if alpha.shape != (batch,):
        raise ValueError(f"alpha must be ({batch},), got {tuple(alpha.shape)}")
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    kw = dict(dtype=dtype, device=device)
    out = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    cost_out = torch.empty((batch,), **kw)
    ops = ops.extend(
        [
            *_traj_lanes(traj, dtype, device),
            _to_lanes(ks, dtype, device),
            _to_lanes(big_ks, dtype, device),
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
