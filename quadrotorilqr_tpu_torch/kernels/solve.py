"""The whole exact iLQR loop in one kernel: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/solve.py:618` (`solve_fused_whole`
over the Pallas `_solve_kernel`). `csrc/solve.cu` runs each scenario's whole
solve (backward pass, line search, convergence checks, status and
iterations) with one team of lanes of a warp per scenario (`csrc/team.cuh`),
keeping the live, candidate and gain trajectories in device memory, so any
horizon fits; the batch solver sends horizons past 256 stages to
`kernels/stream.py`, the candidate-free variant, as the JAX package routes
them. `solve_fused_whole` launches it for CUDA tensors and takes
`solve_whole_reference` only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.quadrotor import CONTROL_DIM
from ..solver import ilqr
from ..solver.options import ILQROptions
from . import _build
from .backward import (
    GAINS_WIDTH,
    _check_cuda,
    _problem_operands,
    _traj_from_lanes,
    _traj_lanes,
)


def solve_whole_reference(params, cost, traj, dt_s, options: ILQROptions):
    """Plain PyTorch version: the batched `solver.ilqr.solve`.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,) int32)."""
    result = ilqr.solve(params, cost, traj, dt_s, options)
    return result.trajectory, result.cost, result.iterations, result.status


def solve_fused_whole(
    params, cost, traj, dt_s, options: ILQROptions, continuation=False, model=None,
    limits=None, return_history=False, return_probes=False,
):
    """Whole-solve iLQR for (B, N, ...) trajectories, any B and any N.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,) int32)."""
    ilqr.check_supported(options, model)
    if continuation:
        raise NotImplementedError(ilqr.CONTINUATION_TODO)
    if limits is not None:
        raise NotImplementedError(ilqr.LIMITS_TODO)
    if return_history:
        raise NotImplementedError(ilqr.HISTORY_TODO)
    if return_probes:
        raise NotImplementedError(ilqr.PROBES_TODO)
    ls = options.line_search_params
    if int(ls.max_iters) < 1:
        # trip 0's forced full step is the first, force-accepted probe: with
        # no probes it would never run
        raise ValueError(
            "line_search_params.max_iters must be >= 1 on the whole-solve kernel; "
            "use solver.batched.solve_batch_fused (or solve_batch_latency, which "
            "routes there) for zero-probe runs"
        )
    device = traj.controls.device
    if device.type == "cpu":
        return solve_whole_reference(params, cost, traj, dt_s, options)
    _check_cuda(device)
    out = _launch(params, cost, traj, dt_s, options)
    solve_fused_whole.launches += 1
    return out


def _launch(params, cost, traj, dt_s, options):
    dtype = traj.controls.dtype
    device = traj.controls.device
    batch, n = traj.controls.shape[0], traj.controls.shape[1]
    cc = options.convergence_criteria
    ls = options.line_search_params
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    kw = dict(dtype=dtype, device=device)
    live = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    best = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    cost_out = torch.empty((batch,), **kw)
    iters = torch.empty((batch,), dtype=torch.int32, device=device)
    status = torch.empty((batch,), dtype=torch.int32, device=device)
    # k | K of every stage, one contiguous row per scenario (csrc/team.cuh)
    gains = torch.empty((n, batch, GAINS_WIDTH), **kw)
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device), *live, cost_out, iters, status, gains, *best],
        ints=[int(cc.max_iters), int(ls.max_iters)],
        reals=[options.quu_reg, cc.rtol, cc.atol, ls.step_update, ls.desired_reduction_frac],
    )
    _build.launch("qilqr_solve", dtype, ops.ptrs, ops.ints, ops.reals, device)
    return _traj_from_lanes(traj.times, *live), cost_out, iters, status


solve_fused_whole.launches = 0
