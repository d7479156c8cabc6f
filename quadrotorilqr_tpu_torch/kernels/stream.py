"""The whole exact iLQR loop without a candidate trajectory: CUDA kernel and
plain version.

Counterpart of `quadrotorilqr_tpu/kernels/stream.py:701`
(`solve_fused_streamed` over the Pallas `_stream_kernel`), the engine that
`solver.batched.solve_batch_latency` takes past 256 stages, as the JAX
package does. It computes what `kernels/solve.py` computes, lane for lane,
with the streamed schedule: the line search's probes sum costs only, and one
apply sweep re-rolls each active lane at the alpha it last tried and writes
the candidate into the live trajectory. `csrc/stream.cu` runs it with one
team of lanes of a warp per scenario (`csrc/team.cuh`);
`solve_fused_streamed` launches it for CUDA tensors and takes
`solve_streamed_reference` only for CPU tensors.

The JAX function's `chunk` sets the stages its TPU kernel streams through a
VMEM window at a time. Here every stage lives in device memory and the
kernel prefetches a fixed number of stages ahead into shared memory, so
there is no `chunk` parameter; `interpret` and `supertile` are TPU options
too.
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
from .solve import counted_plain_solve


def solve_streamed_reference(params, cost, traj, dt_s, options: ILQROptions):
    """Plain PyTorch version: `solver.ilqr.solve_loop` on the plain pieces
    with the streamed schedule (cost-only probes, one apply rollout at the
    last tried alpha). Returns (Trajectory, cost, iterations int32, status
    int32, backward passes int32, probe sweeps int32, apply sweeps int32),
    each (B,) after the trajectory, the counts per lane as the kernel counts
    them."""
    r, counts = counted_plain_solve(params, cost, traj, dt_s, options, streamed=True)
    return (r.trajectory, r.cost, r.iterations, r.status, *counts)


def solve_fused_streamed(
    params, cost, traj, dt_s, options: ILQROptions, continuation=False, model=None, limits=None,
    return_probes=False,
):
    """Whole-solve iLQR for (B, N, ...) trajectories, any B and any N, lane
    for lane `solve_fused_whole`. Returns (Trajectory, cost (B,), iterations
    (B,) int32, status (B,) int32), and with `return_probes` the backward
    passes, probe sweeps and apply sweeps each lane ran ((B,) int32 each)."""
    ilqr.check_supported(model)
    if continuation:
        raise NotImplementedError(ilqr.CONTINUATION_TODO)
    if limits is not None:
        raise NotImplementedError(ilqr.LIMITS_TODO)
    ls = options.line_search_params
    if int(ls.max_iters) < 1:
        # trip 0's forced full step is the first, force-accepted probe: with
        # no probes it would never run
        raise ValueError(
            "line_search_params.max_iters must be >= 1 on the streamed whole-solve kernel; "
            "use solver.batched.solve_batch_fused (or solve_batch_latency, which routes "
            "there) for zero-probe runs"
        )
    device = traj.controls.device
    if device.type == "cpu":
        out = solve_streamed_reference(params, cost, traj, dt_s, options)
    else:
        _check_cuda(device)
        out = _launch(params, cost, traj, dt_s, options)
    return out if return_probes else out[:4]


def _launch(params, cost, traj, dt_s, options):
    dtype = traj.controls.dtype
    device = traj.controls.device
    batch, n = traj.controls.shape[0], traj.controls.shape[1]
    cc = options.convergence_criteria
    ls = options.line_search_params
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    kw = dict(dtype=dtype, device=device)
    live = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    cost_out = torch.empty((batch,), **kw)
    iters, status, passes, probes, applies = (
        torch.empty((batch,), dtype=torch.int32, device=device) for _ in range(5)
    )
    # k | K of every stage, one contiguous row per scenario (csrc/team.cuh)
    gains = torch.empty((n, batch, GAINS_WIDTH), **kw)
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device), *live, cost_out, iters, status, gains, passes,
         probes, applies],
        ints=[int(cc.max_iters), int(ls.max_iters)],
        reals=[options.quu_reg, cc.rtol, cc.atol, ls.step_update, ls.desired_reduction_frac],
    )
    _build.launch("qilqr_stream", dtype, ops.ptrs, ops.ints, ops.reals, device)
    solve_fused_streamed.launches += 1
    return _traj_from_lanes(traj.times, *live), cost_out, iters, status, passes, probes, applies


solve_fused_streamed.launches = 0
