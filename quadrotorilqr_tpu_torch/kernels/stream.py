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
too. The model family comes from the params type or `model=`, as for
`kernels/solve.py`. With control limits or stage weights it runs the
kernel's box and weights variants (JAX `use_box`, `use_weights`; the JAX
kernel's weights ride its desired stream, here they ride the operand ring
with the desired stage), the quadrotor's only, as on `solve.cu`; the plain
version is the same loop on `solver/constrained.py`'s pieces and the
weighted cost.
"""

from __future__ import annotations

import collections

import torch

from ..solver import ilqr
from ..solver.options import ILQROptions
from . import _build
from .backward import (
    _check_cuda,
    _problem_operands,
    _traj_from_lanes,
    _traj_lanes,
    count_launch,
)
from .solve import counted_plain_solve


def solve_streamed_reference(params, cost, traj, dt_s, options: ILQROptions, model=None,
                             limits=None):
    """Plain PyTorch version: `solver.ilqr.solve_loop` on the plain pieces
    with the streamed schedule (cost-only probes, one apply rollout at the
    last tried alpha; the box-QP stage and clamped rollouts with `limits`).
    Returns (Trajectory, cost, iterations int32, status
    int32, backward passes int32, probe sweeps int32, apply sweeps int32),
    each (B,) after the trajectory, the counts per lane as the kernel counts
    them."""
    r, counts = counted_plain_solve(params, cost, traj, dt_s, options, streamed=True,
                                    limits=limits, model=model)
    return (r.trajectory, r.cost, r.iterations, r.status, *counts)


def solve_fused_streamed(
    params, cost, traj, dt_s, options: ILQROptions, continuation=False, model=None, limits=None,
    return_probes=False,
):
    """Whole-solve iLQR for (B, N, ...) trajectories, any B and any N, lane
    for lane `solve_fused_whole`, with `limits=(lo, hi)` (scalars, (4,) or
    (B, 4) each) and the cost's stage weights on the kernel's box and
    weights variants. Returns (Trajectory, cost (B,), iterations
    (B,) int32, status (B,) int32), and with `return_probes` the backward
    passes, probe sweeps and apply sweeps each lane ran ((B,) int32 each)."""
    ilqr.check_supported(model)
    if continuation:
        raise NotImplementedError(ilqr.CONTINUATION_TODO)
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
        out = solve_streamed_reference(params, cost, traj, dt_s, options, model, limits)
    else:
        _check_cuda(device)
        out = _launch(params, cost, traj, dt_s, options, model, limits)
    return out if return_probes else out[:4]


def _launch(params, cost, traj, dt_s, options, model=None, limits=None):
    """The kernel; the bounds and the weights pick the box and weights
    instantiations (the quadrotor's only: `_problem_operands` refuses them
    with another family)."""
    dtype = traj.controls.dtype
    device = traj.controls.device
    batch, n = traj.controls.shape[0], traj.controls.shape[1]
    cc = options.convergence_criteria
    ls = options.line_search_params
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device, limits, model)
    u = ops.lm.u_dim
    kw = dict(dtype=dtype, device=device)
    live = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, u)]
    cost_out = torch.empty((batch,), **kw)
    iters, status, passes, probes, applies = (
        torch.empty((batch,), dtype=torch.int32, device=device) for _ in range(5)
    )
    # k | K of every stage, one contiguous row per scenario (csrc/team.cuh)
    gains = torch.empty((n, batch, ops.lm.gains_pitch()), **kw)
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device, u), *live, cost_out, iters, status, gains, passes,
         probes, applies],
        ints=[int(cc.max_iters), int(ls.max_iters)],
        reals=[options.quu_reg, cc.rtol, cc.atol, ls.step_update, ls.desired_reduction_frac],
    )
    _build.launch(ops.entry("stream"), dtype, ops.ptrs, ops.ints, ops.reals, device)
    count_launch(solve_fused_streamed, ops.key)
    return _traj_from_lanes(traj.times, *live), cost_out, iters, status, passes, probes, applies


solve_fused_streamed.launches = collections.Counter()
